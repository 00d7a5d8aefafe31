// g2_mul: variable-base scalar multiplication [k]Q on G2, one thread
// per row.
//
// Replaces the JAX program g2_mul_tile (fabric_token_sdk_tpu/ops/
// curve2.py:scalar_mul): 256 MSB-first steps over the canonical scalar,
// each a doubling, an addition of Q and a select of the sum where the
// bit is set: the same fixed add-and-select ladder as g1_mul.cu, over
// Fp2. The scalars of the verify path are public proof responses, those
// of the prove path (the membership randomness rho_v, rho_h) secret: the
// ladder's instruction stream and memory traffic depend on neither.
//
// Layout: points (n, 3, 2, 8) Montgomery Jacobian in [0, 2p); scalars
// (n, 8) canonical words; out (n, 3, 2, 8) canonical Montgomery.
//
// What bounds it on the H100: integer multiplies. The function needs
// [k]Q by 4-bit fixed windows, ~64 doublings (16 base products) and
// ~60 additions (43) a row; this ladder does 256 x (16 + 59 + 16). The
// accumulator lives in registers between the two calls a step (double,
// add), whose operands pass through the stack; one warp a block.
#include "bn254_g2.cuh"

using namespace bn254;

namespace {

__device__ __forceinline__ void g2_mul_row(const uint32_t* __restrict__ points,
                                           const uint32_t* __restrict__ scalars,
                                           uint32_t* __restrict__ out, int row) {
  const G2 p = g2_load(points + (size_t)row * G2_WORDS);
  const uint32_t* k = scalars + (size_t)row * NW;
  G2 acc = g2_infinity();
#pragma unroll 1
  for (int wi = NW - 1; wi >= 0; --wi) {
    uint32_t word = __ldg(k + wi);
#pragma unroll 1
    for (int bi = 31; bi >= 0; --bi) {
      acc = g2_double(acc);
      G2 sum = g2_add(acc, p);
      acc = g2_select(0u - ((word >> bi) & 1u), sum, acc);
    }
  }
  g2_store_canon(out + (size_t)row * G2_WORDS, acc);
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_g2_mul(const uint32_t* points, const uint32_t* scalars, uint32_t* out,
                            int n) {
  for (int row = 0; row < n; ++row) g2_mul_row(points, scalars, out, row);
}
#else
namespace {
constexpr int THREADS = 32;

__global__ void g2_mul_kernel(const uint32_t* __restrict__ points,
                              const uint32_t* __restrict__ scalars,
                              uint32_t* __restrict__ out, int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) g2_mul_row(points, scalars, out, row);
}
}  // namespace

extern "C" int fts_g2_mul(const void* points, const void* scalars, void* out, int n,
                          void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = ensure_stack();
  if (e != cudaSuccess) return (int)e;
  int blocks = (n + THREADS - 1) / THREADS;
  g2_mul_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)points, (const uint32_t*)scalars, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
