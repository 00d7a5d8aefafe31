// g1_mul: variable-base scalar multiplication [k]P, one thread per row.
//
// Replaces the JAX program g1_mul_tile (fabric_token_sdk_tpu/ops/
// curve.py:scalar_mul): 256 MSB-first steps over the canonical
// (non-Montgomery) scalar, each a doubling, an addition of P, and a
// select of the sum where the bit is set. The addition is computed on
// every step and selected, as in the reference, so the instruction
// stream and memory traffic do not depend on the scalar: the prove
// plane can reuse this kernel with secret scalars.
//
// Layout: points (n, 3, 8) Montgomery Jacobian, coordinates in [0, 2p);
// scalars (n, 8) canonical words; out (n, 3, 8) canonical Montgomery.
//
// What bounds it on the H100: integer multiplies, 256 x (7 + 23) CIOS
// products a row, with 120 bytes read and 96 written. The accumulator
// and P stay in registers for the whole ladder. One thread per row
// leaves most of the card idle at the verify path's row counts (known
// gap; a later change can split the ladder into windows across threads).
#include "bn254_g1.cuh"

using namespace bn254;

namespace {

__device__ __forceinline__ void g1_mul_row(const uint32_t* __restrict__ points,
                                           const uint32_t* __restrict__ scalars,
                                           uint32_t* __restrict__ out, int row) {
  const G1 p = g1_load(points + (size_t)row * G1_WORDS);
  const uint32_t* k = scalars + (size_t)row * NW;
  G1 acc = g1_infinity();
#pragma unroll 1
  for (int wi = NW - 1; wi >= 0; --wi) {
    uint32_t word = __ldg(k + wi);
#pragma unroll 1
    for (int bi = 31; bi >= 0; --bi) {
      acc = g1_double(acc);
      G1 sum = g1_add(acc, p);
      acc = g1_select(0u - ((word >> bi) & 1u), sum, acc);
    }
  }
  g1_store_canon(out + (size_t)row * G1_WORDS, acc);
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_g1_mul(const uint32_t* points, const uint32_t* scalars, uint32_t* out,
                            int n) {
  for (int row = 0; row < n; ++row) g1_mul_row(points, scalars, out, row);
}
#else
#include <cuda_runtime.h>

namespace {
constexpr int THREADS = 128;

__global__ void g1_mul_kernel(const uint32_t* __restrict__ points,
                              const uint32_t* __restrict__ scalars,
                              uint32_t* __restrict__ out, int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) g1_mul_row(points, scalars, out, row);
}
}  // namespace

extern "C" int fts_g1_mul(const void* points, const void* scalars, void* out,
                          int n, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + THREADS - 1) / THREADS;
  g1_mul_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)points, (const uint32_t*)scalars, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
