// g2_add: a + b on G2 Jacobian points, one thread per row.
//
// Replaces the JAX program g2_add_tile (fabric_token_sdk_tpu/ops/
// curve2.py:add): add-2007-bl over Fp2 with the reference's selects for
// either operand at infinity, P == Q and P == -Q.
//
// Layout: a, b (n, 3, 2, 8) Montgomery Jacobian in [0, 2p); out
// (n, 3, 2, 8) canonical Montgomery.
//
// What bounds it on the H100: 43 base products a row (11 Fp2 products
// and 5 squarings) against 576 bytes moved, so integer multiplies by a
// small margin; at the verify path's row counts the launch itself
// dominates. Each thread reads its two points once and writes one.
#include "bn254_g2.cuh"

using namespace bn254;

namespace {

__device__ __forceinline__ void g2_add_row(const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ b,
                                           uint32_t* __restrict__ out, int row) {
  G2 p = g2_load(a + (size_t)row * G2_WORDS);
  G2 q = g2_load(b + (size_t)row * G2_WORDS);
  g2_store_canon(out + (size_t)row * G2_WORDS, g2_add(p, q));
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_g2_add(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  for (int row = 0; row < n; ++row) g2_add_row(a, b, out, row);
}
#else
namespace {
constexpr int THREADS = 32;

__global__ void g2_add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                              uint32_t* __restrict__ out, int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) g2_add_row(a, b, out, row);
}
}  // namespace

extern "C" int fts_g2_add(const void* a, const void* b, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = ensure_stack();
  if (e != cudaSuccess) return (int)e;
  int blocks = (n + THREADS - 1) / THREADS;
  g2_add_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
