// g1_addsub: a + b or a - b on Jacobian points, one thread per row.
//
// Replaces the JAX programs g1_sub_tile (fabric_token_sdk_tpu/ops/
// stages.py:_g1_sub_tile = curve.add(a, curve.neg(b))) and, with
// negate_b = 0, g1_add_tile (ops/curve.py:add). The edge cases (either
// operand at infinity, P == Q, P == -Q) are the reference's selects.
//
// Layout: a, b (n, 3, 8) Montgomery Jacobian in [0, 2p); out (n, 3, 8)
// canonical Montgomery.
//
// What bounds it on the H100: 23 CIOS products a row against 288 bytes
// moved, so integer multiplies by a small margin; at the verify path's
// row counts the launch itself dominates. Nothing to stage: each thread
// reads its two points once and writes one.
#include "bn254_g1.cuh"

using namespace bn254;

namespace {

__device__ __forceinline__ void g1_addsub_row(const uint32_t* __restrict__ a,
                                              const uint32_t* __restrict__ b,
                                              uint32_t* __restrict__ out, int row,
                                              int negate_b) {
  G1 p = g1_load(a + (size_t)row * G1_WORDS);
  G1 q = g1_load(b + (size_t)row * G1_WORDS);
  if (negate_b) q = g1_neg(q);  // uniform across the launch
  g1_store_canon(out + (size_t)row * G1_WORDS, g1_add(p, q));
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_g1_addsub(const uint32_t* a, const uint32_t* b, uint32_t* out, int n,
                               int negate_b) {
  for (int row = 0; row < n; ++row) g1_addsub_row(a, b, out, row, negate_b);
}
#else
#include <cuda_runtime.h>

namespace {
constexpr int THREADS = 128;

__global__ void g1_addsub_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, int n, int negate_b) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) g1_addsub_row(a, b, out, row, negate_b);
}
}  // namespace

extern "C" int fts_g1_addsub(const void* a, const void* b, void* out, int n,
                             int negate_b, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + THREADS - 1) / THREADS;
  g1_addsub_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, negate_b);
  return (int)cudaGetLastError();
}
#endif
