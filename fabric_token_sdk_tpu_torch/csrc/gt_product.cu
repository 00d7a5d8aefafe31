// gt_product: per-row product of K Fp12 (Miller) values, one thread per
// row.
//
// Replaces the JAX programs gt_product_k4_tile and gt_product_k2_tile
// (fabric_token_sdk_tpu/ops/pairing.py:_product_rows): the K legs of a
// pairing-product row multiplied together before the shared final
// exponentiation. The product is a unique field element, so the order
// (here left to right, K - 1 products) does not change it. The loop runs
// over the public K only: on the prove path (K = 2) the values derive
// from secrets, and no branch or address depends on them.
//
// Layout: f (n, k, 6, 2, 8) Montgomery Fp12 in [0, 2p); out (n, 6, 2, 8)
// canonical Montgomery.
//
// What bounds it on the H100: integer multiplies, K - 1 Fp12 products of
// 54 base products a row, against 384 (K + 1) bytes moved; one warp a
// block.
#include "bn254_tower.cuh"

using namespace bn254;

namespace {

constexpr int FP12_WORDS = 12 * NW;

__device__ __forceinline__ void gt_product_row(const uint32_t* __restrict__ f,
                                               uint32_t* __restrict__ out, int row, int k) {
  const uint32_t* src = f + (size_t)row * k * FP12_WORDS;
  Fp12 acc = fp12_load(src);
#pragma unroll 1
  for (int j = 1; j < k; ++j) acc = fp12_mul(acc, fp12_load(src + (size_t)j * FP12_WORDS));
  fp12_store_canon(out + (size_t)row * FP12_WORDS, acc);
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_gt_product(const uint32_t* f, uint32_t* out, int n, int k) {
  for (int row = 0; row < n; ++row) gt_product_row(f, out, row, k);
}
#else
namespace {
constexpr int THREADS = 32;

__global__ void gt_product_kernel(const uint32_t* __restrict__ f, uint32_t* __restrict__ out,
                                  int n, int k) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) gt_product_row(f, out, row, k);
}
}  // namespace

extern "C" int fts_gt_product(const void* f, void* out, int n, int k, void* stream) {
  if (n <= 0) return 0;
  if (k <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = ensure_stack();
  if (e != cudaSuccess) return (int)e;
  int blocks = (n + THREADS - 1) / THREADS;
  gt_product_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)f, (uint32_t*)out, n, k);
  return (int)cudaGetLastError();
}
#endif
