// g2_to_affine: Jacobian -> affine on G2 (the twist), one thread per row.
//
// Replaces the JAX program g2_to_affine_tile (fabric_token_sdk_tpu/ops/
// stages.py:_g2_to_affine_tile = curve2.to_affine_device): one Fp2
// inversion of Z (a norm, one Fermat inversion in Fp, two products),
// then x = X / Z^2, y = Y / Z^3. Infinity (Z = 0) comes back as (0, 0).
// The Fermat chain's exponent p - 2 is public and its selects are masks,
// so nothing branches on the (on the prove path, secret-derived) point.
//
// Layout: points (n, 3, 2, 8) Montgomery Jacobian in [0, 2p); out
// (n, 2, 2, 8) canonical Montgomery.
//
// What bounds it on the H100: the function needs one inversion for all
// rows (Montgomery's batch trick over Fp2) and 20 base products a row
// against 320 bytes moved, so bytes bound it. This design inverts a
// row at a time (~290 dependent products), latency-bound like
// g1_to_affine; one warp a block.
#include "bn254_g2.cuh"

using namespace bn254;

namespace {

__device__ __forceinline__ void g2_to_affine_row(const uint32_t* __restrict__ points,
                                                 uint32_t* __restrict__ out, int row) {
  const G2 p = g2_load(points + (size_t)row * G2_WORDS);
  Fp2 zi = fp2_inv(p.z);
  Fp2 zi2 = fp2_sqr(zi);
  uint32_t* dst = out + (size_t)row * 4 * NW;
  fp2_store_canon(dst, fp2_mul(p.x, zi2));
  fp2_store_canon(dst + 2 * NW, fp2_mul(fp2_mul(p.y, zi), zi2));
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_g2_to_affine(const uint32_t* points, uint32_t* out, int n) {
  for (int row = 0; row < n; ++row) g2_to_affine_row(points, out, row);
}
#else
namespace {
constexpr int THREADS = 32;

__global__ void g2_to_affine_kernel(const uint32_t* __restrict__ points,
                                    uint32_t* __restrict__ out, int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) g2_to_affine_row(points, out, row);
}
}  // namespace

extern "C" int fts_g2_to_affine(const void* points, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = ensure_stack();
  if (e != cudaSuccess) return (int)e;
  int blocks = (n + THREADS - 1) / THREADS;
  g2_to_affine_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)points, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
