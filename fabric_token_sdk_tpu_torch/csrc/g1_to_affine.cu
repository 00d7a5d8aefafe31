// g1_to_affine: Jacobian -> affine on G1, one thread per row.
//
// Replaces the JAX program g1_to_affine_tile (fabric_token_sdk_tpu/ops/
// stages.py:_g1_to_affine_tile): one Fermat inversion of Z, then
// x = X / Z^2, y = Y / Z^3. A point at infinity (Z = 0) inverts to 0 and
// comes back as (0, 0), as in the reference: the caller masks.
//
// Layout: points (n, 3, 8) Montgomery Jacobian in [0, 2p); out (n, 2, 8)
// canonical Montgomery.
//
// What bounds it on the H100: the function needs one inversion for all
// rows (Montgomery's batch trick) and 7 products a row, so 160 bytes
// moved a row bound it. This design spends a whole Fermat inversion a
// row (~290 dependent products), so it is bound by the latency of that
// chain; blocks of one warp spread the rows of a verify over as many
// SMs as there are warps of rows.
#include "bn254_g1.cuh"

using namespace bn254;

namespace {

__device__ __forceinline__ void g1_to_affine_row(const uint32_t* __restrict__ points,
                                                 uint32_t* __restrict__ out, int row) {
  const G1 p = g1_load(points + (size_t)row * G1_WORDS);
  Fp zi = fp_inv(p.z);
  Fp zi2 = fp_sqr(zi);
  uint32_t* dst = out + (size_t)row * 2 * NW;
  fp_store(dst, fp_canon(fp_mul(p.x, zi2)));
  fp_store(dst + NW, fp_canon(fp_mul(fp_mul(p.y, zi2), zi)));
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_g1_to_affine(const uint32_t* points, uint32_t* out, int n) {
  for (int row = 0; row < n; ++row) g1_to_affine_row(points, out, row);
}
#else
#include <cuda_runtime.h>

namespace {
constexpr int THREADS = 32;

__global__ void g1_to_affine_kernel(const uint32_t* __restrict__ points,
                                    uint32_t* __restrict__ out, int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) g1_to_affine_row(points, out, row);
}
}  // namespace

extern "C" int fts_g1_to_affine(const void* points, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + THREADS - 1) / THREADS;
  g1_to_affine_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)points, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
