// g1_to_affine: Jacobian -> affine on G1, one row a lane, over the
// constant-time inversion of bn254_inv.cuh.
//
// Replaces the JAX program g1_to_affine_tile (fabric_token_sdk_tpu/ops/
// stages.py:_g1_to_affine_tile): one inversion of Z, then x = X / Z^2,
// y = Y / Z^3. A point at infinity (Z = 0 or p) inverts to 0 and comes
// back as (0, 0), as in the reference: the caller masks. The canonical
// affine coordinates are unique, so the output equals the plain version
// (a Fermat inversion) bit for bit whatever inversion runs here.
//
// Layout: points (n, 3, 8) Montgomery Jacobian in [0, 2p); out (n, 2, 8)
// canonical Montgomery.
//
// What bounds it on the H100: the function needs one inversion for all
// rows (Montgomery's batch trick) and 7 products a row, 160 bytes moved
// a row; at the paths' rows (744 and 11,904, below a wave of one-warp
// blocks) that is below the cost of a launch, so the time is one
// row's chain. The design makes that chain short: the inversion is
// Bernstein-Yang's (600 divsteps of 32-bit integer work, no product
// chain) where the old one was 508 dependent CIOS products. A Fermat
// inversion over a 5-bit window and the batch trick over a warp's lanes
// were slower at every row count measured (PERF.md, B7).
#include "bn254_inv.cuh"

using namespace bn254;

namespace {

__device__ __forceinline__ void g1_to_affine_row(const uint32_t* __restrict__ points,
                                                 uint32_t* __restrict__ out, int row) {
  const uint32_t* src = points + (size_t)row * 3 * NW;
  const Fp zi = inv::fp_inv_safegcd(fp_load(src + 2 * NW));
  const Fp zi2 = fp_sqr(zi);
  uint32_t* dst = out + (size_t)row * 2 * NW;
  fp_store(dst, fp_canon(fp_mul(fp_load(src), zi2)));
  fp_store(dst + NW, fp_canon(fp_mul(fp_mul(fp_load(src + NW), zi2), zi)));
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_g1_to_affine(const uint32_t* points, uint32_t* out, int n) {
  for (int row = 0; row < n; ++row) g1_to_affine_row(points, out, row);
}

// The inversion alone: out = canonical a^-1 (Montgomery: a = zR ->
// z^-1 R) for each 8-word a in [0, 2p).
extern "C" void host_fp_inv(const uint32_t* a, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i)
    fp_store(out + (size_t)i * NW, fp_canon(inv::fp_inv_safegcd(fp_load(a + (size_t)i * NW))));
}
#else
#include <cuda_runtime.h>

namespace {
constexpr int THREADS = 32;  // one warp a block

__global__ void __launch_bounds__(THREADS) g1_to_affine_kernel(
    const uint32_t* __restrict__ points, uint32_t* __restrict__ out, int n) {
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row < n) g1_to_affine_row(points, out, row);
}
}  // namespace

// the blocks of the kernel an SM holds at once, as the card counts them
extern "C" int fts_g1_to_affine_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, g1_to_affine_kernel, THREADS,
                                                               0);
}

extern "C" int fts_g1_to_affine(const void* points, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  g1_to_affine_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)points, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
