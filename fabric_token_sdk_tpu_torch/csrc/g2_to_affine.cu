// g2_to_affine: Jacobian -> affine on G2 (the twist), one row a lane,
// over the constant-time inversion of bn254_inv.cuh.
//
// Replaces the JAX program g2_to_affine_tile (fabric_token_sdk_tpu/ops/
// stages.py:_g2_to_affine_tile = curve2.to_affine_device): the Fp2
// inverse of Z = c0 + c1 i by its norm, n = c0^2 + c1^2 (i^2 = -1), one
// Fp inversion and Z^-1 = (c0 n^-1, -c1 n^-1); then x = X / Z^2,
// y = Y / Z^3. Infinity (Z = 0, so n = 0) comes back as (0, 0). The
// canonical affine coordinates are unique, so the output equals the
// plain version (a Fermat inversion) bit for bit. On the prove path Z
// derives from secrets: nothing here branches on it or addresses by it.
//
// Layout: points (n, 3, 2, 8) Montgomery Jacobian in [0, 2p); out
// (n, 2, 2, 8) canonical Montgomery.
//
// What bounds it on the H100: the function needs one inversion for all
// rows (the batch trick over Fp2) and 20 base products a row against
// 320 bytes moved; at the paths' rows (64 to 3,968, below a wave) that
// is below a launch, so the time is one row's chain, which the
// Bernstein-Yang inversion keeps short. Everything is inlined: no call,
// no stack.
#include "bn254_inv.cuh"
#include "bn254_tower.cuh"

using namespace bn254;

namespace {

__device__ __forceinline__ void g2_to_affine_row(const uint32_t* __restrict__ points,
                                                 uint32_t* __restrict__ out, int row) {
  const uint32_t* src = points + (size_t)row * 3 * 2 * NW;
  const Fp2 z = fp2_load(src + 4 * NW);
  const Fp ni = inv::fp_inv_safegcd(fp_add(fp_sqr(z.c0), fp_sqr(z.c1)));
  const Fp2 zi{fp_mul(z.c0, ni), fp_neg(fp_mul(z.c1, ni))};
  const Fp2 zi2 = fp2_sqr(zi);
  uint32_t* dst = out + (size_t)row * 4 * NW;
  fp2_store_canon(dst, fp2_mul(fp2_load(src), zi2));
  fp2_store_canon(dst + 2 * NW, fp2_mul(fp2_mul(fp2_load(src + 2 * NW), zi), zi2));
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_g2_to_affine(const uint32_t* points, uint32_t* out, int n) {
  for (int row = 0; row < n; ++row) g2_to_affine_row(points, out, row);
}
#else
namespace {
constexpr int THREADS = 32;  // one warp a block

__global__ void __launch_bounds__(THREADS) g2_to_affine_kernel(
    const uint32_t* __restrict__ points, uint32_t* __restrict__ out, int n) {
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row < n) g2_to_affine_row(points, out, row);
}
}  // namespace

// the blocks of the kernel an SM holds at once, as the card counts them
extern "C" int fts_g2_to_affine_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, g2_to_affine_kernel, THREADS,
                                                               0);
}

extern "C" int fts_g2_to_affine(const void* points, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  g2_to_affine_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)points, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
