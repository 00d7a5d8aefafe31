// miller: the optimal-ate Miller loop over 6u+2, one thread per leg.
//
// Replaces the JAX program miller_tile (fabric_token_sdk_tpu/ops/
// pairing.py:miller_loop). The loop is `miller_loop` of
// bn254_pairing.cuh (the reference's denominator-free steps, so f equals
// the reference's Miller value as a canonical Fp12); the add step runs
// only on the set bits of the public 6u+2, and no branch and no address
// depends on the legs, which derive from secrets on the prove path
// (R' = R^r, t = PK1^rho_v + PK2^rho_h). P is taken as given: infinity
// is the caller's mask, and a (0, 0) leg runs like any other.
//
// Layout: P (n, 2, 8) and Q (n, 2, 2, 8) Montgomery affine in [0, 2p);
// out (n, 6, 2, 8) canonical Montgomery Fp12.
//
// What bounds it on the H100: integer multiplies, ~8,300 base products a
// leg for the function (64 doubling steps with line and sparse product,
// 36 add steps, f^2 on each bit). State: f is 96 words, T 48, Q 32, P 16
// (192 words, most of the 255-register budget), so the Fp12 ops run as
// calls with their operands on the stack; one warp a block.
#include "bn254_pairing.cuh"

using namespace bn254;

#ifdef FTS_HOST_CHECK
extern "C" void host_miller(const uint32_t* P, const uint32_t* Q, uint32_t* out, int n) {
  for (int row = 0; row < n; ++row) miller_row(P, Q, out, row);
}
#else
namespace {
constexpr int THREADS = 32;

__global__ void miller_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                              uint32_t* __restrict__ out, int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) miller_row(P, Q, out, row);
}
}  // namespace

extern "C" int fts_miller(const void* P, const void* Q, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = ensure_stack();
  if (e != cudaSuccess) return (int)e;
  int blocks = (n + THREADS - 1) / THREADS;
  miller_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)P, (const uint32_t*)Q, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
