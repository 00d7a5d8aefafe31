// final_exp: f^((p^12 - 1) / r) on GT rows, one thread per row.
//
// Replaces the JAX program final_exp_tile (fabric_token_sdk_tpu/ops/
// pairing.py:final_exp). The exponentiation is `final_exp` of
// bn254_pairing.cuh: the easy part, then the hard part by the
// reference's balanced decomposition (three ladders over the bits of u,
// one Straus pass, a Frobenius combine), real loops over public
// constants to keep the build short. The result is unique, so it equals
// the reference's.
//
// Layout: f (n, 6, 2, 8) Montgomery Fp12 in [0, 2p); out (n, 6, 2, 8)
// canonical Montgomery.
//
// What bounds it on the H100: integer multiplies, ~11,000 base products
// a row for the function (cyclotomic squarings in the u-ladders). The
// four accumulators and four bases are 768 words, so they live on the
// stack (local memory, cached in L1); one warp a block.
#include "bn254_pairing.cuh"

using namespace bn254;

#ifdef FTS_HOST_CHECK
extern "C" void host_final_exp(const uint32_t* f, uint32_t* out, int n) {
  for (int row = 0; row < n; ++row) final_exp_row(f, out, row);
}
#else
namespace {
constexpr int THREADS = 32;

__global__ void final_exp_kernel(const uint32_t* __restrict__ f, uint32_t* __restrict__ out,
                                 int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) final_exp_row(f, out, row);
}
}  // namespace

extern "C" int fts_final_exp(const void* f, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = ensure_stack();
  if (e != cudaSuccess) return (int)e;
  int blocks = (n + THREADS - 1) / THREADS;
  final_exp_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)f, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
