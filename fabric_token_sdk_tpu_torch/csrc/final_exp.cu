// final_exp: f^((p^12 - 1) / r) on GT rows, each row spread over G
// lanes of a warp (the cooperative tower of bn254_gt_coop.cuh), its Fp12
// values in shared memory.
//
// Replaces the JAX program final_exp_tile (fabric_token_sdk_tpu/ops/
// pairing.py:final_exp). The exponentiation and its schedule (FE_PROGRAM,
// generated by ops/pairing.py:final_exp_program()) are the row function
// of bn254_gt_rows.cuh, shared with pairing_fused.cu. The result is
// unique, so it equals the reference's.
//
// Layout: f (n, 6, 2, 8) Montgomery Fp12 in [0, 2p); out (n, 6, 2, 8)
// canonical Montgomery.
//
// What bounds it on the H100: integer multiplies, ~9,600 CIOS products a
// row (102 Fp12 products, 198 cyclotomic squarings, the inverse); the
// bound counts ~8,800. A row's ops are a long dependent chain, so the
// time is the chain's latency until the card fills. The design: G = 8
// lanes a row, each with whole Fp elements, share the independent Fp2
// products of each op (18 in a product, 9 in a cyclotomic squaring) and
// its output coefficients, the row's ten Fp12 values and its product
// cells (5 KB) in shared memory instead of the old 9.8 KB stack, a
// lane's live registers a few Fp2. G is from the sweep of chip_probe.py
// over G in {1, 2, 4, 8, 16, 32}; spreading each field element over 2, 4
// or 8 lanes instead lost 4-12x to lanes of separate products, whose
// field needs no shuffle.
#include "bn254_gt_rows.cuh"

using namespace bn254;

#ifndef FTS_FINAL_EXP_G
#define FTS_FINAL_EXP_G 8  // lanes a row (chip_probe.py overrides it for its sweep)
#endif

namespace {

constexpr int G = FTS_FINAL_EXP_G;
static_assert(32 % G == 0, "a row's lanes tile a warp");
constexpr int THREADS = 32;  // one warp a block
constexpr int ROWS_PER_BLOCK = THREADS / G;
// a block's cells: the dynamic shared memory of a launch
constexpr size_t SMEM = (size_t)ROWS_PER_BLOCK * gtc::ROW_WORDS * 4;

}  // namespace

// the kernel's lanes a row and its dynamic shared memory a block, as
// this library was built
extern "C" int fts_final_exp_config(int* g, int* smem) {
  *g = G;
  *smem = (int)SMEM;
  return 0;
}

#ifdef FTS_HOST_CHECK
namespace {
// The rows by G emulated lanes (host_check.h), a row's cells in a host
// buffer.
template <int NG>
void host_rows(const uint32_t* f, uint32_t* out, int n) {
  std::vector<uint32_t> cells(gtc::ROW_WORDS);
  for (int row = 0; row < n; ++row) {
    auto body = [&](int lane) {
      const gtc::Row<NG> r((uint32_t)lane, cells.data(), 1);
      gtc::final_exp_row<NG>(r, f, out, row, true);
    };
    coop::host_group(NG, body);
  }
}
}  // namespace

// the kernel's own configuration
extern "C" void host_final_exp(const uint32_t* f, uint32_t* out, int n) {
  host_rows<G>(f, out, n);
}

// the same rows by g lanes (1, 2, 4, 8, 16 or 32); returns -1 for any
// other
extern "C" int host_final_exp_lanes(const uint32_t* f, uint32_t* out, int n, int g) {
  switch (g) {
    case 1: return host_rows<1>(f, out, n), 0;
    case 2: return host_rows<2>(f, out, n), 0;
    case 4: return host_rows<4>(f, out, n), 0;
    case 8: return host_rows<8>(f, out, n), 0;
    case 16: return host_rows<16>(f, out, n), 0;
    case 32: return host_rows<32>(f, out, n), 0;
    default: return -1;
  }
}
#else
#include <cuda_runtime.h>

namespace {
__global__ void __launch_bounds__(THREADS) final_exp_kernel(const uint32_t* __restrict__ f,
                                                            uint32_t* __restrict__ out, int n) {
  extern __shared__ uint32_t cells[];
  const uint32_t slot = threadIdx.x / G;  // the row's place in the block
  const gtc::Row<G> r(threadIdx.x % G, cells + slot, ROWS_PER_BLOCK);
  const int row = (int)(blockIdx.x * ROWS_PER_BLOCK + slot);
  const bool live = row < n;  // a clamped row still takes part in every barrier
  gtc::final_exp_row<G>(r, f, out, live ? row : n - 1, live);
}
}  // namespace

extern "C" int fts_final_exp(const void* f, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  if (SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(final_exp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  final_exp_kernel<<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const uint32_t*)f, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
