// gt_product: per-row product of K Fp12 (Miller) values, each row spread
// over G lanes of a warp on the cooperative tower of bn254_gt_coop.cuh.
//
// Replaces the JAX programs gt_product_k4_tile and gt_product_k2_tile
// (fabric_token_sdk_tpu/ops/pairing.py:_product_rows): the K legs of a
// pairing-product row multiplied together before the shared final
// exponentiation. The product is a unique field element, so the order
// (here left to right, K - 1 products) does not change it: it equals
// the plain version's pairwise tree. The loop runs over the public K
// only: on the prove path (K = 2) the values derive from secrets, and
// no branch or address depends on them.
//
// Layout: f (n, k, 6, 2, 8) Montgomery Fp12 in [0, 2p); out (n, 6, 2, 8)
// canonical Montgomery.
//
// What bounds it on the H100: integer multiplies, K - 1 Fp12 products of
// 54 base products a row, against 384 (K + 1) bytes moved. The design
// (the row function of bn254_gt_rows.cuh, shared with pairing_fused.cu):
// a row's accumulator and the leg it takes in are two Fp12 slots in
// shared memory (with the product cells 30 cells, 1,920 B a row), each
// product gtc::op_mul's 18 Fp2 products and 6 output coefficients split
// over the row's G lanes; no stack. G is from the sweep of
// chip_probe.py --redesign --sweep gtp.
#include "bn254_gt_rows.cuh"

using namespace bn254;

#ifndef FTS_GT_PRODUCT_G
#define FTS_GT_PRODUCT_G 8  // lanes a row (chip_probe.py overrides it for its sweep)
#endif

namespace {

constexpr int G = FTS_GT_PRODUCT_G;
static_assert(32 % G == 0, "a row's lanes tile a warp");
constexpr int THREADS = 32;  // one warp a block
constexpr int ROWS_PER_BLOCK = THREADS / G;
// the accumulator (slot 0) and a leg (slot 1), then the product cells
constexpr int NC = 2 * 6 + gtc::NPROD;
template <int NG>
using Row = gtc::Row<NG, NC>;
// a block's cells: the dynamic shared memory of a launch
constexpr size_t SMEM = (size_t)ROWS_PER_BLOCK * Row<G>::WORDS * 4;

}  // namespace

// the kernel's lanes a row and its dynamic shared memory a block, as
// this library was built
extern "C" int fts_gt_product_config(int* g, int* smem) {
  *g = G;
  *smem = (int)SMEM;
  return 0;
}

#ifdef FTS_HOST_CHECK
namespace {
// The rows by NG emulated lanes (host_check.h), a row's cells in a host
// buffer.
template <int NG>
void host_rows(const uint32_t* f, uint32_t* out, int n, int k) {
  std::vector<uint32_t> cells(Row<NG>::WORDS);
  for (int row = 0; row < n; ++row) {
    auto body = [&](int lane) {
      const Row<NG> r((uint32_t)lane, cells.data(), 1);
      gtc::gt_product_row<NG>(r, f, out, row, k, true);
    };
    coop::host_group(NG, body);
  }
}
}  // namespace

// the kernel's own configuration
extern "C" void host_gt_product(const uint32_t* f, uint32_t* out, int n, int k) {
  host_rows<G>(f, out, n, k);
}

// the same rows by g lanes (1, 2, 4, 8, 16 or 32); returns -1 for any
// other
extern "C" int host_gt_product_lanes(const uint32_t* f, uint32_t* out, int n, int k, int g) {
  switch (g) {
    case 1: return host_rows<1>(f, out, n, k), 0;
    case 2: return host_rows<2>(f, out, n, k), 0;
    case 4: return host_rows<4>(f, out, n, k), 0;
    case 8: return host_rows<8>(f, out, n, k), 0;
    case 16: return host_rows<16>(f, out, n, k), 0;
    case 32: return host_rows<32>(f, out, n, k), 0;
    default: return -1;
  }
}
#else
#include <cuda_runtime.h>

namespace {
__global__ void __launch_bounds__(THREADS) gt_product_kernel(const uint32_t* __restrict__ f,
                                                             uint32_t* __restrict__ out, int n,
                                                             int k) {
  extern __shared__ uint32_t cells[];
  const uint32_t slot = threadIdx.x / G;  // the row's place in the block
  const Row<G> r(threadIdx.x % G, cells + slot, ROWS_PER_BLOCK);
  const int row = (int)(blockIdx.x * ROWS_PER_BLOCK + slot);
  const bool live = row < n;  // a clamped row still takes part in every barrier
  gtc::gt_product_row<G>(r, f, out, live ? row : n - 1, k, live);
}

// lets a launch take SMEM of dynamic shared memory (above 48 KB only
// by the attribute)
cudaError_t prepare() {
  if (SMEM <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(gt_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM);
}
}  // namespace

// the blocks of the kernel an SM holds at once, as the card counts them
extern "C" int fts_gt_product_occupancy(int* blocks) {
  cudaError_t e = prepare();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gt_product_kernel, THREADS,
                                                               SMEM);
}

extern "C" int fts_gt_product(const void* f, void* out, int n, int k, void* stream) {
  if (n <= 0) return 0;
  if (k <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare();
  if (e != cudaSuccess) return (int)e;
  int blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  gt_product_kernel<<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const uint32_t*)f, (uint32_t*)out, n, k);
  return (int)cudaGetLastError();
}
#endif
