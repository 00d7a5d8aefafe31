// miller: the optimal-ate Miller loop over 6u+2, each leg spread over G
// lanes of a warp on the cooperative tower of bn254_gt_coop.cuh, its
// state in shared memory.
//
// Replaces the JAX program miller_tile (fabric_token_sdk_tpu/ops/
// pairing.py:miller_loop). The row function, its mathematics and its
// design are bn254_miller_row.cuh's (shared with pairing_fused.cu).
//
// Layout: P (n, 2, 8) and Q (n, 2, 2, 8) Montgomery affine in [0, 2p);
// out (n, 6, 2, 8) canonical Montgomery Fp12.
//
// A block is one warp of 32 / G legs, each leg's 52 Fp2 cells in shared
// memory (3,328 B). G = 4 is from the sweep of chip_probe.py --redesign
// --sweep miller: the least time summed over the 2-in/2-out verify's 992
// and 15,872 legs and the PS verify's 128 (more lanes shorten the chain
// below a wave; at batch rows a phase's half-empty last round costs a
// warp the same issue slots).
#include "bn254_miller_row.cuh"

using namespace bn254;

#ifndef FTS_MILLER_G
#define FTS_MILLER_G 4  // lanes a leg (chip_probe.py overrides it for its sweep)
#endif

namespace {

using miller::Row;

constexpr int G = FTS_MILLER_G;
static_assert(32 % G == 0, "a leg's lanes tile a warp");
constexpr int THREADS = 32;  // one warp a block
constexpr int ROWS_PER_BLOCK = THREADS / G;
// a block's cells: the dynamic shared memory of a launch
constexpr size_t SMEM = (size_t)ROWS_PER_BLOCK * Row<G>::WORDS * 4;

}  // namespace

// the kernel's lanes a leg and its dynamic shared memory a block, as
// this library was built
extern "C" int fts_miller_config(int* g, int* smem) {
  *g = G;
  *smem = (int)SMEM;
  return 0;
}

#ifdef FTS_HOST_CHECK
namespace {
// The legs by NG emulated lanes (host_check.h), a leg's cells in a host
// buffer.
template <int NG>
void host_rows(const uint32_t* P_, const uint32_t* Q_, uint32_t* out, int n) {
  std::vector<uint32_t> cells(Row<NG>::WORDS);
  for (int row = 0; row < n; ++row) {
    auto body = [&](int lane) {
      const Row<NG> r((uint32_t)lane, cells.data(), 1);
      miller::miller_row<NG>(r, P_, Q_, out, row, true);
    };
    coop::host_group(NG, body);
  }
}
}  // namespace

// the kernel's own configuration
extern "C" void host_miller(const uint32_t* P_, const uint32_t* Q_, uint32_t* out, int n) {
  host_rows<G>(P_, Q_, out, n);
}

// the same legs by g lanes (1, 2, 4, 8, 16 or 32); returns -1 for any
// other
extern "C" int host_miller_lanes(const uint32_t* P_, const uint32_t* Q_, uint32_t* out, int n,
                                 int g) {
  switch (g) {
    case 1: return host_rows<1>(P_, Q_, out, n), 0;
    case 2: return host_rows<2>(P_, Q_, out, n), 0;
    case 4: return host_rows<4>(P_, Q_, out, n), 0;
    case 8: return host_rows<8>(P_, Q_, out, n), 0;
    case 16: return host_rows<16>(P_, Q_, out, n), 0;
    case 32: return host_rows<32>(P_, Q_, out, n), 0;
    default: return -1;
  }
}
#else
#include <cuda_runtime.h>

namespace {
__global__ void __launch_bounds__(THREADS) miller_kernel(const uint32_t* __restrict__ P_,
                                                         const uint32_t* __restrict__ Q_,
                                                         uint32_t* __restrict__ out, int n) {
  extern __shared__ uint32_t cells[];
  const uint32_t slot = threadIdx.x / G;  // the leg's place in the block
  const Row<G> r(threadIdx.x % G, cells + slot, ROWS_PER_BLOCK);
  const int row = (int)(blockIdx.x * ROWS_PER_BLOCK + slot);
  const bool live = row < n;  // a clamped row still takes part in every barrier
  miller::miller_row<G>(r, P_, Q_, out, live ? row : n - 1, live);
}

// lets a launch take SMEM of dynamic shared memory (above 48 KB only
// by the attribute)
cudaError_t prepare() {
  if (SMEM <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(miller_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM);
}
}  // namespace

// the blocks of the kernel an SM holds at once, as the card counts them
extern "C" int fts_miller_occupancy(int* blocks) {
  cudaError_t e = prepare();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, miller_kernel, THREADS,
                                                               SMEM);
}

extern "C" int fts_miller(const void* P_, const void* Q_, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = prepare();
  if (e != cudaSuccess) return (int)e;
  int blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  miller_kernel<<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const uint32_t*)P_, (const uint32_t*)Q_, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
