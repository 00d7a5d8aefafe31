// probe_fused_parts: measurement only (chip_probe.py --redesign --sweep
// fused); no path launches it. The two parts of pairing_fused.cu's
// fts_pairing_product, each alone on that kernel's own grid, plan and
// shared memory, so their times can be set beside the staged kernels':
//
// * part 0, the Miller part: each round's Miller loops and the block
//   barrier after it; no product, no final exponentiation. Lane 0 of each
//   warp stores one word of its first leg's f to out[warp], so the loops
//   are not optimised away.
// * part 1, the exponentiation part: a warp's rows as fts_pairing_product
//   lays them out (Plan: its rows a warp in turns of 32 / GF), each row's K
//   Miller values from global memory (f (n, k, 6, 2, 8), as the tail takes
//   them) into its product and the final exponentiation; out (n, 6, 2, 8)
//   equals fts_gt_product_final_exp's.
//
// It includes pairing_fused.cu, so it compiles the built variant's code.
#include "pairing_fused.cu"

namespace {

__global__ void __launch_bounds__(THREADS* MAX_WARPS)
    miller_part_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                       uint32_t* __restrict__ out, int n, int k, Plan p) {
  extern __shared__ uint32_t cells[];
  const int warp = (int)(threadIdx.x / THREADS), warps = (int)(blockDim.x / THREADS);
  const int gwarp = (int)blockIdx.x * warps + warp;
  const uint32_t lane = threadIdx.x % THREADS;
  const int c = (int)(lane / GM);
  uint32_t* const wcells = cells + warp * p.words;
#pragma unroll 1
  for (int t = 0; t < p.rounds; ++t) {
    const int r = c / p.legs, j = t * p.legs + c % p.legs;
    const bool real = r < p.rows && j < k;
    const int row = imin(gwarp * p.rows + (real ? r : 0), n - 1);
    const size_t leg = (size_t)row * k + (real ? j : 0);
    miller::miller_leg(miller::Row<GM>(lane % GM, wcells + c, THREADS / GM), P + leg * 2 * NW,
                       Q + leg * 4 * NW);
    block_sync();
  }
  if (lane == 0) out[gwarp] = wcells[0];
}

__global__ void __launch_bounds__(THREADS* MAX_WARPS)
    fexp_part_kernel(const uint32_t* __restrict__ f, uint32_t* __restrict__ out, int n, int k,
                     Plan p) {
  extern __shared__ uint32_t cells[];
  constexpr int TURN = THREADS / GF;
  const int warp = (int)(threadIdx.x / THREADS), warps = (int)(blockDim.x / THREADS);
  const int gwarp = (int)blockIdx.x * warps + warp;
  const uint32_t lane = threadIdx.x % THREADS;
  uint32_t* const wcells = cells + warp * p.words;
#pragma unroll 1
  for (int u = 0; u < p.turns; ++u) {
    const int rr = u * TURN + (int)(lane / GF), row = gwarp * p.rows + rr;
    const gtc::Row<GF> fr = row_of<GF>(lane, wcells, p, rr);
    gtc::program_run(fr, 0, k, gtc::FromGlobal{f + (size_t)imin(row, n - 1) * k * gtc::GT_WORDS},
                     true);
    gtc::store_slot(fr, gtc::SLOT_OUT, out + (size_t)imin(row, n - 1) * gtc::GT_WORDS,
                    rr < p.rows && row < n);
  }
}

}  // namespace

// part 0: the Miller part of P (n, k, 2, 8), Q (n, k, 2, 2, 8) into out
// (one word a warp of the grid); part 1: the exponentiation part of f
// (n, k, 6, 2, 8) into out (n, 6, 2, 8). Both on fts_pairing_product's grid.
extern "C" int fts_probe_fused_part(int part, const void* P, const void* Q, const void* f,
                                    void* out, int n, int k, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  int grid[2];
  cudaError_t e = (cudaError_t)fts_pairing_product_grid(n, k, grid);
  const Plan p = plan_of(GM, GF, k, true);
  const size_t smem = (size_t)(grid[1] / THREADS) * p.words * 4;
  if (e == cudaSuccess)
    e = part == 0 ? prepare(miller_part_kernel, (int)smem) : prepare(fexp_part_kernel, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (part == 0)
    miller_part_kernel<<<grid[0], grid[1], smem, (cudaStream_t)stream>>>(
        (const uint32_t*)P, (const uint32_t*)Q, (uint32_t*)out, n, k, p);
  else
    fexp_part_kernel<<<grid[0], grid[1], smem, (cudaStream_t)stream>>>(
        (const uint32_t*)f, (uint32_t*)out, n, k, p);
  return (int)cudaGetLastError();
}
