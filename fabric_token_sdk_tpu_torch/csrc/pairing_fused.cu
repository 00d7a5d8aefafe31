// pairing_fused: a pairing product a row in one launch, in two modes:
//
// * fts_pairing_product: prod_k e(P_k, Q_k) for each row: the Miller loop
//   of each of the row's K legs, their product, one final exponentiation.
//   Replaces the JAX programs behind fabric_token_sdk_tpu/parallel/
//   sharding.py:_fused_pairing_product (the per-row body of its shard_map
//   when mp = 1) and fabric_token_sdk_tpu/ops/pairing.py:pairing_product
//   (the fused entry point).
// * fts_gt_product_final_exp: the tail of the sharded product, after the
//   Miller values were gathered over the mp axis: their product and one
//   final exponentiation (_fused_pairing_product's body after its
//   all_gather).
//
// Both are built from the staged kernels' row functions, chained in
// shared memory: bn254_miller_row.cuh's Miller loop (miller.cu's) and
// bn254_gt_rows.cuh's product and final exponentiation (gt_product.cu's,
// final_exp.cu's). So a row's GT value equals the staged sequence miller
// -> gt_product -> final_exp bit for bit, and a faster row function
// speeds both. The legs are multiplied left to right; the product
// commutes and GT values are canonical, so the order does not change the
// result.
//
// The design. A warp runs its own rows in its own cells. In
// fts_pairing_product a row's K legs run their Miller loops side by side,
// each over GM lanes, so a row takes K x GM lanes and a warp R = max(1,
// 32 / (K x GM)) rows; when K x GM > 32 (R = 1) a row's legs run in rounds
// of 32 / GM. After each round the GF lanes of each row multiply the
// round's Miller values into the row's product (gt_product's op_mul
// chain); after the last round they run the final exponentiation on that
// slot, in the same shared memory, and store the canonical result once.
// When R x GF > 32 the rows take their turns, 32 / GF rows a turn. A block
// holds up to 8 warps, as many as spread the launch evenly over the SMs,
// and lines them up after each round's Miller loops (warps_a_block).
// fts_gt_product_final_exp runs 32 / GF rows a warp, a warp a block, each
// row's K values loaded from global memory into the product.
//
// Barriers. The tower's Row::sync is a whole-warp __syncwarp, valid
// because every group of the warp runs the same phases: the Miller
// loop's depend only on the public bits of 6u+2, the final
// exponentiation's program on nothing else. So every lane takes part in
// every barrier: a group with no leg in a round (K = 3, or the last round)
// runs the Miller loop of a clamped leg in its own cells and nothing
// reads them; a lane with no row in a turn (R x GF < 32) runs the ops with
// no task and no store in a column of its own that nobody writes; a row
// past the last runs on a clamped row and stores nothing.
//
// Shared memory (Plan: words of a warp, from K and the lanes):
// a leg is 52 Fp2 cells (3,328 B), one column of them a group; a row is
// 78 (final_exp's ten Fp12 slots and the product cells, 4,992 B), 32 / GF
// columns a turn. With one round of legs the rows' cells lie over the
// legs' cells past their f, which are dead once every loop has ended (the
// product reads only the legs' f); with several rounds (R = 1) the row's
// cells follow the legs'.
//
// The mask and the legs. A masked leg (mask != 0) contributes GT one, by
// a select after its Miller loop, as the reference's jnp.where: the mask
// byte enters the select as a word made opaque to the compiler, so no
// branch, predicate or address depends on it or on the legs, which derive
// from secrets on the prove path. Without a mask a (0, 0) leg runs
// through the loop, its Miller value lies in Fp4, and the final
// exponentiation sends it to one, as on the staged path.
//
// Layout: P (n, k, 2, 8), Q (n, k, 2, 2, 8) Montgomery affine in [0, 2p),
// mask (n, k) bytes or null; f (n, k, 6, 2, 8) Montgomery Fp12 in
// [0, 2p); out (n, 6, 2, 8) canonical Montgomery GT.
//
// What bounds it on the H100: integer multiplies, per row K Miller loops
// (~8,300 base products each), K - 1 Fp12 products and one final
// exponentiation (~8,800), against ~(K * 96 + 384) bytes moved
// (fts_pairing_product) or (K + 1) * 384. GM and GF are from the sweep of
// chip_probe.py --redesign --sweep fused.
#include <algorithm>

#include "bn254_gt_rows.cuh"
#include "bn254_miller_row.cuh"

using namespace bn254;

#ifndef FTS_FUSED_GM
#define FTS_FUSED_GM 4  // lanes a leg (chip_probe.py overrides it for its sweep)
#endif
#ifndef FTS_FUSED_GF
#define FTS_FUSED_GF 8  // lanes a row for the product and the final exponentiation
#endif

namespace {

using gtc::Fe;
using gtc::Fe2;

constexpr int THREADS = 32;                       // a warp
constexpr int LEG_WORDS = miller::Row<1>::WORDS;  // a leg's cells
constexpr int SLOT_WORDS = 6 * 2 * NW;            // an Fp12 slot
constexpr int ROW_WORDS = gtc::ROW_WORDS;         // a row's cells
constexpr uint32_t IDLE = THREADS;  // the place of a lane with no row: past every task

// A warp's rows, rounds and cells. Public: from K and the lanes only.
// The rows lie in turns of 32 / GF columns (a turn's cells after the last
// turn's), the legs in columns of a round's 32 / GM: every stride is a
// compile-time constant, so a cell's address is a constant offset from
// its column (a stride from K made ptxas keep the addresses of every cell
// live, and spill them).
struct Plan {
  int rows;      // rows a warp
  int legs;      // legs of a row a round
  int rounds;    // rounds of Miller loops
  int turns;     // turns of rows for the product and the final exponentiation
  int row_base;  // word of the first row column
  int words;     // shared words a warp
};

Plan plan_of(int gm, int gf, int k, bool with_miller) {
  Plan p{};
  const int turn = THREADS / gf, groups = THREADS / gm;
  if (!with_miller) {  // the tail: a turn of rows, each its K values from global memory
    p.rows = turn;
    p.legs = k;
    p.rounds = p.turns = 1;
    p.words = turn * ROW_WORDS;
    return p;
  }
  p.rows = std::max(1, groups / k);
  p.legs = std::min(k, groups / p.rows);
  p.rounds = (k + p.legs - 1) / p.legs;
  p.turns = (p.rows + turn - 1) / turn;
  const int row_words = p.turns * turn * ROW_WORDS;
  if (p.rounds == 1) {  // the rows over the legs' cells past their f
    p.row_base = SLOT_WORDS * groups;
    p.words = std::max(LEG_WORDS * groups, p.row_base + row_words);
  } else {  // the rows after the legs
    p.row_base = LEG_WORDS * groups;
    p.words = p.row_base + row_words;
  }
  return p;
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Lines up the warps of a block of fts_pairing_product, each of which runs
// its own rows: they start each round's products, and the final
// exponentiations, together (on the host a warp runs alone).
__device__ __forceinline__ void block_sync() {
#ifndef FTS_HOST_CHECK
  __syncthreads();
#endif
}

// all ones where the mask byte is non-zero, by arithmetic on words the
// compiler cannot see through (never a predicate or a branch)
__device__ __forceinline__ uint32_t mask_word(uint8_t byte) {
  const uint32_t x = coop::opaque((uint32_t)byte);
  const uint32_t neg = coop::opaque(0u - x);
  return coop::opaque(0u - ((x | neg) >> 31));
}

// the first word of row r's column (stride 32 / GF)
template <int GF>
__device__ __forceinline__ int row_word(const Plan& p, int r) {
  constexpr int TURN = THREADS / GF;
  return p.row_base + (r / TURN) * TURN * ROW_WORDS + r % TURN;
}

// row r of the warp's by this lane of GF; past the warp's rows (a turn
// not full) the lane gets no task and only reads its own unused column
template <int GF>
__device__ __forceinline__ gtc::Row<GF> row_of(uint32_t lane, uint32_t* cells, const Plan& p,
                                               int r) {
  return gtc::Row<GF>(r < p.rows ? lane % GF : IDLE, cells + row_word<GF>(p, r), THREADS / GF);
}

// A row's Miller values in the legs' cells of a round: value j in the
// column of leg j - j0 (columns STRIDE apart), its f taken into a slot of
// the row, or GT one where the mask byte of value j is non-zero (no mask:
// none is masked).
template <int GM, int STRIDE>
struct FromLegs {
  uint32_t* col;                     // the column of the round's first leg of the row
  int j0;                            // the round's first value
  const uint8_t* __restrict__ mask;  // the row's mask bytes, or null

  template <int GF>
  __device__ __forceinline__ void operator()(const gtc::Row<GF>& r, int j, int slot) const {
    const miller::Row<GM> leg(0, col + (j - j0), STRIDE);
    const uint32_t masked = mask != nullptr ? mask_word(mask[j]) : 0u;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      if (!r.owns(c)) continue;
      Fe2 v = leg.load(miller::F + c);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint32_t one = c == 0 ? FP_ONE[w] : 0u;
        v.c0.w[w] = (one & masked) | (v.c0.w[w] & ~masked);
        v.c1.w[w] &= ~masked;
      }
      r.store(slot * 6 + c, v);
    }
    r.sync();
  }
};

// The rows of warp `warp` by this lane of it: the Miller loops round by
// round, each round's values into the rows' products, and after the last
// the final exponentiations, in turns of rows.
template <int GM, int GF>
__device__ __forceinline__ void product_warp(uint32_t lane, uint32_t* cells, const Plan& p,
                                             int warp, const uint32_t* __restrict__ P,
                                             const uint32_t* __restrict__ Q,
                                             const uint8_t* __restrict__ mask,
                                             uint32_t* __restrict__ out, int n, int k) {
  constexpr int TURN = THREADS / GF;        // rows a turn
  constexpr int LEG_STRIDE = THREADS / GM;  // the legs' columns
  const int c = (int)(lane / GM);           // this lane's leg column
  uint32_t* const leg_col = cells + c;
#pragma unroll 1
  for (int t = 0; t < p.rounds; ++t) {
    // column c runs leg j of row r, or a clamped leg that nothing reads
    const int r = c / p.legs, j = t * p.legs + c % p.legs;
    const bool real = r < p.rows && j < k;
    const int row = imin(warp * p.rows + (real ? r : 0), n - 1);
    const size_t leg = (size_t)row * k + (real ? j : 0);
    miller::miller_leg(miller::Row<GM>(lane % GM, leg_col, LEG_STRIDE), P + leg * 2 * NW,
                       Q + leg * 4 * NW);
    block_sync();
    // the round's values j0 .. j0 + nj - 1 into each row's product, and
    // after the last round the final exponentiation
    const int j0 = t * p.legs, nj = imin(p.legs, k - j0);
    const bool last = t == p.rounds - 1;
#pragma unroll 1
    for (int u = 0; u < p.turns; ++u) {
      const int rr = u * TURN + (int)(lane / GF), row = warp * p.rows + rr;
      const size_t first = (size_t)imin(row, n - 1) * k;
      uint32_t* const col = cells + rr * p.legs;
      const gtc::Row<GF> fr = row_of<GF>(lane, cells, p, rr);
      gtc::program_run(fr, j0, nj,
                       FromLegs<GM, LEG_STRIDE>{col, j0, mask != nullptr ? mask + first : nullptr},
                       last);
      if (last)
        gtc::store_slot(fr, gtc::SLOT_OUT, out + (size_t)imin(row, n - 1) * gtc::GT_WORDS,
                        rr < p.rows && row < n);
    }
  }
}

// The rows of warp `warp` of the tail by this lane: each row's K values
// into its product, then the final exponentiation.
template <int GF>
__device__ __forceinline__ void tail_warp(uint32_t lane, uint32_t* cells, const Plan& p,
                                          int warp, const uint32_t* __restrict__ f,
                                          uint32_t* __restrict__ out, int n, int k) {
  const int row = warp * p.rows + (int)(lane / GF);
  const bool live = row < n;  // a clamped row still takes part in every barrier
  const gtc::Row<GF> fr = row_of<GF>(lane, cells, p, (int)(lane / GF));
  gtc::program_run(fr, 0, k, gtc::FromGlobal{f + (size_t)(live ? row : n - 1) * k * gtc::GT_WORDS},
                   true);
  gtc::store_slot(fr, gtc::SLOT_OUT, out + (size_t)(live ? row : n - 1) * gtc::GT_WORDS, live);
}

constexpr int GM = FTS_FUSED_GM;
constexpr int GF = FTS_FUSED_GF;
static_assert(32 % GM == 0 && GM > 1, "a leg's lanes tile a warp");
static_assert(32 % GF == 0 && GF > 1, "a row's lanes tile a warp");

}  // namespace

// As this library was built, for K legs a row: out[0..5] = GM, GF, and
// the rows and the dynamic shared memory (bytes) of a warp of
// fts_pairing_product, then of fts_gt_product_final_exp.
extern "C" int fts_pairing_fused_config(int k, int* out) {
  if (k <= 0) return -1;
  const Plan p = plan_of(GM, GF, k, true), q = plan_of(GM, GF, k, false);
  const int vals[6] = {GM, GF, p.rows, p.words * 4, q.rows, q.words * 4};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

#ifdef FTS_HOST_CHECK
namespace {
// The warps by 32 emulated lanes (host_check.h: a warp, its barriers real
// ones), a warp's cells in a host buffer.
template <int NGM, int NGF>
void host_product(const uint32_t* P, const uint32_t* Q, const uint8_t* mask, uint32_t* out, int n,
                  int k) {
  const Plan p = plan_of(NGM, NGF, k, true);
  std::vector<uint32_t> cells(p.words);
  for (int b = 0; b * p.rows < n; ++b) {
    auto body = [&](int lane) {
      product_warp<NGM, NGF>((uint32_t)lane, cells.data(), p, b, P, Q, mask, out, n, k);
    };
    coop::host_group(THREADS, body);
  }
}

template <int NGF>
void host_tail(const uint32_t* f, uint32_t* out, int n, int k) {
  const Plan p = plan_of(2, NGF, k, false);
  std::vector<uint32_t> cells(p.words);
  for (int b = 0; b * p.rows < n; ++b) {
    auto body = [&](int lane) { tail_warp<NGF>((uint32_t)lane, cells.data(), p, b, f, out, n, k); };
    coop::host_group(THREADS, body);
  }
}
}  // namespace

// the kernels' own configuration
extern "C" void host_pairing_product(const uint32_t* P, const uint32_t* Q, const uint8_t* mask,
                                     uint32_t* out, int n, int k) {
  host_product<GM, GF>(P, Q, mask, out, n, k);
}

extern "C" void host_gt_product_final_exp(const uint32_t* f, uint32_t* out, int n, int k) {
  host_tail<GF>(f, out, n, k);
}

// the same rows at gm lanes a leg (2, 4 or 8) and gf a row (4, 8 or 16);
// returns -1 for any other
extern "C" int host_pairing_product_lanes(const uint32_t* P, const uint32_t* Q,
                                          const uint8_t* mask, uint32_t* out, int n, int k,
                                          int gm, int gf) {
  switch (gm * 100 + gf) {
    case 204: return host_product<2, 4>(P, Q, mask, out, n, k), 0;
    case 208: return host_product<2, 8>(P, Q, mask, out, n, k), 0;
    case 216: return host_product<2, 16>(P, Q, mask, out, n, k), 0;
    case 404: return host_product<4, 4>(P, Q, mask, out, n, k), 0;
    case 408: return host_product<4, 8>(P, Q, mask, out, n, k), 0;
    case 416: return host_product<4, 16>(P, Q, mask, out, n, k), 0;
    case 804: return host_product<8, 4>(P, Q, mask, out, n, k), 0;
    case 808: return host_product<8, 8>(P, Q, mask, out, n, k), 0;
    case 816: return host_product<8, 16>(P, Q, mask, out, n, k), 0;
    default: return -1;
  }
}

// the tail at g lanes a row (4, 8 or 16); returns -1 for any other
extern "C" int host_gt_product_final_exp_lanes(const uint32_t* f, uint32_t* out, int n, int k,
                                               int g) {
  switch (g) {
    case 4: return host_tail<4>(f, out, n, k), 0;
    case 8: return host_tail<8>(f, out, n, k), 0;
    case 16: return host_tail<16>(f, out, n, k), 0;
    default: return -1;
  }
}
#else
#include <cuda_runtime.h>

namespace {
constexpr int MAX_WARPS = 8;  // warps a block of fts_pairing_product, at most

// each warp its own rows and cells
__global__ void __launch_bounds__(THREADS* MAX_WARPS)
    pairing_product_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                           const uint8_t* __restrict__ mask, uint32_t* __restrict__ out, int n,
                           int k, Plan p) {
  extern __shared__ uint32_t cells[];
  const int warp = (int)(threadIdx.x / THREADS), warps = (int)(blockDim.x / THREADS);
  product_warp<GM, GF>(threadIdx.x % THREADS, cells + warp * p.words, p,
                        (int)blockIdx.x * warps + warp, P, Q, mask, out, n, k);
}

__global__ void __launch_bounds__(THREADS)
    gt_product_final_exp_kernel(const uint32_t* __restrict__ f, uint32_t* __restrict__ out, int n,
                                int k, Plan p) {
  extern __shared__ uint32_t cells[];
  tail_warp<GF>(threadIdx.x, cells, p, (int)blockIdx.x, f, out, n, k);
}

// lets a launch of `kernel` take `smem` bytes of dynamic shared memory
// (above 48 KB only by the attribute)
template <class Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}
}  // namespace

// the warps of each kernel an SM holds at once for K legs a row, as the
// card counts them for blocks of one warp: blocks[0] fts_pairing_product's,
// blocks[1] the tail's
extern "C" int fts_pairing_fused_occupancy(int k, int* blocks) {
  if (k <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(GM, GF, k, true), q = plan_of(GM, GF, k, false);
  cudaError_t e = prepare(pairing_product_kernel, p.words * 4);
  if (e == cudaSuccess) e = prepare(gt_product_final_exp_kernel, q.words * 4);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, pairing_product_kernel, THREADS,
                                                      (size_t)p.words * 4);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks + 1, gt_product_final_exp_kernel,
                                                      THREADS, (size_t)q.words * 4);
  return (int)e;
}

// The warps a block of fts_pairing_product for a launch of `warps` warps:
// as many as spread them evenly over the SMs, at most MAX_WARPS and what a
// block's shared memory holds. A full SM then holds one block, whose warps
// keep in step: a final exponentiation ran ~1.7x slower (at 4,096 x 2)
// when the warps of an SM reached it at different times.
cudaError_t warps_a_block(const Plan& p, int warps, int* per) {
  int dev = 0, sms = 0, smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int fit = std::max(1, std::min(MAX_WARPS, smem / (p.words * 4)));
  *per = std::max(1, std::min(fit, (warps + sms - 1) / std::max(sms, 1)));
  return e;
}

// the grid of fts_pairing_product on n rows of K legs: grid[0] blocks,
// grid[1] threads a block
extern "C" int fts_pairing_product_grid(int n, int k, int* grid) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(GM, GF, k, true);
  const int warps = (n + p.rows - 1) / p.rows;
  int per = 1;
  const cudaError_t e = warps_a_block(p, warps, &per);
  grid[0] = (warps + per - 1) / per;
  grid[1] = per * THREADS;
  return (int)e;
}

extern "C" int fts_pairing_product(const void* P, const void* Q, const void* mask, void* out,
                                   int n, int k, void* stream) {
  if (n <= 0) return 0;
  int grid[2];
  cudaError_t e = (cudaError_t)fts_pairing_product_grid(n, k, grid);
  const Plan p = plan_of(GM, GF, k, true);
  const size_t smem = (size_t)(grid[1] / THREADS) * p.words * 4;
  if (e == cudaSuccess) e = prepare(pairing_product_kernel, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pairing_product_kernel<<<grid[0], grid[1], smem, (cudaStream_t)stream>>>(
      (const uint32_t*)P, (const uint32_t*)Q, (const uint8_t*)mask, (uint32_t*)out, n, k, p);
  return (int)cudaGetLastError();
}

extern "C" int fts_gt_product_final_exp(const void* f, void* out, int n, int k, void* stream) {
  if (n <= 0) return 0;
  if (k <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(GM, GF, k, false);
  cudaError_t e = prepare(gt_product_final_exp_kernel, p.words * 4);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + p.rows - 1) / p.rows;
  gt_product_final_exp_kernel<<<blocks, THREADS, (size_t)p.words * 4, (cudaStream_t)stream>>>(
      (const uint32_t*)f, (uint32_t*)out, n, k, p);
  return (int)cudaGetLastError();
}
#endif
