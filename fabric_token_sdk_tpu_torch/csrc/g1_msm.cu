// g1_msm: fixed-base multiexp, each row's windows split over S lanes of
// a warp, in two modes built from one template.
//
// Replaces the JAX programs g1_msm{1,2,3}_tile
// (fabric_token_sdk_tpu/ops/stages.py:_g1_msm_tile, via
// ops/curve.py:msm_select). There, each row's window points were picked
// by a one-hot digit einsum (a dense matmul for the TPU's matrix unit)
// and summed by a scan of Jacobian adds. Here a row's nb*64 windows t =
// 64 b + w (base-major, LSB-first) fall into S equal shares: lane j
// adds the entries table[t][digit] of its own share, in order, into a
// projective accumulator (starting at the identity (0 : 1 : 0)) by the
// complete mixed addition of Renes, Costello and Batina (2016, Algorithm
// 8, a = 0; 11 products): P == Q, P == -Q and the identity take the same
// operations as any other input, so no case needs a select or a
// doubling. An entry of digit 0 is the table's all-zero infinity, which
// the formula does not take: a select keeps the accumulator then (y = 0
// marks it; no affine point has y = 0). The S sums are joined by a
// butterfly of log2(S) complete additions (Algorithm 7, 12 products)
// over __shfl_xor_sync of the 24-word point, and the row's lane 0 stores
// the sum as Jacobian (X Z, Y Z^2, Z): the same point as the reference's,
// another Jacobian Z; infinity is all zero. The plain versions
// (ops/curve.py:msm) run this exact sequence, so the kernels equal them
// bit for bit. The pick comes in two forms:
//
// * gather (fts_g1_msm, the verify path): the lane loads the one entry
//   the digit names. The load address depends on the digit, which is
//   fine for verification: its scalars are public proof responses.
// * select (fts_g1_msm_select, the prove path): the lane loads X and Y
//   of all 16 entries of the window and keeps the wanted one by OR-ing
//   each entry under a mask, 0 - (d == digit), made opaque to the
//   compiler so that it cannot be turned back into a predicated load or
//   a branch. No load address and no branch depends on the digit: the
//   loops run over the public window and entry counts, the share a lane
//   owns and the tree depend only on lane indices, and the digit only
//   ever enters the mask arithmetic and the select of a digit-0 entry.
//   This is the reference's one-hot contraction, and what the prover's
//   secret openings (values, blinding factors, sigma randomness) need.
//   chip_probe.py writes the SASS and counts its predicated loads and
//   branches.
//
// Layout: table (nbases*64, 16, 3, 8) uint32, entry [t][d] = d * 16^w *
// base_b for t = 64b + w, affine (Z = Montgomery one) or all zero, in
// Montgomery form, coordinates in [0, 2p); scalars (n, nbases, 8)
// canonical (non-Montgomery) words, read as given; out (n, 3, 8)
// canonical Montgomery Jacobian.
//
// What bounds it on the H100: integer multiplies, 11 CIOS products a
// window (the bound counts a mixed add a non-zero digit); the table
// (295 KB at 3 bases) stays in L2. A lane reads 64 bytes of an entry in
// gather mode and 16 x 64 in select mode. The design fills the card: S
// lanes a row (S = 8, from the sweep of chip_probe.py over S in {4, 8,
// 16, 32}) give 8x the threads of one thread a row, each with 1/8 of the
// windows at half the products of a Jacobian add; the accumulators stay
// in registers, with no shared memory and no stack. Each lane holds
// whole field elements (bn254_ladder.cuh's field at TPI = 1): spreading
// an element over 2 or 4 lanes lost 1.2-12x at every row count measured.
#include "bn254_ladder.cuh"

using namespace bn254;

#ifndef FTS_G1_MSM_S
#define FTS_G1_MSM_S 8  // lanes a row (chip_probe.py overrides it for its sweep)
#endif

namespace {

constexpr int WINDOWS = 64;  // 4-bit windows per 256-bit scalar
constexpr int DIGITS = 16;   // entries per window
constexpr int ENTRY_WORDS = 3 * NW;  // a table entry or an output point

// the cooperative field of one lane: whole elements, no shuffle
using Group = coop::Group<1>;
using Fe = coop::FeT<1>;
using Pt = coop::Pt<1, 3>;

// 9x = 8x + x (3b, b = 3)
__device__ __forceinline__ Fe times9(const Group& g, const Fe& x) {
  Fe x2 = coop::fe_add(g, x, x);
  Fe x4 = coop::fe_add(g, x2, x2);
  return coop::fe_add(g, coop::fe_add(g, x4, x4), x);
}

// Complete mixed addition (RCB Algorithm 8, a = 0): p + (x2, y2), the
// affine point not the identity; ops/curve.py:proj_madd in its order.
__device__ __forceinline__ Pt madd(const Group& g, const Pt& p, const Fe& x2, const Fe& y2) {
  using namespace coop;
  const Fe&x1 = p.e[0], &y1 = p.e[1], &z1 = p.e[2];
  Fe t0 = fe_mul(g, x1, x2);
  Fe t1 = fe_mul(g, y1, y2);
  Fe t4 = fe_mul(g, y2, z1);
  Fe y3 = fe_mul(g, x2, z1);
  Fe t3 = fe_mul(g, fe_add(g, x2, y2), fe_add(g, x1, y1));
  t3 = fe_sub(g, t3, fe_add(g, t0, t1));
  t4 = fe_add(g, t4, y1);
  y3 = fe_add(g, y3, x1);
  Fe x3 = fe_add(g, t0, t0);
  t0 = fe_add(g, x3, t0);
  Fe t2 = times9(g, z1);
  Fe z3 = fe_add(g, t1, t2);
  t1 = fe_sub(g, t1, t2);
  y3 = times9(g, y3);
  x3 = fe_mul(g, t4, y3);
  t2 = fe_mul(g, t3, t1);
  y3 = fe_mul(g, y3, t0);
  t1 = fe_mul(g, t1, z3);
  t0 = fe_mul(g, t0, t3);
  z3 = fe_mul(g, z3, t4);
  Pt r;
  r.e[0] = fe_sub(g, t2, x3);
  r.e[1] = fe_add(g, t1, y3);
  r.e[2] = fe_add(g, z3, t0);
  return r;
}

// Complete addition (RCB Algorithm 7, a = 0); ops/curve.py:proj_add.
__device__ __forceinline__ Pt padd(const Group& g, const Pt& p, const Pt& q) {
  using namespace coop;
  const Fe&x1 = p.e[0], &y1 = p.e[1], &z1 = p.e[2];
  const Fe&x2 = q.e[0], &y2 = q.e[1], &z2 = q.e[2];
  Fe t0 = fe_mul(g, x1, x2);
  Fe t1 = fe_mul(g, y1, y2);
  Fe t2 = fe_mul(g, z1, z2);
  Fe t3 = fe_mul(g, fe_add(g, x1, y1), fe_add(g, x2, y2));
  Fe t4 = fe_mul(g, fe_add(g, y1, z1), fe_add(g, y2, z2));
  Fe x3 = fe_mul(g, fe_add(g, x1, z1), fe_add(g, x2, z2));
  t3 = fe_sub(g, t3, fe_add(g, t0, t1));
  t4 = fe_sub(g, t4, fe_add(g, t1, t2));
  Fe y3 = fe_sub(g, x3, fe_add(g, t0, t2));
  x3 = fe_add(g, t0, t0);
  t0 = fe_add(g, x3, t0);
  t2 = times9(g, t2);
  Fe z3 = fe_add(g, t1, t2);
  t1 = fe_sub(g, t1, t2);
  y3 = times9(g, y3);
  x3 = fe_mul(g, t4, y3);
  t2 = fe_mul(g, t3, t1);
  y3 = fe_mul(g, y3, t0);
  t1 = fe_mul(g, t1, z3);
  t0 = fe_mul(g, t0, t3);
  z3 = fe_mul(g, z3, t4);
  Pt r;
  r.e[0] = fe_sub(g, t2, x3);
  r.e[1] = fe_add(g, t1, y3);
  r.e[2] = fe_add(g, z3, t0);
  return r;
}

// This lane's words of X and Y of the window entry `digit` (16 entries
// of 24 words): gathered, or selected by a masked read of all 16.
template <bool SELECT>
__device__ __forceinline__ void window_entry(const uint32_t* __restrict__ window, uint32_t digit,
                                             Fe& x, Fe& y) {
  const uint32_t* e = window;
  if constexpr (!SELECT) {
    e += digit * ENTRY_WORDS;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      x.w[k] = __ldg(e + k);
      y.w[k] = __ldg(e + NW + k);
    }
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) x.w[k] = y.w[k] = 0u;
#pragma unroll 1
    for (uint32_t d = 0; d < (uint32_t)DIGITS; ++d, e += ENTRY_WORDS) {
      const uint32_t mask = coop::opaque(0u - (uint32_t)(d == digit));
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        x.w[k] |= __ldg(e + k) & mask;
        y.w[k] |= __ldg(e + NW + k) & mask;
      }
    }
  }
}

// v of the lane `xor_lanes` away in the warp (another share of the row)
__device__ __forceinline__ uint32_t shfl_xor(uint32_t v, int xor_lanes) {
#ifdef FTS_HOST_CHECK
  uint32_t all[fts_host::MAX_LANES];
  fts_host::exchange(v, all);
  return all[fts_host::lane_id() ^ xor_lanes];
#else
  return __shfl_xor_sync(coop::FULL, v, xor_lanes);
#endif
}

// One row by this lane, share j of S. `live` is false for a row past the
// last: it runs (every lane of the row takes part in every shuffle) and
// stores nothing.
template <bool SELECT, int S>
__device__ __forceinline__ void msm_row(uint32_t j, const uint32_t* __restrict__ table,
                                        const uint32_t* __restrict__ scalars,
                                        uint32_t* __restrict__ out, int row, int nbases,
                                        bool live) {
  const Group g(0u);
  const int share = nbases * WINDOWS / S;
  Pt acc;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    acc.e[0].w[k] = acc.e[2].w[k] = 0u;
    acc.e[1].w[k] = FP_ONE[k];
  }
  const uint32_t* s = scalars + (size_t)row * nbases * NW;
  int t = (int)j * share;
#pragma unroll 1
  for (int i = 0; i < share; ++i, ++t) {
    const int w = t % WINDOWS;
    const uint32_t digit = (__ldg(s + (t / WINDOWS) * NW + w / 8) >> (4 * (w % 8))) & 15u;
    Fe x2, y2;
    window_entry<SELECT>(table + (size_t)t * DIGITS * ENTRY_WORDS, digit, x2, y2);
    Pt sum = madd(g, acc, x2, y2);
    acc = coop::pt_select(coop::fe_is_zero(g, y2), acc, sum);  // digit 0: keep acc
  }
  // the butterfly: after step d each lane holds its own sum plus that of
  // the share j ^ d, its own first; share 0 ends with the pairwise tree
#pragma unroll 1
  for (int d = 1; d < S; d <<= 1) {
    Pt other;
#pragma unroll
    for (int f = 0; f < 3; ++f)
#pragma unroll
      for (int k = 0; k < NW; ++k) other.e[f].w[k] = shfl_xor(acc.e[f].w[k], d);
    acc = padd(g, acc, other);
  }
  // projective -> Jacobian (X Z, Y Z^2, Z), canonical; share 0 stores
  Fe jac[3];
  jac[2] = acc.e[2];
  jac[0] = coop::fe_mul(g, acc.e[0], acc.e[2]);
  jac[1] = coop::fe_mul(g, acc.e[1], coop::fe_mul(g, acc.e[2], acc.e[2]));
  if (live && j == 0) {
    uint32_t* dst = out + (size_t)row * ENTRY_WORDS;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const Fe c = coop::fe_canon(g, jac[f]);
#pragma unroll
      for (int k = 0; k < NW; ++k) dst[f * NW + k] = c.w[k];
    }
  }
}

}  // namespace

// the kernels' lanes a row, as this library was built
extern "C" int fts_g1_msm_config(int* s) {
  *s = FTS_G1_MSM_S;
  return 0;
}

#ifdef FTS_HOST_CHECK
namespace {
// The rows by emulated lanes: the S shares run in lockstep
// (host_check.h), exchanging words where the card shuffles.
template <bool SELECT, int S>
void host_rows(const uint32_t* table, const uint32_t* scalars, uint32_t* out, int n, int nbases) {
  for (int row = 0; row < n; ++row) {
    auto body = [&](int lane) {
      msm_row<SELECT, S>((uint32_t)lane, table, scalars, out, row, nbases, true);
    };
    coop::host_group(S, body);
  }
}

template <bool SELECT>
int host_lanes(const uint32_t* table, const uint32_t* scalars, uint32_t* out, int n, int nbases,
               int s) {
  switch (s) {
    case 1: return host_rows<SELECT, 1>(table, scalars, out, n, nbases), 0;
    case 2: return host_rows<SELECT, 2>(table, scalars, out, n, nbases), 0;
    case 4: return host_rows<SELECT, 4>(table, scalars, out, n, nbases), 0;
    case 8: return host_rows<SELECT, 8>(table, scalars, out, n, nbases), 0;
    case 16: return host_rows<SELECT, 16>(table, scalars, out, n, nbases), 0;
    case 32: return host_rows<SELECT, 32>(table, scalars, out, n, nbases), 0;
    default: return -1;
  }
}
}  // namespace

// the kernels' own configuration (S lanes a row)
extern "C" void host_g1_msm(const uint32_t* table, const uint32_t* scalars, uint32_t* out,
                            int n, int nbases) {
  host_lanes<false>(table, scalars, out, n, nbases, FTS_G1_MSM_S);
}

extern "C" void host_g1_msm_select(const uint32_t* table, const uint32_t* scalars,
                                   uint32_t* out, int n, int nbases) {
  host_lanes<true>(table, scalars, out, n, nbases, FTS_G1_MSM_S);
}

// the same rows at another split s (1, 2, 4, 8, 16 or 32); returns -1 for
// any other
extern "C" int host_g1_msm_lanes(const uint32_t* table, const uint32_t* scalars, uint32_t* out,
                                 int n, int nbases, int s, int select) {
  return select ? host_lanes<true>(table, scalars, out, n, nbases, s)
                : host_lanes<false>(table, scalars, out, n, nbases, s);
}
#else
#include <cuda_runtime.h>

namespace {
constexpr int S = FTS_G1_MSM_S;  // lanes a row
static_assert(S <= 32 && 32 % S == 0, "a row's lanes tile a warp");
constexpr int THREADS = 128;
constexpr int ROWS_PER_BLOCK = THREADS / S;

template <bool SELECT>
__global__ void __launch_bounds__(THREADS) g1_msm_kernel(const uint32_t* __restrict__ table,
                                                         const uint32_t* __restrict__ scalars,
                                                         uint32_t* __restrict__ out, int n,
                                                         int nbases) {
  const int row = (int)(blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / S);
  const bool live = row < n;  // a clamped row still takes part in every shuffle
  msm_row<SELECT, S>(threadIdx.x % S, table, scalars, out, live ? row : n - 1, nbases, live);
}

template <bool SELECT>
int launch(const void* table, const void* scalars, void* out, int n, int nbases,
           void* stream) {
  if (n <= 0) return 0;
  if ((nbases * WINDOWS) % S) return (int)cudaErrorInvalidValue;
  int blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  g1_msm_kernel<SELECT><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const uint32_t*)scalars, (uint32_t*)out, n, nbases);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int fts_g1_msm(const void* table, const void* scalars, void* out,
                          int n, int nbases, void* stream) {
  return launch<false>(table, scalars, out, n, nbases, stream);
}

extern "C" int fts_g1_msm_select(const void* table, const void* scalars, void* out,
                                 int n, int nbases, void* stream) {
  return launch<true>(table, scalars, out, n, nbases, stream);
}
#endif
