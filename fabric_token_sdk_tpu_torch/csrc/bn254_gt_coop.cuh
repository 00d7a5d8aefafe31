// A cooperative Fp6/Fp12 tower for GT kernels: each row spread over G
// lanes of a warp, its Fp12 values in shared memory.
//
// Built over bn254_ladder.cuh's field at TPI = 1 (Fe2<1>: each lane
// holds whole elements, so the field needs no shuffle). Fp12 is the
// reference's flat w-basis (ops/tower.py; c[j] the coefficient of
// w^j, w^6 = XI = 9 + i; c0 = (c[0], c[2], c[4]), c1 = (c[1], c[3],
// c[5]) over Fp6 = Fp2[v]/(v^3 - XI), w^2 = v), with its Frobenius
// constants FROB_GAMMA (bn254_tower.cuh).
//
// Where the values live. A row's values are Fp2 cells in shared
// memory: final_exp's 10 slots of 6 cells (an Fp12 each), or the fewer
// cells a kernel names (Row's NC: gt_product's 2 slots, the Miller
// loop's f, T, Q and step temporaries), the last 18 of a row its
// product cells. Cell c of a row is 2 elements of 8 words, word k of
// element e at col[((c * 2 + e) * 8 + k) * stride] in the row's column;
// the rows of a block interleave word by word (stride = rows a block).
// Nothing is kept in local memory and nothing is passed by value to a
// call: every op is inlined once into the kernel's program loop, and its
// live registers are a few Fp2.
//
// How an op runs. Each op is a product phase, the independent Fp2
// products of its formula (an operand is a sum of cells picked by a
// public mask, read from shared memory), written to the product cells,
// then a combine phase of additions that writes the result's cells. The
// G lanes of a row split both phases (product q in lane q mod G, output
// coefficient j in lane j mod G); __syncwarp orders the phases when G >
// 1. With G = 1 the lane runs the row alone, and no barrier is needed.
//
// The ops: Karatsuba product (18 Fp2 products; times conj(b) on the
// fly), cyclotomic squaring (Granger-Scott: three Fp4 squarings of
// (c[j], c[j+3]), 9 Fp2 squarings), conjugate, the p, p^2 and p^3
// Frobenius maps (6 products by constants), copy, and the inverse (the
// tower's: two Fp6 squarings, an Fp6 inverse around one Fermat inverse in
// Fp, two Fp6 products). Values stay in the redundant domain [0, 2p).
// Every mask and count is public; no address, branch or predicate
// depends on the values.
//
// Hazards. The lanes of a row part between barriers (each its own
// products and coefficients), which a field shared by several lanes
// could not do: its shuffles name the whole warp. A row past the last
// runs on a clamped row and skips only its store.
#pragma once

#include "bn254_ladder.cuh"
#include "bn254_tower.cuh"

namespace bn254 {
namespace gtc {

using Group = coop::Group<1>;
using Fe = coop::FeT<1>;
using Fe2 = coop::Fe2<1>;

// final_exp's row: slots of Fp12 (6 cells each), then the product cells
constexpr int SLOTS = 10;
constexpr int CELL_P = SLOTS * 6;
constexpr int NPROD = 18;
constexpr int CELLS = CELL_P + NPROD;
// the inverse's scratch: cells of slots 6 and 7, free until the Straus pass
constexpr int CELL_N = 6 * 6, CELL_C = CELL_N + 3, CELL_T = CELL_C + 3, CELL_NI = CELL_T + 1;

// words of an Fp12 in memory, (6, 2, 8); shared-memory words of
// final_exp's row
constexpr int GT_WORDS = 12 * NW;
constexpr int ROW_WORDS = CELLS * 2 * NW;

// A product's operands: bit j of the low byte picks cell j of the A
// window, of the high byte cell j of the B window.
#define FTS_Q(a, b) (uint16_t)((a) | (b) << 8)
// Karatsuba over Fp6 on the flat w-basis, for the even (c0) and odd (c1)
// coefficients: t0, t1, t2, t12, t01, t02 (Q_MUL's third six are over
// c0 + c1, its B masks those of A; Q_INV5's B masks the same six over an
// Fp6 of 3 contiguous cells)
#define FTS_EVEN6 0x01, 0x04, 0x10, 0x14, 0x05, 0x11
#define FTS_ODD6 0x02, 0x08, 0x20, 0x28, 0x0a, 0x22

static __device__ __constant__ uint16_t Q_MUL[18] = {
    FTS_Q(0x01, 0x01), FTS_Q(0x04, 0x04), FTS_Q(0x10, 0x10), FTS_Q(0x14, 0x14),
    FTS_Q(0x05, 0x05), FTS_Q(0x11, 0x11), FTS_Q(0x02, 0x02), FTS_Q(0x08, 0x08),
    FTS_Q(0x20, 0x20), FTS_Q(0x28, 0x28), FTS_Q(0x0a, 0x0a), FTS_Q(0x22, 0x22),
    FTS_Q(0x03, 0x03), FTS_Q(0x0c, 0x0c), FTS_Q(0x30, 0x30), FTS_Q(0x3c, 0x3c),
    FTS_Q(0x0f, 0x0f), FTS_Q(0x33, 0x33)};
// a^2, b^2, (a + b)^2 for the Fp4 pairs (c0, c3), (c1, c4), (c2, c5)
static __device__ __constant__ uint16_t Q_CSQR[9] = {0x01, 0x08, 0x09, 0x02, 0x10,
                                                     0x12, 0x04, 0x20, 0x24};
// inverse, step 1: c0^2 and c1^2 (squarings)
static __device__ __constant__ uint16_t Q_INV1[12] = {FTS_EVEN6, FTS_ODD6};
// step 2, over n (3 cells): n0^2, n2^2, n1^2, n1 n2, n0 n1, n0 n2
static __device__ __constant__ uint16_t Q_INV2[6] = {FTS_Q(1, 1), FTS_Q(4, 4), FTS_Q(2, 2),
                                                     FTS_Q(2, 4), FTS_Q(1, 2), FTS_Q(1, 4)};
// step 3, n against c: n2 c1, n1 c2, n0 c0
static __device__ __constant__ uint16_t Q_INV3[3] = {FTS_Q(4, 2), FTS_Q(2, 4), FTS_Q(1, 1)};
// step 4, c against t (1 cell): c0 t, c1 t, c2 t
static __device__ __constant__ uint16_t Q_INV4[3] = {FTS_Q(1, 1), FTS_Q(2, 1), FTS_Q(4, 1)};
// step 5, c0 and c1 of x against n^-1 (3 cells)
static __device__ __constant__ uint16_t Q_INV5[12] = {
    FTS_Q(0x01, 0x01), FTS_Q(0x04, 0x02), FTS_Q(0x10, 0x04), FTS_Q(0x14, 0x06),
    FTS_Q(0x05, 0x03), FTS_Q(0x11, 0x05), FTS_Q(0x02, 0x01), FTS_Q(0x08, 0x02),
    FTS_Q(0x20, 0x04), FTS_Q(0x28, 0x06), FTS_Q(0x0a, 0x03), FTS_Q(0x22, 0x05)};
#undef FTS_EVEN6
#undef FTS_ODD6
#undef FTS_Q

// ---------------------------------------------------------------- Fp2 extras

__device__ __forceinline__ Fe2 fe2_neg(const Group& g, const Fe2& a) {
  const Fe z = coop::fe_zero<1>();
  return Fe2{coop::fe_sub(g, z, a.c0), coop::fe_sub(g, z, a.c1)};
}

// times XI = 9 + i: (9 a0 - a1) + (a0 + 9 a1) i, as the reference's
__device__ __forceinline__ Fe2 fe2_mul_xi(const Group& g, const Fe2& a) {
  Fe2 e = coop::fe2_dbl(g, a);
  e = coop::fe2_dbl(g, e);
  e = coop::fe2_dbl(g, e);
  e = coop::fe2_add(g, e, a);
  return Fe2{coop::fe_sub(g, e.c0, a.c1), coop::fe_add(g, a.c0, e.c1)};
}

// a^(p-2) by square and multiply over the public bits of p - 2; 0 -> 0
__device__ __forceinline__ Fe fe_inv(const Group& g, const Fe& a) {
  Fe acc;
#pragma unroll
  for (int k = 0; k < NW; ++k) acc.w[k] = FP_ONE[k];
#pragma unroll 1
  for (int i = FP_PM2_BITS - 1; i >= 0; --i) {
    acc = coop::fe_mul(g, acc, acc);
    if ((FP_PM2[i >> 5] >> (i & 31)) & 1u) acc = coop::fe_mul(g, acc, a);
  }
  return acc;
}

// ---------------------------------------------------------------- a row's cells

// A row of NC cells, the last NPROD of them its product cells. The
// default is final_exp's ten slots; a kernel that needs fewer slots
// names its own count (miller.cu, gt_product.cu), so that more rows fit
// an SM.
template <int G, int NC = CELLS>
struct Row {
  static_assert(NC >= NPROD, "a row holds its product cells");
  static constexpr int P = NC - NPROD;       // the first product cell
  static constexpr int WORDS = NC * 2 * NW;  // shared-memory words a row
  Group g;
  uint32_t grp;   // this lane's place in the row, 0 .. G-1
  uint32_t* col;  // the row's column of cells
  int stride;     // words between consecutive words of a column

  __device__ __forceinline__ Row(uint32_t lane, uint32_t* column, int stride_)
      : g(0u), grp(lane), col(column), stride(stride_) {}

  __device__ __forceinline__ Fe2 load(int c) const {
    Fe2 v;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      v.c0.w[k] = col[((c * 2) * NW + k) * stride];
      v.c1.w[k] = col[((c * 2 + 1) * NW + k) * stride];
    }
    return v;
  }

  __device__ __forceinline__ void store(int c, const Fe2& v) const {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      col[((c * 2) * NW + k) * stride] = v.c0.w[k];
      col[((c * 2 + 1) * NW + k) * stride] = v.c1.w[k];
    }
  }

  // whether this lane stores output coefficient j
  __device__ __forceinline__ bool owns(int j) const { return G == 1 || j % G == (int)grp; }

  // orders one phase's stores before the next phase's loads
  __device__ __forceinline__ void sync() const {
    if constexpr (G > 1) {
#ifdef FTS_HOST_CHECK
      fts_host::sync();
#else
      __syncwarp();
#endif
    }
  }
};

// this lane's coefficients of the Fp12 at src (6, 2, 8) into slot `slot`,
// then a barrier
template <int G, int NC>
__device__ __forceinline__ void load_slot(const Row<G, NC>& r, const uint32_t* __restrict__ src,
                                          int slot) {
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    if (!r.owns(j)) continue;
    Fe2 v;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      v.c0.w[k] = __ldg(src + (2 * j) * NW + k);
      v.c1.w[k] = __ldg(src + (2 * j + 1) * NW + k);
    }
    r.store(slot * 6 + j, v);
  }
  r.sync();
}

// this lane's coefficients of slot `slot`, canonical, to the Fp12 at dst;
// nothing when the row is not live (a clamped row past the last)
template <int G, int NC>
__device__ __forceinline__ void store_slot(const Row<G, NC>& r, int slot, uint32_t* __restrict__ dst,
                                           bool live) {
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    if (!live || !r.owns(j)) continue;
    const Fe2 v = r.load(slot * 6 + j);
    const Fe c0 = coop::fe_canon(r.g, v.c0), c1 = coop::fe_canon(r.g, v.c1);
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      dst[(2 * j) * NW + k] = c0.w[k];
      dst[(2 * j + 1) * NW + k] = c1.w[k];
    }
  }
}

// sum of the cells base + j for the set bits j of mask; with conj the odd
// cells enter negated (a conjugated Fp12)
template <int G, int NC>
__device__ __forceinline__ Fe2 cell_sum(const Row<G, NC>& r, int base, uint32_t mask,
                                             bool conj) {
  Fe2 s{coop::fe_zero<1>(), coop::fe_zero<1>()};
  bool first = true;
#pragma unroll 1
  for (int j = 0; j < 6; ++j) {
    if (!((mask >> j) & 1u)) continue;
    Fe2 v = r.load(base + j);
    if (conj && (j & 1)) v = fe2_neg(r.g, v);
    if (first) {
      s = v;
    } else {
      s = coop::fe2_add(r.g, s, v);
    }
    first = false;
  }
  return s;
}

// P[q] = A_q * B_q (or A_q^2) for q < nq, product q by lane q mod G
template <bool SQR, int G, int NC>
__device__ __forceinline__ void products(const Row<G, NC>& r, const uint16_t* desc, int nq,
                                         int a0, int b0, bool conj_b) {
  const int per = (nq + G - 1) / G;
#pragma unroll 1
  for (int i = 0; i < per; ++i) {
    const int q = i * G + (int)r.grp;
    const uint32_t d = desc[q < nq ? q : nq - 1];
    Fe2 a = cell_sum(r, a0, d & 0xffu, false);
    Fe2 p;
    if constexpr (SQR) {
      p = coop::fe2_sqr(r.g, a);
    } else {
      p = coop::fe2_mul(r.g, a, cell_sum(r, b0, d >> 8, conj_b));
    }
    if (q < nq) r.store(r.P + q, p);
  }
  r.sync();
}

// component i of the Fp6 Karatsuba combine of the 6 product cells from
// P0 + at (t0, t1, t2, t12, t01, t02): t0 + XI (t12 - t1 - t2),
// t01 - t0 - t1 + XI t2, t02 - t0 - t2 + t1
template <int G, int NC>
__device__ __forceinline__ Fe2 fp6_coef(const Row<G, NC>& r, int at, int i) {
  const Group& g = r.g;
  const Fe2 t0 = r.load(r.P + at), t1 = r.load(r.P + at + 1),
                 t2 = r.load(r.P + at + 2);
  if (i == 0)
    return coop::fe2_add(g, t0, fe2_mul_xi(g, coop::fe2_sub(g, r.load(r.P + at + 3),
                                                              coop::fe2_add(g, t1, t2))));
  if (i == 1)
    return coop::fe2_add(g, coop::fe2_sub(g, r.load(r.P + at + 4), coop::fe2_add(g, t0, t1)),
                         fe2_mul_xi(g, t2));
  return coop::fe2_add(g, coop::fe2_sub(g, r.load(r.P + at + 5), coop::fe2_add(g, t0, t2)),
                       t1);
}

// ---------------------------------------------------------------- Fp12 ops
// Each op reads slot a (and b) and writes slot dst, which may be either.

// dst = a * b, or a * conj(b)
template <int G, int NC>
__device__ __forceinline__ void op_mul(const Row<G, NC>& r, int dst, int a, int b, bool conj_b) {
  products<false>(r, Q_MUL, 18, a * 6, b * 6, conj_b);
  // c0 = v0 + v v1, c1 = v01 - v0 - v1 (v (x0, x1, x2) = (XI x2, x0, x1)),
  // v0, v1, v01 the Fp6 products at P0, P6, P12: coefficient 2i is
  // v0_i + (v v1)_i, coefficient 2i + 1 is v01_i - v0_i - v1_i
  const Group& g = r.g;
#pragma unroll 1
  for (int j = (int)r.grp; j < 6; j += G) {
    const int i = j >> 1;
    Fe2 out;
    if (j & 1) {
      out = coop::fe2_sub(g, fp6_coef(r, 12, i),
                          coop::fe2_add(g, fp6_coef(r, 0, i), fp6_coef(r, 6, i)));
    } else {
      Fe2 w = fp6_coef(r, 6, i == 0 ? 2 : i - 1);
      if (i == 0) w = fe2_mul_xi(g, w);
      out = coop::fe2_add(g, fp6_coef(r, 0, i), w);
    }
    r.store(dst * 6 + j, out);
  }
  r.sync();
}

// dst = a^2 for a in the cyclotomic subgroup (Granger-Scott)
template <int G, int NC>
__device__ __forceinline__ void op_cyclo_sqr(const Row<G, NC>& r, int dst, int a) {
  products<true>(r, Q_CSQR, 9, a * 6, 0, false);
  // pair p = (c_p, c_p+3): T_even = a^2 + XI b^2, T_odd = (a + b)^2 - a^2 -
  // b^2; coefficient j takes T of pair (0, 2, 1, 0, 2, 1)[j], the odd T
  // for odd j (times XI for j = 1), and is 3 T - 2 c_j (even j) or
  // 3 T + 2 c_j (odd j)
  const Group& g = r.g;
#pragma unroll 1
  for (int j = (int)r.grp; j < 6; j += G) {
    const int p = (j == 1 || j == 4) ? 2 : (j == 2 || j == 5) ? 1 : 0;
    const Fe2 a2 = r.load(r.P + 3 * p), b2 = r.load(r.P + 3 * p + 1);
    Fe2 t;
    if (j & 1) {
      t = coop::fe2_sub(g, coop::fe2_sub(g, r.load(r.P + 3 * p + 2), a2), b2);
      if (j == 1) t = fe2_mul_xi(g, t);
    } else {
      t = coop::fe2_add(g, a2, fe2_mul_xi(g, b2));
    }
    const Fe2 x = r.load(a * 6 + j);
    Fe2 d = (j & 1) ? coop::fe2_add(g, t, x) : coop::fe2_sub(g, t, x);
    d = coop::fe2_dbl(g, d);
    r.store(dst * 6 + j, coop::fe2_add(g, d, t));
  }
  r.sync();
}

// dst = a^(p^n), n = 1, 2, 3: conjugate each coefficient when n is odd,
// then times gamma_j
template <int G, int NC>
__device__ __forceinline__ void op_frobenius(const Row<G, NC>& r, int dst, int a, int n) {
  const int per = (6 + G - 1) / G;
#pragma unroll 1
  for (int i = 0; i < per; ++i) {
    const int j = i * G + (int)r.grp, jj = j < 6 ? j : 5;
    Fe2 x = r.load(a * 6 + jj);
    if (n & 1) x.c1 = coop::fe_sub(r.g, coop::fe_zero<1>(), x.c1);
    Fe2 gam;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      gam.c0.w[k] = FROB_GAMMA[n - 1][jj][0][k];
      gam.c1.w[k] = FROB_GAMMA[n - 1][jj][1][k];
    }
    const Fe2 y = coop::fe2_mul(r.g, x, gam);
    r.sync();  // every read of a before any store: dst may be a
    if (j < 6) r.store(dst * 6 + j, y);
  }
  r.sync();
}

// dst = a, or conj(a) (the odd coefficients negated)
template <int G, int NC>
__device__ __forceinline__ void op_copy(const Row<G, NC>& r, int dst, int a, bool conj) {
#pragma unroll 1
  for (int j = 0; j < 6; ++j) {
    if (!r.owns(j)) continue;
    Fe2 x = r.load(a * 6 + j);
    if (conj && (j & 1)) x = fe2_neg(r.g, x);
    r.store(dst * 6 + j, x);
  }
  r.sync();
}

// dst = a^-1 = (c0 - c1 w) / (c0^2 - v c1^2), as the reference's fp12_inv
template <int G, int NC>
__device__ __forceinline__ void op_inv(const Row<G, NC>& r, int dst, int a) {
  const Group& g = r.g;
  // n = c0^2 - v c1^2: n_j = u_j - (v w)_j for u = c0^2 at P0, w = c1^2 at P6
  products<true>(r, Q_INV1, 12, a * 6, 0, false);
#pragma unroll 1
  for (int j = (int)r.grp; j < 3; j += G) {
    Fe2 w = fp6_coef(r, 6, j == 0 ? 2 : j - 1);
    if (j == 0) w = fe2_mul_xi(g, w);
    r.store(CELL_N + j, coop::fe2_sub(g, fp6_coef(r, 0, j), w));
  }
  r.sync();
  // the Fp6 inverse of n: c = (n0^2 - XI n1 n2, XI n2^2 - n0 n1, n1^2 - n0 n2)
  products<false>(r, Q_INV2, 6, CELL_N, CELL_N, false);
  {
    const Fe2 c[3] = {
        coop::fe2_sub(g, r.load(r.P + 0), fe2_mul_xi(g, r.load(r.P + 3))),
        coop::fe2_sub(g, fe2_mul_xi(g, r.load(r.P + 1)), r.load(r.P + 4)),
        coop::fe2_sub(g, r.load(r.P + 2), r.load(r.P + 5))};
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (r.owns(j)) r.store(CELL_C + j, c[j]);
    r.sync();
  }
  // t = XI (n2 c1 + n1 c2) + n0 c0, and its inverse (one Fermat inverse)
  products<false>(r, Q_INV3, 3, CELL_N, CELL_C, false);
  {
    const Fe2 t = coop::fe2_add(
        g, fe2_mul_xi(g, coop::fe2_add(g, r.load(r.P + 0), r.load(r.P + 1))),
        r.load(r.P + 2));
    const Fe norm =
        coop::fe_add(g, coop::fe_mul(g, t.c0, t.c0), coop::fe_mul(g, t.c1, t.c1));
    const Fe ni = fe_inv(g, norm);
    const Fe2 ti{coop::fe_mul(g, t.c0, ni),
                      coop::fe_sub(g, coop::fe_zero<1>(), coop::fe_mul(g, t.c1, ni))};
    if (r.owns(0)) r.store(CELL_T, ti);
    r.sync();
  }
  // n^-1 = c t^-1
  products<false>(r, Q_INV4, 3, CELL_C, CELL_T, false);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (r.owns(j)) r.store(CELL_NI + j, r.load(r.P + j));
  r.sync();
  // (c0 n^-1, -c1 n^-1)
  products<false>(r, Q_INV5, 12, a * 6, CELL_NI, false);
#pragma unroll 1
  for (int j = (int)r.grp; j < 6; j += G) {
    const Fe2 c = fp6_coef(r, (j & 1) ? 6 : 0, j >> 1);
    r.store(dst * 6 + j, (j & 1) ? fe2_neg(g, c) : c);
  }
  r.sync();
}

}  // namespace gtc
}  // namespace bn254
