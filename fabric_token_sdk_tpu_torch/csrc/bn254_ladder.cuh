// The variable-base ladder of g1_mul.cu and g2_mul.cu: a 4-bit fixed
// window over a per-row table, with each row spread over a group of TPI
// lanes of a warp.
//
// Replaces, for those two kernels, the one-thread-a-row bit ladder of
// the JAX package's fabric_token_sdk_tpu/ops/curve.py:scalar_mul and
// ops/curve2.py:scalar_mul (256 steps of double, add and select). Here
// [k]P is computed as:
//
//   T[0] = infinity (all zero), T[1] = P, T[2] = double(P),
//   T[i] = add(T[i-1], P) for i = 3..15, kept in shared memory;
//   acc = T[d63]; then for each window w = 62..0 (MSB first, over the
//   canonical scalar words as given): acc = add(double^4(acc), T[dw]).
//
// Each T[d] is read by a masked scan of all 16 entries (the digit only
// enters the mask, made opaque to the compiler), so no address, branch
// or predicate depends on a digit: the prove path feeds these kernels
// secret scalars. Digit 0 adds the all-zero infinity through add's own
// selects. The formulas and selects are the reference's (ops/curve.py,
// curve2.py: dbl-2009-l; add-2007-bl with P == Q, P == -Q and
// infinity by selects, the doubling always computed), so every result
// is the same group element as the reference's bit ladder, with another
// Jacobian Z. The plain versions (ops/curve.py:window_mul) run this very
// sequence, so the kernels equal them bit for bit.
//
// The cooperative field. A row's Fp element is held by its TPI lanes,
// NL = 8 / TPI little-endian words each (lane r holds words r*NL ..
// r*NL + NL - 1). The Montgomery product is a CIOS over the group: each
// of the 8 outer steps broadcasts b's word and the quotient word m from
// lane 0 (__shfl_sync), every lane multiplies its own words, and the
// shift by one word takes the word 0 of the lane above. A lane's
// overflow stays with it as a small carry word (<= 3) that the next
// step adds at the same weight, so no carry crosses a lane inside the
// loop; the carries are resolved once at the end, one hop up and then a
// carry-lookahead over the group (__ballot_sync of generate and
// propagate bits). Add, sub and canon chain their words with PTX
// add.cc/addc and sub.cc/subc and resolve the carry between lanes by the
// same lookahead; every mask is the same in all lanes of a group. Values
// stay in the redundant domain [0, 2p) of bn254_fp.cuh.
//
// Hazards. Every lane of a warp takes part in every shuffle and ballot
// (full mask): a group past the last row works on a clamped row and
// skips only its store. Built with FTS_HOST_CHECK (g++, no CUDA), a
// group is one lane (TPI = 1, the shuffles identities) or TPI lanes run
// in lockstep as coroutines (host_check.h), so
// tests/test_torch_csrc_host.py runs the window, the table, the masked
// read, the formulas and the carries between lanes on the CPU.
#pragma once

#include "bn254_fp.cuh"

namespace bn254 {
namespace coop {

constexpr int WINDOWS = 64;  // 4-bit windows of a 256-bit scalar
constexpr int DIGITS = 16;   // table entries

#ifndef FTS_HOST_CHECK
// Every shuffle and ballot names the whole warp: all its lanes run the
// same path. (Naming only a group's own lanes made the ladders ~6x
// slower on the H100, chip_smoke.py's [ladder] line.)
constexpr uint32_t FULL = 0xffffffffu;
#endif

// Hides a value from the optimiser, so that a mask stays AND/OR
// arithmetic and is never turned into a predicated load or a branch.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// An Fp element: this lane's NL words of it.
template <int NL>
struct Fe {
  uint32_t w[NL];
};

// The TPI lanes of one row: rank, and this lane's words of p and 2p.
template <int TPI>
struct Group {
  static_assert(TPI == 1 || TPI == 2 || TPI == 4 || TPI == 8, "TPI must divide 8");
  static constexpr int NL = NW / TPI;
  uint32_t lane;   // rank in the group
  uint32_t first;  // warp lane of rank 0
  uint32_t p[NL], p2[NL];

  __device__ __forceinline__ explicit Group(uint32_t warp_lane)
      : lane(warp_lane % TPI), first(warp_lane - warp_lane % TPI) {
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      p[k] = FP_P[lane * NL + k];
      p2[k] = FP_2P[lane * NL + k];
    }
  }

  // v of rank src
  __device__ __forceinline__ uint32_t shfl(uint32_t v, int src) const {
    if constexpr (TPI == 1) return v;
#ifdef FTS_HOST_CHECK
    uint32_t all[TPI];
    fts_host::exchange(v, all);
    return all[src];
#else
    return __shfl_sync(FULL, v, src, TPI);
#endif
  }

  // v of rank lane + 1; 0 in the top lane
  __device__ __forceinline__ uint32_t from_above(uint32_t v) const {
    if constexpr (TPI == 1) return 0u;
#ifdef FTS_HOST_CHECK
    uint32_t x = shfl(v, lane == TPI - 1 ? lane : lane + 1);
#else
    uint32_t x = __shfl_down_sync(FULL, v, 1, TPI);
#endif
    return lane == TPI - 1 ? 0u : x;
  }

  // v of rank lane - 1; 0 in rank 0
  __device__ __forceinline__ uint32_t from_below(uint32_t v) const {
    if constexpr (TPI == 1) return 0u;
#ifdef FTS_HOST_CHECK
    uint32_t x = shfl(v, lane == 0 ? 0 : lane - 1);
#else
    uint32_t x = __shfl_up_sync(FULL, v, 1, TPI);
#endif
    return lane == 0 ? 0u : x;
  }

  // bit r set when pred is non-zero in rank r
  __device__ __forceinline__ uint32_t ballot(uint32_t pred) const {
    if constexpr (TPI == 1) return pred ? 1u : 0u;
#ifdef FTS_HOST_CHECK
    uint32_t all[TPI], bits = 0u;
    fts_host::exchange(pred, all);
    for (int r = 0; r < TPI; ++r) bits |= (all[r] ? 1u : 0u) << r;
    return bits;
#else
    return (__ballot_sync(FULL, pred != 0u) >> first) & ((1u << TPI) - 1u);
#endif
  }

  // Carry-lookahead over the group. Each lane has a carry (or borrow)
  // out of its own words, `gen`, and `prop` when a carry in would pass
  // straight through them (never both). Returns the carry into this
  // lane; `out` is the carry out of the top lane, the same in every lane.
  __device__ __forceinline__ uint32_t lookahead(uint32_t gen, uint32_t prop, uint32_t& out) const {
    uint32_t g = ballot(gen), b = g | ballot(prop);
    uint32_t s = g + b;  // a sum whose per-bit carries are the lanes' carries in
    out = (s >> TPI) & 1u;
    return ((s ^ g ^ b) >> lane) & 1u;
  }
};

// ---------------------------------------------------------------- lane words

// r = a + b over N words; returns the carry out
template <int N>
__device__ __forceinline__ uint32_t add_n(uint32_t* r, const uint32_t* a, const uint32_t* b) {
#ifdef FTS_HOST_CHECK
  uint64_t c = 0u;
  for (int i = 0; i < N; ++i) {
    c = (uint64_t)a[i] + b[i] + (c >> 32);
    r[i] = (uint32_t)c;
  }
  return (uint32_t)(c >> 32);
#else
  uint32_t c;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r[0]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
  for (int i = 1; i < N; ++i)
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r[i]) : "r"(a[i]), "r"(b[i]));
  asm volatile("addc.u32 %0, 0, 0;" : "=r"(c));
  return c;
#endif
}

// r = a - b over N words; returns the borrow out
template <int N>
__device__ __forceinline__ uint32_t sub_n(uint32_t* r, const uint32_t* a, const uint32_t* b) {
#ifdef FTS_HOST_CHECK
  uint32_t borrow = 0u;
  for (int i = 0; i < N; ++i) {
    uint64_t d = (uint64_t)a[i] - b[i] - borrow;
    r[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 32) & 1u;
  }
  return borrow;
#else
  uint32_t c;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r[0]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
  for (int i = 1; i < N; ++i)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r[i]) : "r"(a[i]), "r"(b[i]));
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(c));
  return c & 1u;  // 0 or all ones
#endif
}

// r += c (a small value) over N words; returns the carry out
template <int N>
__device__ __forceinline__ uint32_t add_small(uint32_t* r, uint32_t c) {
#ifdef FTS_HOST_CHECK
  uint64_t s = c;
  for (int i = 0; i < N; ++i) {
    s = (uint64_t)r[i] + (s >> (i ? 32 : 0));
    r[i] = (uint32_t)s;
  }
  return (uint32_t)(s >> 32);
#else
  uint32_t out;
  asm volatile("add.cc.u32 %0, %0, %1;" : "+r"(r[0]) : "r"(c));
#pragma unroll
  for (int i = 1; i < N; ++i) asm volatile("addc.cc.u32 %0, %0, 0;" : "+r"(r[i]));
  asm volatile("addc.u32 %0, 0, 0;" : "=r"(out));
  return out;
#endif
}

// r -= c (0 or 1) over N words
template <int N>
__device__ __forceinline__ void sub_small(uint32_t* r, uint32_t c) {
#ifdef FTS_HOST_CHECK
  uint32_t borrow = c;
  for (int i = 0; i < N; ++i) {
    uint64_t d = (uint64_t)r[i] - borrow;
    r[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 32) & 1u;
  }
#else
  asm volatile("sub.cc.u32 %0, %0, %1;" : "+r"(r[0]) : "r"(c));
#pragma unroll
  for (int i = 1; i < N; ++i) asm volatile("subc.cc.u32 %0, %0, 0;" : "+r"(r[i]));
#endif
}

template <int N>
__device__ __forceinline__ uint32_t all_ones(const uint32_t* r) {
  uint32_t acc = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < N; ++i) acc &= r[i];
  return (uint32_t)(acc == 0xffffffffu);
}

template <int N>
__device__ __forceinline__ uint32_t all_zero(const uint32_t* r) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) acc |= r[i];
  return (uint32_t)(acc == 0u);
}

// ---------------------------------------------------------------- cooperative Fp

template <int TPI>
using FeT = Fe<Group<TPI>::NL>;

template <int TPI>
__device__ __forceinline__ FeT<TPI> fe_zero() {
  FeT<TPI> r;
#pragma unroll
  for (int k = 0; k < Group<TPI>::NL; ++k) r.w[k] = 0u;
  return r;
}

// mask is all ones or all zeros: mask ? a : b
template <int NL>
__device__ __forceinline__ Fe<NL> fe_select(uint32_t mask, const Fe<NL>& a, const Fe<NL>& b) {
  Fe<NL> r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.w[k] = (a.w[k] & mask) | (b.w[k] & ~mask);
  return r;
}

// a + b over the whole element; returns the carry out of it
template <int TPI>
__device__ __forceinline__ uint32_t add_words(const Group<TPI>& g, FeT<TPI>& r, const uint32_t* a,
                                              const uint32_t* b) {
  constexpr int NL = Group<TPI>::NL;
  uint32_t gen = add_n<NL>(r.w, a, b);
  if constexpr (TPI == 1) return gen;
  uint32_t out, cin = g.lookahead(gen, all_ones<NL>(r.w), out);
  add_small<NL>(r.w, cin);
  return out;
}

// a - b over the whole element; returns the borrow out of it
template <int TPI>
__device__ __forceinline__ uint32_t sub_words(const Group<TPI>& g, FeT<TPI>& r, const uint32_t* a,
                                              const uint32_t* b) {
  constexpr int NL = Group<TPI>::NL;
  uint32_t gen = sub_n<NL>(r.w, a, b);
  if constexpr (TPI == 1) return gen;
  uint32_t out, bin = g.lookahead(gen, all_zero<NL>(r.w), out);
  sub_small<NL>(r.w, bin);
  return out;
}

// a - m if a >= m else a
template <int TPI>
__device__ __forceinline__ FeT<TPI> fe_select_sub(const Group<TPI>& g, const FeT<TPI>& a,
                                                  const uint32_t* m) {
  FeT<TPI> d;
  uint32_t borrow = sub_words(g, d, a.w, m);
  return fe_select(0u - borrow, a, d);
}

// [0, 2p) -> [0, p)
template <int TPI>
__device__ __forceinline__ FeT<TPI> fe_canon(const Group<TPI>& g, const FeT<TPI>& a) {
  return fe_select_sub(g, a, g.p);
}

// all ones when a represents 0 (a is 0 or p), else 0
template <int TPI>
__device__ __forceinline__ uint32_t fe_is_zero(const Group<TPI>& g, const FeT<TPI>& a) {
  FeT<TPI> c = fe_canon(g, a);
  return 0u - (uint32_t)(g.ballot(1u - all_zero<Group<TPI>::NL>(c.w)) == 0u);
}

// [0, 2p) + [0, 2p) -> [0, 2p)
template <int TPI>
__device__ __forceinline__ FeT<TPI> fe_add(const Group<TPI>& g, const FeT<TPI>& a,
                                           const FeT<TPI>& b) {
  FeT<TPI> s;
  add_words(g, s, a.w, b.w);  // below 4p < 2^256: no carry out
  return fe_select_sub(g, s, g.p2);
}

// a - b in [0, 2p): subtract, add 2p back on borrow (mod 2^256)
template <int TPI>
__device__ __forceinline__ FeT<TPI> fe_sub(const Group<TPI>& g, const FeT<TPI>& a,
                                           const FeT<TPI>& b) {
  constexpr int NL = Group<TPI>::NL;
  FeT<TPI> d;
  uint32_t mask = 0u - sub_words(g, d, a.w, b.w);
  uint32_t m[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) m[k] = g.p2[k] & mask;
  add_words(g, d, d.w, m);
  return d;
}

// Montgomery product a*b/2^256 mod p by a CIOS over the group; for a,
// b < 2p the result is below 2p, as bn254_fp.cuh's fp_mul.
//
// State: this lane's words t and a carry word c at the weight of the
// next lane's word 0. Outer step i adds a * b[i] + m * p (m from lane
// 0's word 0, the exact low word of the sum) and divides by 2^32: each
// lane's word 0 moves to the top word of the lane below, and a lane's
// own overflow (`top`, at most 2^33 + 1) lands in its own top word
// there, its excess in c (at most 3).
template <int TPI>
__device__ __forceinline__ FeT<TPI> fe_mul(const Group<TPI>& g, const FeT<TPI>& a,
                                           const FeT<TPI>& b) {
  constexpr int NL = Group<TPI>::NL;
  uint32_t t[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) t[k] = 0u;
  uint32_t c = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi = g.shfl(b.w[i % NL], i / NL);
    const uint32_t m = g.shfl((t[0] + a.w[0] * bi) * FP_PINV, 0);
    uint64_t c1 = 0u, c2 = 0u;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      c1 = (uint64_t)a.w[j] * bi + t[j] + (c1 >> 32);
      c2 = (uint64_t)m * g.p[j] + (uint32_t)c1 + (c2 >> 32);
      t[j] = (uint32_t)c2;
    }
    const uint64_t top = (uint64_t)c + (c1 >> 32) + (c2 >> 32);
    const uint32_t above = g.from_above(t[0]);
#pragma unroll
    for (int j = 0; j + 1 < NL; ++j) t[j] = t[j + 1];
    const uint64_t s = (uint64_t)above + (uint32_t)top;
    t[NL - 1] = (uint32_t)s;
    c = (uint32_t)(s >> 32) + (uint32_t)(top >> 32);
  }
  if constexpr (TPI > 1) {
    // one hop up, then the lookahead: the result is below 2^256, so
    // nothing is carried out of the top lane
    uint32_t gen = add_small<NL>(t, g.from_below(c)), out;
    add_small<NL>(t, g.lookahead(gen, all_ones<NL>(t), out));
  }
  FeT<TPI> r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.w[k] = t[k];
  return r;
}

// ---------------------------------------------------------------- cooperative Fp2

template <int TPI>
struct Fe2 {
  FeT<TPI> c0, c1;
};

template <int TPI>
__device__ __forceinline__ Fe2<TPI> fe2_add(const Group<TPI>& g, const Fe2<TPI>& a,
                                            const Fe2<TPI>& b) {
  return Fe2<TPI>{fe_add(g, a.c0, b.c0), fe_add(g, a.c1, b.c1)};
}

template <int TPI>
__device__ __forceinline__ Fe2<TPI> fe2_sub(const Group<TPI>& g, const Fe2<TPI>& a,
                                            const Fe2<TPI>& b) {
  return Fe2<TPI>{fe_sub(g, a.c0, b.c0), fe_sub(g, a.c1, b.c1)};
}

template <int TPI>
__device__ __forceinline__ Fe2<TPI> fe2_dbl(const Group<TPI>& g, const Fe2<TPI>& a) {
  return fe2_add(g, a, a);
}

// Karatsuba, as bn254_tower.cuh's fp2_mul: 3 base products
template <int TPI>
__device__ __forceinline__ Fe2<TPI> fe2_mul(const Group<TPI>& g, const Fe2<TPI>& a,
                                            const Fe2<TPI>& b) {
  FeT<TPI> v0 = fe_mul(g, a.c0, b.c0);
  FeT<TPI> v1 = fe_mul(g, a.c1, b.c1);
  FeT<TPI> v01 = fe_mul(g, fe_add(g, a.c0, a.c1), fe_add(g, b.c0, b.c1));
  return Fe2<TPI>{fe_sub(g, v0, v1), fe_sub(g, v01, fe_add(g, v0, v1))};
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 i: 2 base products
template <int TPI>
__device__ __forceinline__ Fe2<TPI> fe2_sqr(const Group<TPI>& g, const Fe2<TPI>& a) {
  FeT<TPI> t = fe_mul(g, a.c0, a.c1);
  return Fe2<TPI>{fe_mul(g, fe_add(g, a.c0, a.c1), fe_sub(g, a.c0, a.c1)), fe_add(g, t, t)};
}

template <int TPI>
__device__ __forceinline__ uint32_t fe2_is_zero(const Group<TPI>& g, const Fe2<TPI>& a) {
  return fe_is_zero(g, a.c0) & fe_is_zero(g, a.c1);
}

// ---------------------------------------------------------------- points

// A Jacobian point as E field elements (G1: X, Y, Z; G2: X0, X1, Y0, Y1,
// Z0, Z1), this lane's words of each.
template <int TPI, int E>
struct Pt {
  FeT<TPI> e[E];
};

template <int TPI, int E>
__device__ __forceinline__ Pt<TPI, E> pt_select(uint32_t mask, const Pt<TPI, E>& a,
                                                const Pt<TPI, E>& b) {
  Pt<TPI, E> r;
#pragma unroll
  for (int f = 0; f < E; ++f) r.e[f] = fe_select(mask, a.e[f], b.e[f]);
  return r;
}

template <int TPI, int E>
__device__ __forceinline__ Pt<TPI, E> pt_zero() {
  Pt<TPI, E> r;
#pragma unroll
  for (int f = 0; f < E; ++f) r.e[f] = fe_zero<TPI>();
  return r;
}

// G1 (E = 3): the reference's formulas over the cooperative field (also
// g1_addsub.cu's row).
template <int TPI>
struct CurveG1 {
  static constexpr int E = 3;
  using P = Pt<TPI, 3>;

  // dbl-2009-l (a = 0)
  static __device__ __forceinline__ P dbl(const Group<TPI>& g, const P& p) {
    const FeT<TPI>&x = p.e[0], &y = p.e[1], &z = p.e[2];
    FeT<TPI> a = fe_mul(g, x, x);
    FeT<TPI> b = fe_mul(g, y, y);
    FeT<TPI> c = fe_mul(g, b, b);
    FeT<TPI> xb = fe_add(g, x, b);
    FeT<TPI> d = fe_sub(g, fe_mul(g, xb, xb), fe_add(g, a, c));
    d = fe_add(g, d, d);
    FeT<TPI> e = fe_add(g, fe_add(g, a, a), a);
    FeT<TPI> f = fe_mul(g, e, e);
    P r;
    r.e[0] = fe_sub(g, f, fe_add(g, d, d));
    FeT<TPI> c8 = fe_add(g, c, c);
    c8 = fe_add(g, c8, c8);
    c8 = fe_add(g, c8, c8);
    r.e[1] = fe_sub(g, fe_mul(g, e, fe_sub(g, d, r.e[0])), c8);
    r.e[2] = fe_mul(g, fe_add(g, y, y), z);
    return r;
  }

  // add-2007-bl with the reference's selects in its order
  static __device__ __forceinline__ P add(const Group<TPI>& g, const P& p, const P& q) {
    FeT<TPI> z1z1 = fe_mul(g, p.e[2], p.e[2]);
    FeT<TPI> z2z2 = fe_mul(g, q.e[2], q.e[2]);
    FeT<TPI> u1 = fe_mul(g, p.e[0], z2z2);
    FeT<TPI> u2 = fe_mul(g, q.e[0], z1z1);
    FeT<TPI> s1 = fe_mul(g, fe_mul(g, p.e[1], q.e[2]), z2z2);
    FeT<TPI> s2 = fe_mul(g, fe_mul(g, q.e[1], p.e[2]), z1z1);
    FeT<TPI> h = fe_sub(g, u2, u1);
    FeT<TPI> hh = fe_add(g, h, h);
    FeT<TPI> i = fe_mul(g, hh, hh);
    FeT<TPI> j = fe_mul(g, h, i);
    FeT<TPI> rr = fe_sub(g, s2, s1);
    rr = fe_add(g, rr, rr);
    FeT<TPI> v = fe_mul(g, u1, i);
    P out;
    out.e[0] = fe_sub(g, fe_mul(g, rr, rr), fe_add(g, j, fe_add(g, v, v)));
    FeT<TPI> s1j = fe_mul(g, s1, j);
    out.e[1] = fe_sub(g, fe_mul(g, rr, fe_sub(g, v, out.e[0])), fe_add(g, s1j, s1j));
    FeT<TPI> zs = fe_add(g, p.e[2], q.e[2]);
    out.e[2] = fe_mul(g, fe_sub(g, fe_mul(g, zs, zs), fe_add(g, z1z1, z2z2)), h);

    // opaque: masks, never predicates the compiler could make of them
    uint32_t same_x = opaque(fe_is_zero(g, h));
    uint32_t same_y = opaque(fe_is_zero(g, rr));
    uint32_t inf1 = opaque(fe_is_zero(g, p.e[2]));
    uint32_t inf2 = opaque(fe_is_zero(g, q.e[2]));
    uint32_t finite = ~inf1 & ~inf2;
    out = pt_select(same_x & same_y & finite, dbl(g, p), out);
    out = pt_select(same_x & ~same_y & finite, pt_zero<TPI, 3>(), out);
    out = pt_select(inf1, q, out);
    out = pt_select(inf2, p, out);
    return out;
  }
};

// G2 (E = 6): the reference's formulas over the cooperative Fp2,
// inlined (a lane holds 12 words of a point at TPI = 4).
template <int TPI>
struct CurveG2 {
  static constexpr int E = 6;
  using P = Pt<TPI, 6>;

  static __device__ __forceinline__ Fe2<TPI> get(const P& p, int c) {
    return Fe2<TPI>{p.e[2 * c], p.e[2 * c + 1]};
  }
  static __device__ __forceinline__ P make(const Fe2<TPI>& x, const Fe2<TPI>& y,
                                           const Fe2<TPI>& z) {
    P r;
    r.e[0] = x.c0, r.e[1] = x.c1, r.e[2] = y.c0, r.e[3] = y.c1, r.e[4] = z.c0, r.e[5] = z.c1;
    return r;
  }

  // dbl-2009-l (a = 0)
  static __device__ __forceinline__ P dbl(const Group<TPI>& g, const P& p) {
    Fe2<TPI> x = get(p, 0), y = get(p, 1), z = get(p, 2);
    Fe2<TPI> a = fe2_sqr(g, x);
    Fe2<TPI> b = fe2_sqr(g, y);
    Fe2<TPI> c = fe2_sqr(g, b);
    Fe2<TPI> d = fe2_sub(g, fe2_sqr(g, fe2_add(g, x, b)), fe2_add(g, a, c));
    d = fe2_dbl(g, d);
    Fe2<TPI> e = fe2_add(g, fe2_dbl(g, a), a);
    Fe2<TPI> f = fe2_sqr(g, e);
    Fe2<TPI> x3 = fe2_sub(g, f, fe2_dbl(g, d));
    Fe2<TPI> c8 = fe2_dbl(g, fe2_dbl(g, fe2_dbl(g, c)));
    Fe2<TPI> y3 = fe2_sub(g, fe2_mul(g, e, fe2_sub(g, d, x3)), c8);
    Fe2<TPI> z3 = fe2_dbl(g, fe2_mul(g, y, z));
    return make(x3, y3, z3);
  }

  // add-2007-bl with the reference's selects in its order
  static __device__ __forceinline__ P add(const Group<TPI>& g, const P& p, const P& q) {
    Fe2<TPI> x1 = get(p, 0), y1 = get(p, 1), z1 = get(p, 2);
    Fe2<TPI> x2 = get(q, 0), y2 = get(q, 1), z2 = get(q, 2);
    Fe2<TPI> z1z1 = fe2_sqr(g, z1);
    Fe2<TPI> z2z2 = fe2_sqr(g, z2);
    Fe2<TPI> u1 = fe2_mul(g, x1, z2z2);
    Fe2<TPI> u2 = fe2_mul(g, x2, z1z1);
    Fe2<TPI> s1 = fe2_mul(g, fe2_mul(g, y1, z2), z2z2);
    Fe2<TPI> s2 = fe2_mul(g, fe2_mul(g, y2, z1), z1z1);
    Fe2<TPI> h = fe2_sub(g, u2, u1);
    Fe2<TPI> rr = fe2_dbl(g, fe2_sub(g, s2, s1));
    Fe2<TPI> i = fe2_sqr(g, fe2_dbl(g, h));
    Fe2<TPI> j = fe2_mul(g, h, i);
    Fe2<TPI> v = fe2_mul(g, u1, i);
    Fe2<TPI> x3 = fe2_sub(g, fe2_sqr(g, rr), fe2_add(g, j, fe2_dbl(g, v)));
    Fe2<TPI> s1j = fe2_mul(g, s1, j);
    Fe2<TPI> y3 = fe2_sub(g, fe2_mul(g, rr, fe2_sub(g, v, x3)), fe2_dbl(g, s1j));
    Fe2<TPI> z3 = fe2_mul(
        g, fe2_sub(g, fe2_sqr(g, fe2_add(g, z1, z2)), fe2_add(g, z1z1, z2z2)), h);
    P out = make(x3, y3, z3);

    uint32_t same_x = opaque(fe2_is_zero(g, h));
    uint32_t same_y = opaque(fe2_is_zero(g, rr));
    uint32_t inf1 = opaque(fe2_is_zero(g, z1));
    uint32_t inf2 = opaque(fe2_is_zero(g, z2));
    uint32_t finite = ~inf1 & ~inf2;
    out = pt_select(same_x & same_y & finite, dbl(g, p), out);
    out = pt_select(same_x & ~same_y & finite, pt_zero<TPI, 6>(), out);
    out = pt_select(inf1, q, out);
    out = pt_select(inf2, p, out);
    return out;
  }
};

// ---------------------------------------------------------------- the ladder

// The table is this thread's column of a block-wide array: word k of
// element f of entry d at ((d * E + f) * NL + k) * stride, where stride
// is the block's thread count and `tab` points at this thread's first
// word. A warp's 32 threads touch 32 consecutive words: no bank
// conflict; and a thread reads only what it wrote: no barrier.
template <int TPI, int E>
__device__ __forceinline__ void table_put(uint32_t* tab, int stride, int d, const Pt<TPI, E>& p) {
  constexpr int NL = Group<TPI>::NL;
#pragma unroll
  for (int f = 0; f < E; ++f)
#pragma unroll
    for (int k = 0; k < NL; ++k) tab[((d * E + f) * NL + k) * stride] = p.e[f].w[k];
}

// T[digit] by a masked scan of all 16 entries: the same loads, in the
// same order, whatever the digit.
template <int TPI, int E>
__device__ __forceinline__ Pt<TPI, E> table_pick(const uint32_t* tab, int stride, uint32_t digit) {
  constexpr int NL = Group<TPI>::NL;
  Pt<TPI, E> r = pt_zero<TPI, E>();
#pragma unroll 1
  for (uint32_t d = 0; d < (uint32_t)DIGITS; ++d) {
    const uint32_t mask = opaque(0u - (uint32_t)(d == digit));
#pragma unroll
    for (int f = 0; f < E; ++f)
#pragma unroll
      for (int k = 0; k < NL; ++k) r.e[f].w[k] |= tab[((d * E + f) * NL + k) * stride] & mask;
  }
  return r;
}

// [k]P for one row, by this lane of its group. `points` rows are E * 8
// words (the element f of a row at f * 8), `scalars` rows 8 canonical
// words, read as given. `live` is false for a group past the last row:
// it runs (every lane takes part in every shuffle) and stores nothing.
template <class Curve, int TPI>
__device__ __forceinline__ void ladder_row(const Group<TPI>& g,
                                           const uint32_t* __restrict__ points,
                                           const uint32_t* __restrict__ scalars,
                                           uint32_t* __restrict__ out, int row, bool live,
                                           uint32_t* tab, int stride) {
  constexpr int E = Curve::E, NL = Group<TPI>::NL;
  using P = Pt<TPI, E>;
  P p;
  const uint32_t* src = points + (size_t)row * E * NW + g.lane * NL;
#pragma unroll
  for (int f = 0; f < E; ++f)
#pragma unroll
    for (int k = 0; k < NL; ++k) p.e[f].w[k] = __ldg(src + f * NW + k);

  table_put<TPI, E>(tab, stride, 0, pt_zero<TPI, E>());
  table_put<TPI, E>(tab, stride, 1, p);
  P acc = Curve::dbl(g, p);
  table_put<TPI, E>(tab, stride, 2, acc);

  // One loop of additions, so that the addition is compiled once (a G2
  // addition inlined is ~10^4 instructions): steps 3..15 extend the
  // table, T[s] = T[s-1] + P; each later step is a window w = 62..0,
  // acc = double^4(acc) + T[digit], acc starting at T[d63].
  const uint32_t* k = scalars + (size_t)row * NW;
#pragma unroll 1
  for (int s = 3; s < DIGITS + WINDOWS - 1; ++s) {
    P b = p;
    if (s >= DIGITS) {
      const int w = DIGITS + WINDOWS - 2 - s;
      if (w == WINDOWS - 2) acc = table_pick<TPI, E>(tab, stride, __ldg(k + NW - 1) >> 28);
#pragma unroll 1
      for (int d = 0; d < 4; ++d) acc = Curve::dbl(g, acc);
      b = table_pick<TPI, E>(tab, stride, (__ldg(k + (w >> 3)) >> (4 * (w & 7))) & 15u);
    }
    acc = Curve::add(g, acc, b);
    if (s < DIGITS) table_put<TPI, E>(tab, stride, s, acc);
  }

  if (live) {
    uint32_t* dst = out + (size_t)row * E * NW + g.lane * NL;
#pragma unroll
    for (int f = 0; f < E; ++f) {
      FeT<TPI> c = fe_canon(g, acc.e[f]);
#pragma unroll
      for (int k2 = 0; k2 < NL; ++k2) dst[f * NW + k2] = c.w[k2];
    }
  }
}

#ifdef FTS_HOST_CHECK
// The host check's loops over rows: one lane a row at TPI = 1 (the
// shuffles are identities), or an emulated group of TPI lanes
// (host_check.h) that exchange values where the card shuffles.
template <class F>
void host_group(int tpi, F& body) {  // body(lane) for every lane of a group, in lockstep
  if (tpi == 1) return body(0);
  fts_host::run_group(tpi, [](int lane, void* f) { (*static_cast<F*>(f))(lane); }, &body);
}

template <template <int> class Curve, int TPI>
void host_rows(const uint32_t* points, const uint32_t* scalars, uint32_t* out, int n) {
  for (int row = 0; row < n; ++row) {
    auto body = [&](int lane) {
      const Group<TPI> g((uint32_t)lane);
      std::vector<uint32_t> tab(DIGITS * Curve<TPI>::E * NW);
      ladder_row<Curve<TPI>, TPI>(g, points, scalars, out, row, true, tab.data(), 1);
    };
    host_group(TPI, body);
  }
}

template <template <int> class Curve>
void host_ladder(const uint32_t* points, const uint32_t* scalars, uint32_t* out, int n,
                 int tpi) {
  switch (tpi) {
    case 2: return host_rows<Curve, 2>(points, scalars, out, n);
    case 4: return host_rows<Curve, 4>(points, scalars, out, n);
    case 8: return host_rows<Curve, 8>(points, scalars, out, n);
    default: return host_rows<Curve, 1>(points, scalars, out, n);
  }
}

// The cooperative field alone, a row of (a, b) words in [0, 2p): out
// rows (4, 8) hold canonical a*b, a+b, a-b and the is_zero mask of a in
// every word; lets the host check drive edge values (words of all ones
// or all zeros, so that carries cross lanes) through the lookahead.
template <int TPI>
void host_field_rows(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  constexpr int NL = Group<TPI>::NL;
  for (int row = 0; row < n; ++row) {
    auto body = [&](int lane) {
      const Group<TPI> g((uint32_t)lane);
      FeT<TPI> x, y;
      for (int k = 0; k < NL; ++k) {
        x.w[k] = a[row * NW + lane * NL + k];
        y.w[k] = b[row * NW + lane * NL + k];
      }
      const FeT<TPI> r[3] = {fe_mul(g, x, y), fe_add(g, x, y), fe_sub(g, x, y)};
      const uint32_t zero = fe_is_zero(g, x);
      uint32_t* o = out + row * 4 * NW + lane * NL;
      for (int f = 0; f < 3; ++f) {
        FeT<TPI> c = fe_canon(g, r[f]);
        for (int k = 0; k < NL; ++k) o[f * NW + k] = c.w[k];
      }
      for (int k = 0; k < NL; ++k) o[3 * NW + k] = zero;
    };
    host_group(TPI, body);
  }
}

inline void host_field(const uint32_t* a, const uint32_t* b, uint32_t* out, int n, int tpi) {
  switch (tpi) {
    case 2: return host_field_rows<2>(a, b, out, n);
    case 4: return host_field_rows<4>(a, b, out, n);
    case 8: return host_field_rows<8>(a, b, out, n);
    default: return host_field_rows<1>(a, b, out, n);
  }
}
#endif

}  // namespace coop
}  // namespace bn254

#ifndef FTS_HOST_CHECK
#include <cuda_runtime.h>

namespace bn254 {
namespace coop {

// One launch of the ladder kernel `kernel` over n rows: blocks of
// THREADS threads (THREADS / TPI rows each), the tables in dynamic
// shared memory, raised above the 48 KB default where a block needs it.
template <int TPI, int E, int THREADS>
inline int launch_ladder(void (*kernel)(const uint32_t*, const uint32_t*, uint32_t*, int),
                         const void* points, const void* scalars, void* out, int n,
                         void* stream) {
  static_assert(THREADS % 32 == 0 && THREADS % TPI == 0, "whole warps, whole groups");
  if (n <= 0) return 0;
  constexpr int rows_per_block = THREADS / TPI;
  constexpr size_t smem = (size_t)THREADS * DIGITS * E * Group<TPI>::NL * 4;  // 16 entries a row
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = (n + rows_per_block - 1) / rows_per_block;
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)points, (const uint32_t*)scalars, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace coop
}  // namespace bn254
#endif
