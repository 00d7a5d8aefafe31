// BN254 G1 in Jacobian coordinates over Fp (Montgomery, [0, 2p) values).
//
// The formulas and edge-case selects are those of the JAX package's
// fabric_token_sdk_tpu/ops/curve.py: `double` is dbl-2009-l (a = 0) and
// `add` is add-2007-bl, with infinity (Z = 0), P == Q and P == -Q
// handled by selects, not branches. Because every step is the same
// operation mod p, the canonical (X, Y, Z) of a result equals the
// reference's, not only the affine point.
//
// A point in memory is 24 uint32 words: X, Y, Z, each 8 little-endian
// words (the port's (..., 3, 8) int32 layout).
#pragma once

#include "bn254_fp.cuh"

namespace bn254 {

constexpr int G1_WORDS = 3 * NW;

struct G1 {
  Fp x, y, z;
};

__device__ __forceinline__ G1 g1_infinity() { return G1{fp_zero(), fp_zero(), fp_zero()}; }

__device__ __forceinline__ G1 g1_load(const uint32_t* src) {
  return G1{fp_load(src), fp_load(src + NW), fp_load(src + 2 * NW)};
}

// stores canonical coordinates
__device__ __forceinline__ void g1_store_canon(uint32_t* dst, const G1& p) {
  fp_store(dst, fp_canon(p.x));
  fp_store(dst + NW, fp_canon(p.y));
  fp_store(dst + 2 * NW, fp_canon(p.z));
}

__device__ __forceinline__ G1 g1_select(uint32_t mask, const G1& a, const G1& b) {
  return G1{fp_select(mask, a.x, b.x), fp_select(mask, a.y, b.y), fp_select(mask, a.z, b.z)};
}

__device__ __forceinline__ G1 g1_neg(const G1& p) { return G1{p.x, fp_neg(p.y), p.z}; }

// dbl-2009-l (a = 0); Z = 0 and Y = 0 fall out as Z3 = 0 with no select
__device__ __forceinline__ G1 g1_double(const G1& p) {
  Fp a = fp_sqr(p.x);
  Fp b = fp_sqr(p.y);
  Fp c = fp_sqr(b);
  Fp d = fp_sub(fp_sqr(fp_add(p.x, b)), fp_add(a, c));
  d = fp_add(d, d);
  Fp e = fp_add(fp_add(a, a), a);
  Fp f = fp_sqr(e);
  Fp x3 = fp_sub(f, fp_add(d, d));
  Fp c8 = fp_add(c, c);
  c8 = fp_add(c8, c8);
  c8 = fp_add(c8, c8);
  Fp y3 = fp_sub(fp_mul(e, fp_sub(d, x3)), c8);
  Fp z3 = fp_mul(fp_add(p.y, p.y), p.z);
  return G1{x3, y3, z3};
}

// add-2007-bl with the reference's selects, in the reference's order:
// P == Q -> double(P); P == -Q -> all-zero infinity; P at infinity -> Q;
// Q at infinity -> P. The doubling is computed every call and selected,
// so the instruction stream does not depend on the operands (secret on
// the prove path: S^r + P^sig_bf).
__device__ __forceinline__ G1 g1_add(const G1& p, const G1& q) {
  Fp z1z1 = fp_sqr(p.z);
  Fp z2z2 = fp_sqr(q.z);
  Fp u1 = fp_mul(p.x, z2z2);
  Fp u2 = fp_mul(q.x, z1z1);
  Fp s1 = fp_mul(fp_mul(p.y, q.z), z2z2);
  Fp s2 = fp_mul(fp_mul(q.y, p.z), z1z1);
  Fp h = fp_sub(u2, u1);
  Fp i = fp_sqr(fp_add(h, h));
  Fp j = fp_mul(h, i);
  Fp rr = fp_sub(s2, s1);
  rr = fp_add(rr, rr);
  Fp v = fp_mul(u1, i);
  Fp x3 = fp_sub(fp_sqr(rr), fp_add(j, fp_add(v, v)));
  Fp s1j = fp_mul(s1, j);
  Fp y3 = fp_sub(fp_mul(rr, fp_sub(v, x3)), fp_add(s1j, s1j));
  Fp z3 = fp_mul(fp_sub(fp_sqr(fp_add(p.z, q.z)), fp_add(z1z1, z2z2)), h);
  G1 out{x3, y3, z3};

  uint32_t same_x = fp_is_zero(h);
  uint32_t same_y = fp_is_zero(rr);
  uint32_t inf1 = fp_is_zero(p.z);
  uint32_t inf2 = fp_is_zero(q.z);
  uint32_t finite = ~inf1 & ~inf2;
  out = g1_select(same_x & same_y & finite, g1_double(p), out);
  out = g1_select(same_x & ~same_y & finite, g1_infinity(), out);
  out = g1_select(inf1, q, out);
  out = g1_select(inf2, p, out);
  return out;
}

}  // namespace bn254
