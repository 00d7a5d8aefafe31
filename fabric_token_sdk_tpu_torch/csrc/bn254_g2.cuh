// BN254 G2 on the sextic twist, Jacobian coordinates over Fp2.
//
// The formulas and edge-case selects are those of the JAX package's
// fabric_token_sdk_tpu/ops/curve2.py, the G1 ones of bn254_g1.cuh over
// Fp2: `g2_double` is dbl-2009-l (a = 0) and `g2_add` is add-2007-bl,
// with infinity (Z = 0), P == Q and P == -Q handled by selects in the
// reference's order. Every step is the same operation mod p, so the
// canonical (X, Y, Z) of a result equals the reference's.
//
// A point in memory is 48 uint32 words: X, Y, Z, each an Fp2 of two
// 8-word elements (the port's (..., 3, 2, 8) int32 layout). The double
// and the add are FTS_NOINLINE (16 and 59 base products), so a ladder
// step is two calls and not one ~25,000-instruction body.
#pragma once

#include "bn254_tower.cuh"

namespace bn254 {

constexpr int G2_WORDS = 3 * 2 * NW;

struct G2 {
  Fp2 x, y, z;
};

__device__ __forceinline__ G2 g2_infinity() { return G2{fp2_zero(), fp2_zero(), fp2_zero()}; }

__device__ __forceinline__ G2 g2_load(const uint32_t* src) {
  return G2{fp2_load(src), fp2_load(src + 2 * NW), fp2_load(src + 4 * NW)};
}

__device__ __forceinline__ void g2_store_canon(uint32_t* dst, const G2& p) {
  fp2_store_canon(dst, p.x);
  fp2_store_canon(dst + 2 * NW, p.y);
  fp2_store_canon(dst + 4 * NW, p.z);
}

__device__ __forceinline__ G2 g2_select(uint32_t mask, const G2& a, const G2& b) {
  return G2{fp2_select(mask, a.x, b.x), fp2_select(mask, a.y, b.y), fp2_select(mask, a.z, b.z)};
}

// dbl-2009-l (a = 0); Z = 0 and Y = 0 fall out as Z3 = 0 with no select
FTS_NOINLINE __device__ G2 g2_double(const G2& p) {
  Fp2 a = fp2_sqr(p.x);
  Fp2 b = fp2_sqr(p.y);
  Fp2 c = fp2_sqr(b);
  Fp2 d = fp2_sub(fp2_sqr(fp2_add(p.x, b)), fp2_add(a, c));
  d = fp2_dbl(d);
  Fp2 e = fp2_add(fp2_dbl(a), a);
  Fp2 f = fp2_sqr(e);
  Fp2 x3 = fp2_sub(f, fp2_dbl(d));
  Fp2 c8 = fp2_dbl(fp2_dbl(fp2_dbl(c)));
  Fp2 y3 = fp2_sub(fp2_mul(e, fp2_sub(d, x3)), c8);
  Fp2 z3 = fp2_dbl(fp2_mul(p.y, p.z));
  return G2{x3, y3, z3};
}

// add-2007-bl with the reference's selects, in the reference's order:
// P == Q -> double(P); P == -Q -> all-zero infinity; P at infinity -> Q;
// Q at infinity -> P. The doubling is computed every call and selected,
// so no branch depends on the operands (secret on the prove path).
FTS_NOINLINE __device__ G2 g2_add(const G2& p, const G2& q) {
  Fp2 z1z1 = fp2_sqr(p.z);
  Fp2 z2z2 = fp2_sqr(q.z);
  Fp2 u1 = fp2_mul(p.x, z2z2);
  Fp2 u2 = fp2_mul(q.x, z1z1);
  Fp2 s1 = fp2_mul(fp2_mul(p.y, q.z), z2z2);
  Fp2 s2 = fp2_mul(fp2_mul(q.y, p.z), z1z1);
  Fp2 h = fp2_sub(u2, u1);
  Fp2 rr = fp2_dbl(fp2_sub(s2, s1));
  Fp2 i = fp2_sqr(fp2_dbl(h));
  Fp2 j = fp2_mul(h, i);
  Fp2 v = fp2_mul(u1, i);
  Fp2 x3 = fp2_sub(fp2_sqr(rr), fp2_add(j, fp2_dbl(v)));
  Fp2 s1j = fp2_mul(s1, j);
  Fp2 y3 = fp2_sub(fp2_mul(rr, fp2_sub(v, x3)), fp2_dbl(s1j));
  Fp2 z3 = fp2_mul(fp2_sub(fp2_sqr(fp2_add(p.z, q.z)), fp2_add(z1z1, z2z2)), h);
  G2 out{x3, y3, z3};

  uint32_t same_x = fp2_is_zero(h);
  uint32_t same_y = fp2_is_zero(rr);
  uint32_t inf1 = fp2_is_zero(p.z);
  uint32_t inf2 = fp2_is_zero(q.z);
  uint32_t finite = ~inf1 & ~inf2;
  out = g2_select(same_x & same_y & finite, g2_double(p), out);
  out = g2_select(same_x & ~same_y & finite, g2_infinity(), out);
  out = g2_select(inf1, q, out);
  out = g2_select(inf2, p, out);
  return out;
}

}  // namespace bn254
