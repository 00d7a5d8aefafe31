// Constant-time inversion in the BN254 base field, for the to-affine
// kernels (g1_to_affine.cu, g2_to_affine.cu), one row a lane.
//
// Replaces, for those kernels, bn254_fp.cuh:fp_inv (and the JAX
// package's FieldSpec.inv, fabric_token_sdk_tpu/ops/field.py): a
// square-and-multiply over p - 2 that computes the product on every one
// of its 254 steps, 508 dependent CIOS products a row.
//
// Bernstein and Yang's constant-time gcd ("Fast constant-time gcd
// computation and modular inversion", 2019) in the shape of
// libsecp256k1's modinv32: signed 30-bit limbs (9 for 270 bits) in
// int32, Wuille's half-delta divsteps in batches of 30 on the low limbs,
// each batch a 2x2 transition matrix applied to (f, g) and, modulo p, to
// (d, e) with int64 accumulators. A FIXED count of 20 batches, 600
// divsteps, covers the proven bound of 590 for moduli below 2^256, so
// the iteration count never depends on the value. The gcd gives the
// integer inverse of the Montgomery word a = zR, that is z^-1 R^-1; one
// product by R^3 mod p makes it z^-1 R. The divsteps are 32-bit integer
// work (the card multiplies 32 x 32 -> 64 bits natively: IMAD.WIDE),
// about 15 instructions a divstep.
//
// It takes a in [0, 2p) (the redundant domain of bn254_fp.cuh) and maps
// 0 and p to 0; the result lies in [0, 2p) and the callers canonicalise.
//
// Constant time: the value enters only masks (all ones or all zeros,
// made opaque to the optimiser by coop::opaque), never a branch, a
// predicate or an address; every loop count is fixed. The prove path
// feeds g2_to_affine points whose Z derives from secrets.
#pragma once

#include "bn254_ladder.cuh"

namespace bn254 {
namespace inv {

constexpr int LIMBS = 9;                 // signed 30-bit limbs
constexpr int32_t M30 = 0x3fffffff;
constexpr int BATCHES = 20;              // of STEPS divsteps: 600 >= 590
constexpr int STEPS = 30;
constexpr uint32_t P_INV30 = 0x1b799c77u;  // p^-1 mod 2^30

// p in signed 30-bit limbs
static __device__ __constant__ int32_t P30[LIMBS] = {
    0x187cfd47, 0x3082305b, 0x071ca8d3, 0x205aa45a, 0x01585d97,
    0x0116da06, 0x1a029b85, 0x139cb84c, 0x00003064};
// R^3 mod p (little-endian words): d z^-1 R^-1 -> z^-1 R
static __device__ __constant__ uint32_t FP_R3[NW] = {
    0xda1530dfu, 0xb1cd6dafu, 0xa7283db6u, 0x62f210e6u,
    0x0ada0afbu, 0xef7f0b0cu, 0x2d592544u, 0x20fd6e90u};

// v[0] + v[1] 2^30 + .. + v[8] 2^240; limbs below the top in [0, 2^30)
// after each update, the top one signed
struct S30 {
  int32_t v[LIMBS];
};

// the transition matrix of a batch of divsteps, scaled by 2^30
struct Trans {
  int32_t u, v, q, r;
};

// 30 half-delta divsteps on the low words of f (odd) and g; returns the
// new zeta = -(delta + 1/2). u, v, q, r lie in [-2^30, 2^30], kept as
// unsigned words so that the shifts are defined.
__device__ __forceinline__ int32_t divsteps(int32_t zeta, uint32_t f, uint32_t g, Trans& t) {
  uint32_t u = 1u, v = 0u, q = 0u, r = 1u;
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    uint32_t c1 = coop::opaque((uint32_t)(zeta >> 31));  // zeta < 0
    const uint32_t c2 = coop::opaque(0u - (g & 1u));     // g odd
    // g += (zeta < 0 ? -f : f) if g is odd, and q, r likewise
    g += ((f ^ c1) - c1) & c2;
    q += ((u ^ c1) - c1) & c2;
    r += ((v ^ c1) - c1) & c2;
    c1 &= c2;  // swap: zeta < 0 and g odd
    zeta = (int32_t)(((uint32_t)zeta ^ c1) - 1u);
    f += g & c1;
    u += q & c1;
    v += r & c1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t = Trans{(int32_t)u, (int32_t)v, (int32_t)q, (int32_t)r};
  return zeta;
}

// (d, e) <- t (d, e) / 2^30 mod p, keeping both in (-2p, p): md, me
// multiples of p make the low 30 bits of each product zero.
__device__ __forceinline__ void update_de(S30& d, S30& e, const Trans& t) {
  const int32_t sd = d.v[LIMBS - 1] >> 31, se = e.v[LIMBS - 1] >> 31;
  int32_t md = (t.u & sd) + (t.v & se);
  int32_t me = (t.q & sd) + (t.r & se);
  int64_t cd = (int64_t)t.u * d.v[0] + (int64_t)t.v * e.v[0];
  int64_t ce = (int64_t)t.q * d.v[0] + (int64_t)t.r * e.v[0];
  md -= (int32_t)((P_INV30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)M30);
  me -= (int32_t)((P_INV30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)M30);
  cd += (int64_t)P30[0] * md;
  ce += (int64_t)P30[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < LIMBS; ++i) {
    cd += (int64_t)t.u * d.v[i] + (int64_t)t.v * e.v[i] + (int64_t)P30[i] * md;
    ce += (int64_t)t.q * d.v[i] + (int64_t)t.r * e.v[i] + (int64_t)P30[i] * me;
    d.v[i - 1] = (int32_t)cd & M30;
    e.v[i - 1] = (int32_t)ce & M30;
    cd >>= 30;
    ce >>= 30;
  }
  d.v[LIMBS - 1] = (int32_t)cd;
  e.v[LIMBS - 1] = (int32_t)ce;
}

// (f, g) <- t (f, g) / 2^30 (exact)
__device__ __forceinline__ void update_fg(S30& f, S30& g, const Trans& t) {
  int64_t cf = (int64_t)t.u * f.v[0] + (int64_t)t.v * g.v[0];
  int64_t cg = (int64_t)t.q * f.v[0] + (int64_t)t.r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < LIMBS; ++i) {
    cf += (int64_t)t.u * f.v[i] + (int64_t)t.v * g.v[i];
    cg += (int64_t)t.q * f.v[i] + (int64_t)t.r * g.v[i];
    f.v[i - 1] = (int32_t)cf & M30;
    g.v[i - 1] = (int32_t)cg & M30;
    cf >>= 30;
    cg >>= 30;
  }
  f.v[LIMBS - 1] = (int32_t)cf;
  g.v[LIMBS - 1] = (int32_t)cg;
}

// the limbs' carries passed up, top limb signed
__device__ __forceinline__ void carry30(S30& r) {
#pragma unroll
  for (int i = 0; i < LIMBS - 1; ++i) {
    r.v[i + 1] += r.v[i] >> 30;
    r.v[i] &= M30;
  }
}

// r in (-2p, p) -> (sign < 0 ? -r : r) mod p in [0, p), by masks
__device__ __forceinline__ void normalize(S30& r, int32_t sign) {
  int32_t add = (int32_t)coop::opaque((uint32_t)(r.v[LIMBS - 1] >> 31));
  const int32_t neg = (int32_t)coop::opaque((uint32_t)(sign >> 31));
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) r.v[i] = ((r.v[i] + (P30[i] & add)) ^ neg) - neg;
  carry30(r);
  add = (int32_t)coop::opaque((uint32_t)(r.v[LIMBS - 1] >> 31));
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) r.v[i] += P30[i] & add;
  carry30(r);
}

// 8 words (below 2^256) -> 9 limbs of 30 bits
__device__ __forceinline__ S30 to_s30(const Fp& a) {
  S30 r;
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) {
    const int lo = 30 * i / 32, sh = 30 * i % 32;
    uint32_t x = a.w[lo] >> sh;
    if (sh > 2 && lo + 1 < NW) x |= a.w[lo + 1] << (32 - sh);
    r.v[i] = (int32_t)(x & (uint32_t)M30);
  }
  return r;
}

// 9 limbs in [0, 2^30), value below 2^256 -> 8 words
__device__ __forceinline__ Fp from_s30(const S30& a) {
  Fp r;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const int lo = 32 * k / 30, sh = 32 * k % 30;
    uint32_t x = (uint32_t)a.v[lo] >> sh;
    if (lo + 1 < LIMBS) x |= (uint32_t)a.v[lo + 1] << (30 - sh);  // sh <= 14: two limbs do
    r.w[k] = x;
  }
  return r;
}

// a = zR in [0, 2p) -> z^-1 R in [0, 2p); 0 and p -> 0
__device__ __forceinline__ Fp fp_inv_safegcd(const Fp& a) {
  S30 d, e, f, g = to_s30(fp_canon(a));
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) {
    d.v[i] = 0;
    e.v[i] = i == 0;
    f.v[i] = P30[i];
  }
  int32_t zeta = -1;  // delta = 1/2
#pragma unroll 1
  for (int b = 0; b < BATCHES; ++b) {
    Trans t;
    zeta = divsteps(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    update_de(d, e, t);
    update_fg(f, g, t);
  }
  // g = 0 and f = +-gcd = +-1 (or f = p, d = 0 for a = 0): d = +-a^-1
  normalize(d, f.v[LIMBS - 1]);
  return fp_mul(from_s30(d), fp_load(FP_R3));
}

}  // namespace inv
}  // namespace bn254
