// The optimal-ate Miller loop and the final exponentiation on BN254 as
// device functions of one thread a row, for pairing_fused.cu (the staged
// kernels miller.cu and final_exp.cu run the same mathematics on the
// cooperative tower of bn254_gt_coop.cuh).
//
// Miller loop (the JAX package's fabric_token_sdk_tpu/ops/pairing.py:
// miller_loop): T starts at Q (Jacobian, Z = 1), and for each bit of
// 6u+2 after the leading one f = f^2 * l_{T,T}(P), T = 2T, and on a set
// bit f = f * l_{T,Q}(P), T = T + Q; then the two Frobenius-twisted
// closing adds with Q1 = pi(Q) and -pi^2(Q). The doubling and addition
// steps are the reference's Jacobian formulas with denominator-free
// lines (_dbl_step, _add_step), so T and every line are scaled exactly
// as there and f equals the reference's Miller value as a canonical
// Fp12. P is taken as given: infinity is the caller's mask, and a
// (0, 0) leg runs through the formulas like any other.
//
// Final exponentiation (pairing.py:final_exp): easy part t = conj(f) / f,
// t = t^(p^2) * t; hard part by the reference's balanced decomposition
// of (p^4 - p^2 + 1) / r = sum_i lambda_i p^i, lambda_i = sum_k c_ik u^k
// (pairing.py:_LAMBDA_COEFFS): t^u, t^(u^2), t^(u^3) by three 63-bit
// ladders over the bits of u; the four accumulators acc_i =
// prod_k (t^(u^k))^(c_ik) by one Straus pass over the 6 bits of |c_ik|
// MSB first, a negative c_ik taking the conjugate (the inverse, t being
// unitary); then acc_0 * acc_1^p * acc_2^(p^2) * acc_3^(p^3). The result
// is unique, so it equals the reference's.
//
// The bits of 6u+2, of u and the Straus tables are public constants, the
// same for every thread: the add step runs only on set bits, and the
// ladders and the Straus pass are real loops over them (uniform
// branches), not unrolled, to keep each build short. No other branch and
// no address depends on the values, which derive from secrets on the
// prove path.
//
// Layouts: P (.., 2, 8) and Q (.., 2, 2, 8) Montgomery affine in [0, 2p);
// Fp12 (.., 6, 2, 8) Montgomery, in [0, 2p) on input, canonical on
// output.
#pragma once

#include "bn254_tower.cuh"

namespace bn254 {

// a G2 point in Jacobian coordinates over Fp2
struct G2 {
  Fp2 x, y, z;
};

constexpr int FP12_WORDS = 12 * NW;

// 6u+2 without its leading bit, MSB first: 64 bits
constexpr uint64_t ATE_BITS = 0x9d797039be763ba8ull;
constexpr int ATE_NBITS = 64;

struct Line {
  Fp2 l0, l1, l3;
};

// Jacobian doubling of T and the line through T, T at P = (xp, yp):
// l0 = -2 Y Z^3 yp, l1 = 3 X^2 Z^2 xp, l3 = 2 Y^2 - 3 X^3
FTS_NOINLINE __device__ G2 dbl_step(const G2& t, const Fp& xp, const Fp& yp, Line& l) {
  Fp2 xx = fp2_sqr(t.x);
  Fp2 yy = fp2_sqr(t.y);
  Fp2 zz = fp2_sqr(t.z);
  Fp2 m = fp2_add(fp2_dbl(xx), xx);
  Fp2 xyy = fp2_mul(t.x, yy);
  Fp2 zzz = fp2_mul(zz, t.z);
  Fp2 yz = fp2_mul(t.y, t.z);
  Fp2 s = fp2_dbl(fp2_dbl(xyy));
  Fp2 m2 = fp2_mul(m, m);
  Fp2 yyyy = fp2_mul(yy, yy);
  Fp2 yzzz = fp2_mul(t.y, zzz);
  Fp2 mzz = fp2_mul(m, zz);
  Fp2 mx = fp2_mul(m, t.x);
  Fp2 x3 = fp2_sub(m2, fp2_dbl(s));
  Fp2 y3 = fp2_sub(fp2_mul(m, fp2_sub(s, x3)), fp2_dbl(fp2_dbl(fp2_dbl(yyyy))));
  Fp2 z3 = fp2_dbl(yz);
  l.l0 = fp2_scale(fp2_neg(fp2_dbl(yzzz)), yp);
  l.l1 = fp2_scale(mzz, xp);
  l.l3 = fp2_sub(fp2_dbl(yy), mx);
  return G2{x3, y3, z3};
}

// mixed addition T + Q (Q affine) and the line through T, Q at P:
// l0 = -Z3 yp, l1 = r xp, l3 = Z3 y2 - r x2
FTS_NOINLINE __device__ G2 add_step(const G2& t, const Fp2& x2, const Fp2& y2, const Fp& xp,
                                    const Fp& yp, Line& l) {
  Fp2 zz = fp2_sqr(t.z);
  Fp2 u2 = fp2_mul(x2, zz);
  Fp2 zzz = fp2_mul(zz, t.z);
  Fp2 h = fp2_sub(u2, t.x);
  Fp2 s2 = fp2_mul(y2, zzz);
  Fp2 hh = fp2_mul(h, h);
  Fp2 z3 = fp2_mul(t.z, h);
  Fp2 r = fp2_sub(s2, t.y);
  Fp2 hhh = fp2_mul(h, hh);
  Fp2 v = fp2_mul(t.x, hh);
  Fp2 rr = fp2_mul(r, r);
  Fp2 rx2 = fp2_mul(r, x2);
  Fp2 x3 = fp2_sub(fp2_sub(rr, hhh), fp2_dbl(v));
  Fp2 y3 = fp2_sub(fp2_mul(r, fp2_sub(v, x3)), fp2_mul(t.y, hhh));
  l.l3 = fp2_sub(fp2_mul(z3, y2), rx2);
  l.l0 = fp2_scale(fp2_neg(z3), yp);
  l.l1 = fp2_scale(r, xp);
  return G2{x3, y3, z3};
}

// The Miller value of one leg, f_{6u+2,Q}(P) with the closing adds.
__device__ __forceinline__ Fp12 miller_loop(const Fp& xp, const Fp& yp, const Fp2& qx,
                                            const Fp2& qy) {
  G2 t{qx, qy, fp2_one()};
  Fp12 f = fp12_one();
  Line l;
#pragma unroll 1
  for (int i = ATE_NBITS - 1; i >= 0; --i) {
    f = fp12_sqr(f);
    t = dbl_step(t, xp, yp, l);
    f = fp12_mul_sparse013(f, l.l0, l.l1, l.l3);
    if ((ATE_BITS >> i) & 1ull) {
      t = add_step(t, qx, qy, xp, yp, l);
      f = fp12_mul_sparse013(f, l.l0, l.l1, l.l3);
    }
  }
  // Q1 = pi(Q) = (conj(x) cx1, conj(y) cy1); -pi^2(Q) = (x cx2, -(y cy2))
  Fp2 q1x = fp2_mul(fp2_conj(qx), fp2_load(&FROB_GAMMA[0][2][0][0]));
  Fp2 q1y = fp2_mul(fp2_conj(qy), fp2_load(&FROB_GAMMA[0][3][0][0]));
  Fp2 q2x = fp2_mul(qx, fp2_load(&FROB_GAMMA[1][2][0][0]));
  Fp2 q2y = fp2_neg(fp2_mul(qy, fp2_load(&FROB_GAMMA[1][3][0][0])));
  t = add_step(t, q1x, q1y, xp, yp, l);
  f = fp12_mul_sparse013(f, l.l0, l.l1, l.l3);
  add_step(t, q2x, q2y, xp, yp, l);
  return fp12_mul_sparse013(f, l.l0, l.l1, l.l3);
}

// Leg `leg` of P (.., 2, 8) and Q (.., 2, 2, 8): its Miller value.
__device__ __forceinline__ Fp12 miller_leg(const uint32_t* __restrict__ P,
                                           const uint32_t* __restrict__ Q, size_t leg) {
  const uint32_t* p = P + leg * 2 * NW;
  const uint32_t* q = Q + leg * 4 * NW;
  return miller_loop(fp_load(p), fp_load(p + NW), fp2_load(q), fp2_load(q + 2 * NW));
}

__device__ __forceinline__ void miller_row(const uint32_t* __restrict__ P,
                                           const uint32_t* __restrict__ Q,
                                           uint32_t* __restrict__ out, int row) {
  fp12_store_canon(out + (size_t)row * FP12_WORDS, miller_leg(P, Q, (size_t)row));
}

constexpr uint64_t U_VALUE = 0x44e992b44a6909f1ull;  // u, 63 bits
constexpr int U_NBITS = 63;
constexpr int HP_NBITS = 6;

// HP_BITS[s][i][k]: bit s (MSB first) of |c_ik|; HP_POS[i][k]: c_ik >= 0
static __device__ __constant__ uint8_t HP_BITS[HP_NBITS][4][4] = {
    {{0, 0, 0, 1}, {0, 0, 0, 1}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 1, 1, 0}, {0, 0, 1, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 0, 1, 0}, {0, 1, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 0, 1, 1}, {0, 1, 0, 1}, {0, 0, 1, 0}, {0, 0, 0, 0}},
    {{1, 1, 1, 0}, {0, 0, 1, 0}, {0, 0, 1, 0}, {0, 0, 0, 0}},
    {{0, 0, 0, 0}, {1, 0, 0, 0}, {1, 0, 0, 0}, {1, 0, 0, 0}},
};
static __device__ __constant__ uint8_t HP_POS[4][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {1, 1, 1, 1}, {1, 1, 1, 1}};

// f^u, MSB first over the bits of u below its leading one
FTS_NOINLINE __device__ Fp12 pow_u(const Fp12& f) {
  Fp12 acc = f;
#pragma unroll 1
  for (int i = U_NBITS - 2; i >= 0; --i) {
    acc = fp12_sqr(acc);
    if ((U_VALUE >> i) & 1ull) acc = fp12_mul(acc, f);
  }
  return acc;
}

__device__ __forceinline__ Fp12 final_exp(const Fp12& f) {
  Fp12 t = fp12_mul(fp12_conj(f), fp12_inv(f));
  t = fp12_mul(fp12_frobenius(t, 2), t);
  Fp12 pw[4];
  pw[0] = t;
  pw[1] = pow_u(pw[0]);
  pw[2] = pow_u(pw[1]);
  pw[3] = pow_u(pw[2]);
  Fp12 acc[4];
#pragma unroll 1
  for (int i = 0; i < 4; ++i) acc[i] = fp12_one();
#pragma unroll 1
  for (int s = 0; s < HP_NBITS; ++s) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) acc[i] = fp12_sqr(acc[i]);
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
#pragma unroll 1
      for (int i = 0; i < 4; ++i) {
        if (HP_BITS[s][i][k])
          acc[i] = fp12_mul(acc[i], HP_POS[i][k] ? pw[k] : fp12_conj(pw[k]));
      }
    }
  }
  Fp12 r01 = fp12_mul(acc[0], fp12_frobenius(acc[1], 1));
  Fp12 r23 = fp12_mul(fp12_frobenius(acc[2], 2), fp12_frobenius(acc[3], 3));
  return fp12_mul(r01, r23);
}

__device__ __forceinline__ void final_exp_row(const uint32_t* __restrict__ f_in,
                                              uint32_t* __restrict__ out, int row) {
  fp12_store_canon(out + (size_t)row * FP12_WORDS,
                   final_exp(fp12_load(f_in + (size_t)row * FP12_WORDS)));
}

}  // namespace bn254
