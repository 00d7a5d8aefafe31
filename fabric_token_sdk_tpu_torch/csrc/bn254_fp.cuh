// BN254 base field Fp: Montgomery arithmetic on 8 x 32-bit words.
//
// Replaces the field device functions of the JAX package
// (fabric_token_sdk_tpu/ops/limbs.py: carry_pass, normalize_fixed,
// mul_full; fabric_token_sdk_tpu/ops/field.py: FieldSpec.mul/add/sub/
// neg/cond_sub_p/inv). Those used 32 8-bit limbs and an f32 matmul for
// the TPU's matrix unit; here an element is 8 little-endian uint32 words
// in registers and products are 32x32->64-bit integer multiplies.
//
// Montgomery form uses R = 2^256, the same integers as the reference.
// Values live in the redundant domain [0, 2p), as in the reference: since
// 4p < 2^256, the CIOS product of two such values lands in [0, 2p) with
// no final subtraction, add and sub need one conditional correction, and
// fp_canon maps to [0, p) for equality tests and outputs.
//
// Every function is branch-free: selects are masks, so the cost does not
// depend on the data (the prove plane will multiply secret scalars).
#pragma once

#include <cstdint>

namespace bn254 {

constexpr int NW = 8;  // words per element

// p, 2p, p - 2 (little-endian words); R mod p; -p^-1 mod 2^32
static __device__ __constant__ uint32_t FP_P[NW] = {
    0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
static __device__ __constant__ uint32_t FP_2P[NW] = {
    0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
    0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
static __device__ __constant__ uint32_t FP_PM2[NW] = {
    0xd87cfd45u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
// Montgomery one, R mod p = 2^256 - 5p
static __device__ __constant__ uint32_t FP_ONE[NW] = {
    0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
constexpr uint32_t FP_PINV = 0xe4866389u;
constexpr int FP_PM2_BITS = 254;  // bit length of p - 2

struct Fp {
  uint32_t w[NW];
};

__device__ __forceinline__ Fp fp_zero() {
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = 0u;
  return r;
}

__device__ __forceinline__ Fp fp_load(const uint32_t* src) {
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = src[i];
  return r;
}

__device__ __forceinline__ void fp_store(uint32_t* dst, const Fp& a) {
#pragma unroll
  for (int i = 0; i < NW; ++i) dst[i] = a.w[i];
}

// mask is all ones or all zeros: mask ? a : b
__device__ __forceinline__ Fp fp_select(uint32_t mask, const Fp& a, const Fp& b) {
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = (a.w[i] & mask) | (b.w[i] & ~mask);
  return r;
}

// a - m, and the borrow out (1 when a < m) as the return value
__device__ __forceinline__ uint32_t sub_words(Fp& r, const Fp& a, const uint32_t* m) {
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t d = (uint64_t)a.w[i] - m[i] - borrow;
    r.w[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 32) & 1u;  // the high word is all ones on borrow
  }
  return borrow;
}

// a - m if a >= m else a
__device__ __forceinline__ Fp fp_select_sub(const Fp& a, const uint32_t* m) {
  Fp d;
  uint32_t borrow = sub_words(d, a, m);
  return fp_select(0u - borrow, a, d);
}

// [0, 2p) -> [0, p)
__device__ __forceinline__ Fp fp_canon(const Fp& a) { return fp_select_sub(a, FP_P); }

// all ones when a represents 0 (a is 0 or p), else 0
__device__ __forceinline__ uint32_t fp_is_zero(const Fp& a) {
  Fp c = fp_canon(a);
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) acc |= c.w[i];
  return 0u - (uint32_t)(acc == 0u);
}

// [0, 2p) + [0, 2p) -> [0, 2p); the sum is below 4p < 2^256
__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
  Fp s;
  uint32_t carry = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = (uint64_t)a.w[i] + b.w[i] + carry;
    s.w[i] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  return fp_select_sub(s, FP_2P);
}

// a - b in [0, 2p): subtract, add 2p back on borrow (mod 2^256)
__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
  Fp d;
  uint32_t borrow = sub_words(d, a, b.w);
  uint32_t mask = 0u - borrow;
  uint32_t carry = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = (uint64_t)d.w[i] + (FP_2P[i] & mask) + carry;
    d.w[i] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  return d;
}

__device__ __forceinline__ Fp fp_neg(const Fp& a) { return fp_sub(fp_zero(), a); }

// Montgomery product a*b/2^256 mod p by CIOS (coarsely integrated
// operand scanning). For a, b < 2p the result is below 2p. Each step
// a[j]*b[i] + t[j] + carry <= (2^32-1)^2 + 2(2^32-1) = 2^64-1: no overflow.
__device__ __forceinline__ Fp fp_mul(const Fp& a, const Fp& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0u;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c = (uint64_t)a.w[j] * b.w[i] + t[j] + (c >> 32);
      t[j] = (uint32_t)c;
    }
    c = (uint64_t)t[NW] + (c >> 32);
    t[NW] = (uint32_t)c;
    t[NW + 1] = (uint32_t)(c >> 32);

    uint32_t m = t[0] * FP_PINV;
    c = (uint64_t)m * FP_P[0] + t[0];  // low word is 0 by choice of m
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      c = (uint64_t)m * FP_P[j] + t[j] + (c >> 32);
      t[j - 1] = (uint32_t)c;
    }
    c = (uint64_t)t[NW] + (c >> 32);
    t[NW - 1] = (uint32_t)c;
    t[NW] = t[NW + 1] + (uint32_t)(c >> 32);
  }
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = t[i];
  return r;
}

__device__ __forceinline__ Fp fp_sqr(const Fp& a) { return fp_mul(a, a); }

__device__ __forceinline__ Fp fp_one() { return fp_load(FP_ONE); }

// Fermat inverse a^(p-2) in Montgomery form; maps 0 to 0.
// Square-and-multiply over the public exponent p-2, with the multiply
// kept and selected every step so the instruction stream is fixed.
__device__ inline Fp fp_inv(const Fp& a) {
  Fp acc = fp_one();
#pragma unroll 1
  for (int i = FP_PM2_BITS - 1; i >= 0; --i) {
    acc = fp_sqr(acc);
    Fp t = fp_mul(acc, a);
    uint32_t bit = (FP_PM2[i >> 5] >> (i & 31)) & 1u;
    acc = fp_select(0u - bit, t, acc);
  }
  return acc;
}

}  // namespace bn254
