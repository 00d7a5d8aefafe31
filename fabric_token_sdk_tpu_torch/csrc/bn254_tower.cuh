// BN254 extension tower Fp2 / Fp6 / Fp12 over the Montgomery base field.
//
// Replaces the tower device functions of the JAX package
// (fabric_token_sdk_tpu/ops/tower.py): Fp2 = Fp[i]/(i^2 + 1),
// Fp6 = Fp2[v]/(v^3 - XI), Fp12 = Fp6[w]/(w^2 - v), XI = 9 + i. An Fp12
// is kept in the reference's flat w-basis, c[j] the coefficient of w^j
// (w^6 = XI), which is also the memory layout (6, 2, 8) words; the tower
// view is c0 = (c[0], c[2], c[4]), c1 = (c[1], c[3], c[5]).
//
// Every op returns a unique field element, so canonical outputs equal
// the reference's whatever formula is used; the formulas here are the
// reference's (Karatsuba Fp2 and Fp6, Karatsuba and complex squaring
// over Fp6, the 18-product sparse 0-1-3 multiply). Values stay in
// [0, 2p) as in bn254_fp.cuh.
//
// Inlining: Fp2 ops are forced inline (3 base products each). The Fp6
// and Fp12 ops are FTS_NOINLINE: one Fp12 product is 54 inlined CIOS
// products, and inlining them into a Miller step or an exponentiation
// loop would make one kernel body of ~10^5 instructions and minutes of
// ptxas time. As calls, each body is compiled once per kernel source,
// and its operands and frame live on the per-thread stack (local
// memory, cached in L1); each entry point sets the stack limit.
#pragma once

#include "bn254_fp.cuh"

#ifndef FTS_NOINLINE
#define FTS_NOINLINE __noinline__
#endif

namespace bn254 {

struct Fp2 {
  Fp c0, c1;
};
struct Fp6 {
  Fp2 c[3];
};
struct Fp12 {
  Fp2 c[6];
};

// XI^(j (p^n - 1) / 6) for n = 1, 2, 3 and j = 0..5, Montgomery words.
// The twist Frobenius constants of the Miller loop are entries of it:
// XI^((p^n - 1) / 3) = [n-1][2] and XI^((p^n - 1) / 2) = [n-1][3].
static __device__ __constant__ uint32_t FROB_GAMMA[3][6][2][NW] = {
    {  // n = 1
        {{0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
        {{0x33144907u, 0xaf9ba696u, 0x87afb78au, 0xca6b1d73u, 0xf08a2087u, 0x11bded5eu, 0x1a1f3a7cu, 0x02f34d75u},
         {0x4c492d72u, 0xa222ae23u, 0x565de15bu, 0xd00f02a4u, 0x53dfc926u, 0xdc2ff3a2u, 0xb3899551u, 0x10a75716u}},
        {{0x4563ab30u, 0xb5773b10u, 0xa9aa6454u, 0x347f91c8u, 0x242e0991u, 0x7a007127u, 0x118214ecu, 0x1956bcd8u},
         {0xa0aa4757u, 0x6e849f1eu, 0x89f89141u, 0xaa1c7b6du, 0xfae0ca3au, 0xb6e713cdu, 0x4e82ebc3u, 0x26694fbbu}},
        {{0x2936b629u, 0xe4bbdd0cu, 0xe133bacbu, 0xbb30f162u, 0xf9645366u, 0x31a9d1b6u, 0xa500f8ddu, 0x253570beu},
         {0x5ffe77c7u, 0xa1d77ce4u, 0x7826d1dbu, 0x07affd11u, 0xbb7edc6bu, 0x6d16bd27u, 0x85defeccu, 0x2c872002u}},
        {{0x843abe92u, 0x7361d77fu, 0x273411fbu, 0xa5bb2bd3u, 0x4b3e2399u, 0x9c941f31u, 0xbb9fd3ecu, 0x15df9cddu},
         {0x4bd8c949u, 0x5dddfd15u, 0xa4445b60u, 0x62cb29a5u, 0x0c7dd2b9u, 0x37bc870au, 0x3171f0fdu, 0x24830a9du}},
        {{0x41690fe7u, 0xc970692fu, 0x27694b0bu, 0xe2403421u, 0x83c459e8u, 0x32bee66bu, 0x0ab08841u, 0x12aabcedu},
         {0x40aebfa9u, 0x0d485d23u, 0xab2fcc57u, 0x05193418u, 0x8a4910f5u, 0xd3b0a40bu, 0x35d2925au, 0x2f21ebb5u}},
    },
    {  // n = 2 (every gamma lies in Fp)
        {{0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
        {{0x00fa1bf2u, 0xca8d8005u, 0x68b39769u, 0xf0c5d614u, 0xad0d4418u, 0x0e201271u, 0xbad856e6u, 0x04290f65u},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
        {{0x13e80b9cu, 0x3350c88eu, 0xdb5e56b9u, 0x7dce557cu, 0xb615564au, 0x6001b4b8u, 0x020217e0u, 0x2682e617u},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
        {{0x12edefaau, 0x68c34889u, 0x72aabf4fu, 0x8d087f68u, 0x09081231u, 0x51e1a247u, 0x4729c0fau, 0x2259d6b1u},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
        {{0xd782e155u, 0x71930c11u, 0xffbe3323u, 0xa6bb947cu, 0xd4741444u, 0xaa303344u, 0x26594943u, 0x2c3b3f0du},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
        {{0xc494f1abu, 0x08cfc388u, 0x8d1373d4u, 0x19b31514u, 0xcb6c0213u, 0x584e90fdu, 0xdf2f8849u, 0x09e1685bu},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
    },
    {  // n = 3
        {{0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
        {{0x4e46d97du, 0x36531618u, 0xd4c96d9fu, 0x0af7129eu, 0xca1009b5u, 0x659da72fu, 0x83a20d23u, 0x08116d89u},
         {0xc39c1939u, 0xb1df4af7u, 0x8a73bf7fu, 0x3d9f0287u, 0x8caf0ae0u, 0x9b222092u, 0xeff054a6u, 0x26684515u}},
        {{0x16ad6badu, 0xc9af22f7u, 0x4aa662b2u, 0xb311782au, 0xe248c7f4u, 0x19eeaf64u, 0xe3439f82u, 0x20273e77u},
         {0xf7ce93acu, 0xacc02860u, 0x7ba76b4cu, 0x3933d581u, 0x446c8467u, 0x69e6188bu, 0x4417cc55u, 0x0a46036du}},
        {{0xaf46471eu, 0x5764af0au, 0x873e0fc1u, 0xdc50792eu, 0x881d04f6u, 0x86a673ffu, 0x3c30a74cu, 0x0b2eddb4u},
         {0x787e8580u, 0x9a490f32u, 0xf04af8b1u, 0x8fd16d7fu, 0xc6027bf2u, 0x4b39888eu, 0x5b52a15du, 0x03dd2e70u}},
        {{0x7b6762dfu, 0x448a93a5u, 0x28fdeadfu, 0xbfd62df5u, 0x0e9bd47au, 0xd858f5d0u, 0x3476ec58u, 0x06b03d4du},
         {0xbcc936d1u, 0x2b19daf4u, 0x56f4299fu, 0xa1a54e7au, 0x5adeaef1u, 0xb533eee0u, 0x84dda0b2u, 0x170c812bu}},
        {{0x75cf559fu, 0xe0bc4b22u, 0xc154e60fu, 0xc238b945u, 0x929a7d5eu, 0x803982a5u, 0xf7e4a37eu, 0x15ce052du},
         {0xbf3799a7u, 0x2d28efbdu, 0x1ad60773u, 0x9b097e3cu, 0xaf4a535bu, 0x982d4113u, 0xe3056063u, 0x24e18991u}},
    },
};

// ---------------------------------------------------------------- Fp2

__device__ __forceinline__ Fp2 fp2_zero() { return Fp2{fp_zero(), fp_zero()}; }
__device__ __forceinline__ Fp2 fp2_one() { return Fp2{fp_one(), fp_zero()}; }

__device__ __forceinline__ Fp2 fp2_load(const uint32_t* src) {
  return Fp2{fp_load(src), fp_load(src + NW)};
}

__device__ __forceinline__ void fp2_store_canon(uint32_t* dst, const Fp2& a) {
  fp_store(dst, fp_canon(a.c0));
  fp_store(dst + NW, fp_canon(a.c1));
}

__device__ __forceinline__ Fp2 fp2_select(uint32_t mask, const Fp2& a, const Fp2& b) {
  return Fp2{fp_select(mask, a.c0, b.c0), fp_select(mask, a.c1, b.c1)};
}

__device__ __forceinline__ Fp2 fp2_add(const Fp2& a, const Fp2& b) {
  return Fp2{fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}

__device__ __forceinline__ Fp2 fp2_sub(const Fp2& a, const Fp2& b) {
  return Fp2{fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}

__device__ __forceinline__ Fp2 fp2_neg(const Fp2& a) { return Fp2{fp_neg(a.c0), fp_neg(a.c1)}; }

__device__ __forceinline__ Fp2 fp2_conj(const Fp2& a) { return Fp2{a.c0, fp_neg(a.c1)}; }

__device__ __forceinline__ Fp2 fp2_dbl(const Fp2& a) { return fp2_add(a, a); }

// Karatsuba: 3 base products
__device__ __forceinline__ Fp2 fp2_mul(const Fp2& a, const Fp2& b) {
  Fp v0 = fp_mul(a.c0, b.c0);
  Fp v1 = fp_mul(a.c1, b.c1);
  Fp v01 = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
  return Fp2{fp_sub(v0, v1), fp_sub(v01, fp_add(v0, v1))};
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 i: 2 base products
__device__ __forceinline__ Fp2 fp2_sqr(const Fp2& a) {
  Fp t = fp_mul(a.c0, a.c1);
  return Fp2{fp_mul(fp_add(a.c0, a.c1), fp_sub(a.c0, a.c1)), fp_add(t, t)};
}

__device__ __forceinline__ Fp2 fp2_scale(const Fp2& a, const Fp& k) {
  return Fp2{fp_mul(a.c0, k), fp_mul(a.c1, k)};
}

// times XI = 9 + i: (9 a0 - a1) + (a0 + 9 a1) i, adds only
__device__ __forceinline__ Fp2 fp2_mul_xi(const Fp2& a) {
  Fp2 e = fp2_dbl(a);
  e = fp2_dbl(e);
  e = fp2_dbl(e);
  e = fp2_add(e, a);  // 9a
  return Fp2{fp_sub(e.c0, a.c1), fp_add(a.c0, e.c1)};
}

// all ones when a represents 0
__device__ __forceinline__ uint32_t fp2_is_zero(const Fp2& a) {
  return fp_is_zero(a.c0) & fp_is_zero(a.c1);
}

// (a0 - a1 i) / (a0^2 + a1^2): one Fermat inversion; maps 0 to 0
FTS_NOINLINE __device__ Fp2 fp2_inv(const Fp2& a) {
  Fp n = fp_inv(fp_add(fp_sqr(a.c0), fp_sqr(a.c1)));
  return Fp2{fp_mul(a.c0, n), fp_neg(fp_mul(a.c1, n))};
}

// ---------------------------------------------------------------- Fp6

__device__ __forceinline__ Fp6 fp6_add(const Fp6& a, const Fp6& b) {
  Fp6 r;
#pragma unroll
  for (int j = 0; j < 3; ++j) r.c[j] = fp2_add(a.c[j], b.c[j]);
  return r;
}

__device__ __forceinline__ Fp6 fp6_sub(const Fp6& a, const Fp6& b) {
  Fp6 r;
#pragma unroll
  for (int j = 0; j < 3; ++j) r.c[j] = fp2_sub(a.c[j], b.c[j]);
  return r;
}

__device__ __forceinline__ Fp6 fp6_neg(const Fp6& a) {
  Fp6 r;
#pragma unroll
  for (int j = 0; j < 3; ++j) r.c[j] = fp2_neg(a.c[j]);
  return r;
}

// times v: (a0, a1, a2) -> (XI a2, a0, a1)
__device__ __forceinline__ Fp6 fp6_mul_v(const Fp6& a) {
  Fp6 r;
  r.c[0] = fp2_mul_xi(a.c[2]);
  r.c[1] = a.c[0];
  r.c[2] = a.c[1];
  return r;
}

// Karatsuba over Fp2: 6 Fp2 products
FTS_NOINLINE __device__ Fp6 fp6_mul(const Fp6& a, const Fp6& b) {
  Fp2 t0 = fp2_mul(a.c[0], b.c[0]);
  Fp2 t1 = fp2_mul(a.c[1], b.c[1]);
  Fp2 t2 = fp2_mul(a.c[2], b.c[2]);
  Fp2 t12 = fp2_mul(fp2_add(a.c[1], a.c[2]), fp2_add(b.c[1], b.c[2]));
  Fp2 t01 = fp2_mul(fp2_add(a.c[0], a.c[1]), fp2_add(b.c[0], b.c[1]));
  Fp2 t02 = fp2_mul(fp2_add(a.c[0], a.c[2]), fp2_add(b.c[0], b.c[2]));
  Fp6 r;
  r.c[0] = fp2_add(t0, fp2_mul_xi(fp2_sub(t12, fp2_add(t1, t2))));
  r.c[1] = fp2_add(fp2_sub(t01, fp2_add(t0, t1)), fp2_mul_xi(t2));
  r.c[2] = fp2_add(fp2_sub(t02, fp2_add(t0, t2)), t1);
  return r;
}

FTS_NOINLINE __device__ Fp6 fp6_inv(const Fp6& a) {
  Fp2 c0 = fp2_sub(fp2_sqr(a.c[0]), fp2_mul_xi(fp2_mul(a.c[1], a.c[2])));
  Fp2 c1 = fp2_sub(fp2_mul_xi(fp2_sqr(a.c[2])), fp2_mul(a.c[0], a.c[1]));
  Fp2 c2 = fp2_sub(fp2_sqr(a.c[1]), fp2_mul(a.c[0], a.c[2]));
  Fp2 t = fp2_add(fp2_mul_xi(fp2_add(fp2_mul(a.c[2], c1), fp2_mul(a.c[1], c2))),
                  fp2_mul(a.c[0], c0));
  Fp2 ti = fp2_inv(t);
  Fp6 r;
  r.c[0] = fp2_mul(c0, ti);
  r.c[1] = fp2_mul(c1, ti);
  r.c[2] = fp2_mul(c2, ti);
  return r;
}

// ---------------------------------------------------------------- Fp12

__device__ __forceinline__ Fp6 fp12_c0(const Fp12& x) { return Fp6{{x.c[0], x.c[2], x.c[4]}}; }
__device__ __forceinline__ Fp6 fp12_c1(const Fp12& x) { return Fp6{{x.c[1], x.c[3], x.c[5]}}; }

__device__ __forceinline__ Fp12 fp12_join(const Fp6& c0, const Fp6& c1) {
  return Fp12{{c0.c[0], c1.c[0], c0.c[1], c1.c[1], c0.c[2], c1.c[2]}};
}

__device__ __forceinline__ Fp12 fp12_one() {
  Fp12 r;
  r.c[0] = fp2_one();
#pragma unroll
  for (int j = 1; j < 6; ++j) r.c[j] = fp2_zero();
  return r;
}

__device__ __forceinline__ Fp12 fp12_load(const uint32_t* src) {
  Fp12 r;
#pragma unroll
  for (int j = 0; j < 6; ++j) r.c[j] = fp2_load(src + 2 * NW * j);
  return r;
}

__device__ __forceinline__ void fp12_store_canon(uint32_t* dst, const Fp12& x) {
#pragma unroll
  for (int j = 0; j < 6; ++j) fp2_store_canon(dst + 2 * NW * j, x.c[j]);
}

// negate the odd powers of w (the p^6 Frobenius)
__device__ __forceinline__ Fp12 fp12_conj(const Fp12& x) {
  Fp12 r;
#pragma unroll
  for (int j = 0; j < 6; ++j) r.c[j] = (j & 1) ? fp2_neg(x.c[j]) : x.c[j];
  return r;
}

// Karatsuba over Fp6: 3 Fp6 products (18 Fp2)
FTS_NOINLINE __device__ Fp12 fp12_mul(const Fp12& x, const Fp12& y) {
  Fp6 x0 = fp12_c0(x), x1 = fp12_c1(x), y0 = fp12_c0(y), y1 = fp12_c1(y);
  Fp6 v0 = fp6_mul(x0, y0);
  Fp6 v1 = fp6_mul(x1, y1);
  Fp6 v01 = fp6_mul(fp6_add(x0, x1), fp6_add(y0, y1));
  return fp12_join(fp6_add(v0, fp6_mul_v(v1)), fp6_sub(v01, fp6_add(v0, v1)));
}

// complex squaring over Fp6: 2 Fp6 products (12 Fp2)
FTS_NOINLINE __device__ Fp12 fp12_sqr(const Fp12& x) {
  Fp6 x0 = fp12_c0(x), x1 = fp12_c1(x);
  Fp6 v = fp6_mul(x0, x1);
  Fp6 t0 = fp6_mul(fp6_add(x0, x1), fp6_add(x0, fp6_mul_v(x1)));
  return fp12_join(fp6_sub(fp6_sub(t0, v), fp6_mul_v(v)), fp6_add(v, v));
}

// (c0 + c1 w)^-1 = (c0 - c1 w) / (c0^2 - c1^2 v)
FTS_NOINLINE __device__ Fp12 fp12_inv(const Fp12& x) {
  Fp6 x0 = fp12_c0(x), x1 = fp12_c1(x);
  Fp6 n = fp6_sub(fp6_mul(x0, x0), fp6_mul_v(fp6_mul(x1, x1)));
  Fp6 ni = fp6_inv(n);
  return fp12_join(fp6_mul(x0, ni), fp6_neg(fp6_mul(x1, ni)));
}

// x^(p^n) for n = 1, 2, 3: conjugate every coefficient when n is odd,
// then times gamma_j
FTS_NOINLINE __device__ Fp12 fp12_frobenius(const Fp12& x, int n) {
  Fp12 r;
#pragma unroll 1
  for (int j = 0; j < 6; ++j) {
    Fp2 c = (n & 1) ? fp2_conj(x.c[j]) : x.c[j];
    r.c[j] = fp2_mul(c, fp2_load(&FROB_GAMMA[n - 1][j][0][0]));
  }
  return r;
}

// f * (l0 + l1 w + l3 w^3), l* in Fp2: 18 Fp2 products
FTS_NOINLINE __device__ Fp12 fp12_mul_sparse013(const Fp12& f, const Fp2& l0, const Fp2& l1,
                                                const Fp2& l3) {
  Fp12 r;
#pragma unroll 1
  for (int j = 0; j < 6; ++j) {
    Fp2 t = fp2_mul(f.c[j], l0);
    Fp2 u = fp2_mul(f.c[(j + 5) % 6], l1);
    if (j < 1) u = fp2_mul_xi(u);
    t = fp2_add(t, u);
    u = fp2_mul(f.c[(j + 3) % 6], l3);
    if (j < 3) u = fp2_mul_xi(u);
    r.c[j] = fp2_add(t, u);
  }
  return r;
}

__device__ __forceinline__ Fp12 fp12_select(uint32_t mask, const Fp12& a, const Fp12& b) {
  Fp12 r;
#pragma unroll
  for (int j = 0; j < 6; ++j) r.c[j] = fp2_select(mask, a.c[j], b.c[j]);
  return r;
}

}  // namespace bn254

#ifndef FTS_HOST_CHECK
#include <cuda_runtime.h>

namespace bn254 {

// Per-thread stack for the FTS_NOINLINE calls: the deepest chain (a
// kernel frame, an Fp12 op, an Fp6 op, an inversion) stays well below
// it. Raised once, before a kernel's first launch, if the current limit
// is lower (CUDA would also grow it as a launch needs).
constexpr size_t STACK_BYTES = 16384;

inline cudaError_t ensure_stack() {
  size_t cur = 0;
  cudaError_t e = cudaDeviceGetLimit(&cur, cudaLimitStackSize);
  if (e != cudaSuccess || cur >= STACK_BYTES) return e;
  return cudaDeviceSetLimit(cudaLimitStackSize, STACK_BYTES);
}

}  // namespace bn254
#endif
