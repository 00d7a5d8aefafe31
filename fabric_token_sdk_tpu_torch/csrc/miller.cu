// miller: the optimal-ate Miller loop over 6u+2, one thread per leg.
//
// Replaces the JAX program miller_tile (fabric_token_sdk_tpu/ops/
// pairing.py:miller_loop): T starts at Q (Jacobian, Z = 1), and for each
// bit of 6u+2 after the leading one f = f^2 * l_{T,T}(P), T = 2T, and on
// a set bit f = f * l_{T,Q}(P), T = T + Q; then the two Frobenius-twisted
// closing adds with Q1 = pi(Q) and -pi^2(Q). The doubling and addition
// steps are the reference's Jacobian formulas with denominator-free
// lines (_dbl_step, _add_step), so T and every line are scaled exactly
// as there and f equals the reference's Miller value as a canonical
// Fp12. P is taken as given: infinity is the caller's mask, and a
// (0, 0) leg runs through the formulas like any other.
//
// The bits of 6u+2 are a public constant, the same for every thread, so
// the add step runs only on set bits (a uniform branch); the reference
// computes it every step and selects, which gives the same values. No
// other branch and no address depends on the legs, which derive from
// secrets on the prove path (R' = R^r, t = PK1^rho_v + PK2^rho_h).
//
// Layout: P (n, 2, 8) and Q (n, 2, 2, 8) Montgomery affine in [0, 2p);
// out (n, 6, 2, 8) canonical Montgomery Fp12.
//
// What bounds it on the H100: integer multiplies, ~8,300 base products a
// leg for the function (64 doubling steps with line and sparse product,
// 36 add steps, f^2 on each bit). State: f is 96 words, T 48, Q 32, P 16
// (192 words, most of the 255-register budget), so the Fp12 ops run as
// calls with their operands on the stack; one warp a block.
#include "bn254_g2.cuh"

using namespace bn254;

namespace {

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

__device__ __forceinline__ void miller_row(const uint32_t* __restrict__ P,
                                           const uint32_t* __restrict__ Q,
                                           uint32_t* __restrict__ out, int row) {
  const uint32_t* p = P + (size_t)row * 2 * NW;
  const uint32_t* q = Q + (size_t)row * 4 * NW;
  const Fp xp = fp_load(p), yp = fp_load(p + NW);
  const Fp2 qx = fp2_load(q), qy = fp2_load(q + 2 * NW);
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
  f = fp12_mul_sparse013(f, l.l0, l.l1, l.l3);
  fp12_store_canon(out + (size_t)row * 12 * NW, f);
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_miller(const uint32_t* P, const uint32_t* Q, uint32_t* out, int n) {
  for (int row = 0; row < n; ++row) miller_row(P, Q, out, row);
}
#else
namespace {
constexpr int THREADS = 32;

__global__ void miller_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                              uint32_t* __restrict__ out, int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) miller_row(P, Q, out, row);
}
}  // namespace

extern "C" int fts_miller(const void* P, const void* Q, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = ensure_stack();
  if (e != cudaSuccess) return (int)e;
  int blocks = (n + THREADS - 1) / THREADS;
  miller_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)P, (const uint32_t*)Q, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
