// The optimal-ate Miller loop over 6u+2 of one leg, spread over the NG
// lanes of a group on the cooperative tower of bn254_gt_coop.cuh, its
// state in shared memory: the row function of miller.cu (a leg a group)
// and of pairing_fused.cu (a row's legs side by side).
//
// The mathematics is the reference's (fabric_token_sdk_tpu/ops/
// pairing.py:miller_loop): T starts at Q (Jacobian, Z = 1); for
// each of the 64 bits of 6u+2 below its top f = f^2 l_{T,T}(P), T = 2T,
// and on a set bit f = f l_{T,Q}(P), T = T + Q; then the closing adds
// with Q1 = pi(Q) and -pi^2(Q). The steps are the reference's Jacobian
// doubling and mixed addition with denominator-free lines (_dbl_step,
// _add_step), so T, every line and f are the same field elements as
// there, and the canonical output equals the plain version bit for bit.
// Only the grouping of the products differs (YZ^3 as YZ ZZ, y2 Z^3 as
// (y2 Z) Z^2, Y HHH as (Y H) HH, M = 3 XX kept as multiples of XX's
// products, f^2 by complex squaring over Fp6, each coefficient of the
// line product as three Fp2 products summed after), which no field
// element depends on. P is taken as given: infinity is the caller's
// mask, and a (0, 0) leg runs like any other.
//
// What bounds it on the H100: integer multiplies, ~8,300 base products a
// leg for the function. But a leg is a chain of dependent steps, and one
// Fp2 product alone takes ~4,000 cycles (chip_probe.py --ubench), so
// below a wave of legs the time is the chain's latency, and at the
// 1,024-tx verify's 15,872 legs the card is issue-bound. The design:
// the NG lanes of a leg, each with whole field elements (bn254_ladder.cuh's
// field at TPI = 1), share each phase's independent tasks (task t by
// lane t mod NG, __syncwarp between phases); f, T, Q, pi(Q), -pi^2(Q), (xp, 0), (yp, 0), the step
// temporaries and the product cells are the leg's 52 Fp2 cells in
// shared memory (3,328 B). Every task is one entry of MILLER_TASKS: a
// cell gets a sum of cells with small multipliers (a combination), or
// the product of two combinations. One loop over the phases of a step
// runs every task through the same code, so the kernel holds one Fp2
// product: its body stays in the instruction cache (the same product
// unrolled at 8 or 64 sites ran 2.3x slower), and nothing lives on a
// stack. A doubling is five phases (f^2's 12 products with XX, YY, ZZ,
// YZ; f^2's combine with X YY, XX^2, YY^2, XX ZZ, XX X, YZ ZZ; the line
// with the new X and Z; the line product's 18 Fp2 products; their sums
// with the new Y), an add step four (HH, Z3, rr, r x2, Y H, r; HHH, V,
// Z3 y2, Y H HH and the line; the line product's products with the new
// X and Z; their sums with the new Y). An add's first products, x2 Z^2
// and y2 Z^3, are prepared in the two phases before it. Every branch
// and address depends only on the public bits of 6u+2, the task table
// and the lane's place, never on the legs, which derive from secrets on
// the prove path (R' = R^r, t = PK1^rho_v + PK2^rho_h). __syncwarp
// names the whole warp, so every group of a warp runs the same phases:
// they depend only on the public bits of 6u+2. A leg past the last runs
// on a clamped leg, takes part in every barrier and stores nothing.
#pragma once

#include "bn254_gt_coop.cuh"

#ifdef FTS_HOST_CHECK
struct uint4 {
  uint32_t x, y, z, w;
};
#endif

namespace bn254 {
namespace miller {

using gtc::Fe;
using gtc::Fe2;

// 6u+2 without its leading bit, MSB first: 64 bits, 36 set
constexpr uint64_t ATE_BITS = 0x9d797039be763ba8ull;
constexpr int ATE_NBITS = 64;

// A leg's cells.
enum : int {
  F = 0,     // f (6 cells)
  TX = 6,    // T, Jacobian
  TY = 7,
  TZ = 8,
  Q0 = 9,    // Q (x, y)
  Q1 = 11,   // pi(Q)
  Q2 = 13,   // -pi^2(Q)
  XP = 15,   // (xp, 0)
  YP = 16,   // (yp, 0)
  S = 17,    // the doubling's X YY, XX^2, YY^2, XX ZZ, XX X, YZ ZZ; the add's
             // HH, Z3, rr, r x2, Y H, r
  L0 = 23,   // the line's l0, l1, l3 (l3 the doubling's; the add's Y H HH)
  L1 = 24,
  L3 = 25,
  Y3 = 26,   // the new Y before its last term
  HHH = 27,  // the add's H HH, V = X HH, Z3 y2
  V = 28,
  Z3Y2 = 29,
  XZ2 = 30,  // x2 Z^2 and y2 Z^3 of the next add
  YZ3 = 31,
  PA0 = 32,  // Z^2 and y2 Z of the next add ((YZ)^2, y2 YZ after a doubling)
  PA1 = 33,
  NC = 34 + gtc::NPROD,
  // the Q of this add and of the next, resolved when a task runs
  QAX = 60,
  QAY = 61,
  QNX = 62,
  QNY = 63,
};
template <int NG>
using Row = gtc::Row<NG, NC>;
constexpr int P = Row<1>::P;  // f^2's 12 products and XX, YY, ZZ, YZ; the line product's 18

// A term of a combination: cell c times 2^sh (plus the cell once more
// with pl: 3 = 2 + 1, 9 = 8 + 1), subtracted with ng. With xi the sum so
// far is multiplied by XI before the term enters (Horner), so that a
// combination takes XI once: XI (a + b) + c is the terms a, b, c with xi
// on c.
#define FTS_T(c, sh, pl, ng, xi) \
  (uint16_t)((c) | (sh) << 6 | (pl) << 8 | (ng) << 9 | (xi) << 10)
#define T1(c) FTS_T(c, 0, 0, 0, 0)
#define TN(c) FTS_T(c, 0, 0, 1, 0)
#define TI(c) FTS_T(c, 0, 0, 0, 1)
#define T2(c) FTS_T(c, 1, 0, 0, 0)
#define TN2(c) FTS_T(c, 1, 0, 1, 0)
#define T2I(c) FTS_T(c, 1, 0, 0, 1)
#define T3(c) FTS_T(c, 1, 1, 0, 0)
#define TN3(c) FTS_T(c, 1, 1, 1, 0)
#define T4(c) FTS_T(c, 2, 0, 0, 0)
#define T8(c) FTS_T(c, 3, 0, 0, 0)
#define TN8(c) FTS_T(c, 3, 0, 1, 0)
#define T9(c) FTS_T(c, 3, 1, 0, 0)
#define TN9(c) FTS_T(c, 3, 1, 1, 0)

// A task: cell dst gets the combination of its first na terms, times the
// combination of the next nb when nb > 0. 32 bytes, read as two 16-byte
// loads.
struct alignas(16) Task {
  uint16_t hdr;  // dst | na << 6 | nb << 10
  uint16_t term[15];
};
#define FTS_H(dst, na, nb) (uint16_t)((dst) | (na) << 6 | (nb) << 10)


// The line product: coefficient j of f (l0 + l1 w + l3 w^3) is f_j l0 +
// f_{j-1} l1 + f_{j-3} l3, a wrapped term times XI (w^6 = XI). LINE(j)
// puts its three products at P + 3j .. P + 3j + 2, l3 the combination of
// nl terms lt; LINE_SUMS adds them up, XI entering by Horner.
#define LINE(j, lt, nl)                                                    \
  {FTS_H(P + 3 * (j), 1, 1), {T1(F + (j)), T1(L0)}},                       \
      {FTS_H(P + 3 * (j) + 1, 1, 1), {T1(F + ((j) + 5) % 6), T1(L1)}},     \
      {FTS_H(P + 3 * (j) + 2, 1, nl), {T1(F + ((j) + 3) % 6), lt}}
#define LINE_DBL T1(L3)
#define LINE_ADD T1(Z3Y2), TN(S + 3)
#define LINE_SUMS                                                          \
  {FTS_H(F + 0, 3, 0), {T1(P + 1), T1(P + 2), TI(P + 0)}},                 \
      {FTS_H(F + 1, 3, 0), {T1(P + 5), TI(P + 3), T1(P + 4)}},             \
      {FTS_H(F + 2, 3, 0), {T1(P + 8), TI(P + 6), T1(P + 7)}},             \
      {FTS_H(F + 3, 3, 0), {T1(P + 9), T1(P + 10), T1(P + 11)}},           \
      {FTS_H(F + 4, 3, 0), {T1(P + 12), T1(P + 13), T1(P + 14)}},          \
      {FTS_H(F + 5, 3, 0), {T1(P + 15), T1(P + 16), T1(P + 17)}}

// The phases of a doubling (0-4) and of an add step (5-8), in order. A
// phase's last tasks, x2 Z^2 and y2 Z^3 of the next add or the products
// they take, run only when an add step follows.
constexpr int NTASKS = 107;
static __device__ const Task MILLER_TASKS[NTASKS] = {
    // 0: f^2 = (c0 + c1 w)^2 by complex squaring over Fp6: v = c0 c1,
    // t = (c0 + c1)(c0 + v' c1) (c0 = f0, f2, f4; c1 = f1, f3, f5; v'
    // the Fp6 generator, c0 + v' c1 = (f0 + XI f5, f2 + f1, f4 + f3)),
    // each a Karatsuba Fp6 product; XX, YY, ZZ, YZ
    {FTS_H(P + 0, 1, 1), {T1(F + 0), T1(F + 1)}},
    {FTS_H(P + 1, 1, 1), {T1(F + 2), T1(F + 3)}},
    {FTS_H(P + 2, 1, 1), {T1(F + 4), T1(F + 5)}},
    {FTS_H(P + 3, 2, 2), {T1(F + 2), T1(F + 4), T1(F + 3), T1(F + 5)}},
    {FTS_H(P + 4, 2, 2), {T1(F + 0), T1(F + 2), T1(F + 1), T1(F + 3)}},
    {FTS_H(P + 5, 2, 2), {T1(F + 0), T1(F + 4), T1(F + 1), T1(F + 5)}},
    {FTS_H(P + 6, 2, 2), {T1(F + 0), T1(F + 1), T1(F + 5), TI(F + 0)}},
    {FTS_H(P + 7, 2, 2), {T1(F + 2), T1(F + 3), T1(F + 1), T1(F + 2)}},
    {FTS_H(P + 8, 2, 2), {T1(F + 4), T1(F + 5), T1(F + 3), T1(F + 4)}},
    {FTS_H(P + 9, 4, 4),
     {T1(F + 2), T1(F + 3), T1(F + 4), T1(F + 5), T1(F + 1), T1(F + 2), T1(F + 3), T1(F + 4)}},
    {FTS_H(P + 10, 4, 4),
     {T1(F + 0), T1(F + 1), T1(F + 2), T1(F + 3), T1(F + 5), TI(F + 0), T1(F + 1), T1(F + 2)}},
    {FTS_H(P + 11, 4, 4),
     {T1(F + 0), T1(F + 1), T1(F + 4), T1(F + 5), T1(F + 5), TI(F + 0), T1(F + 3), T1(F + 4)}},
    {FTS_H(P + 12, 1, 1), {T1(TX), T1(TX)}},
    {FTS_H(P + 13, 1, 1), {T1(TY), T1(TY)}},
    {FTS_H(P + 14, 1, 1), {T1(TZ), T1(TZ)}},
    {FTS_H(P + 15, 1, 1), {T1(TY), T1(TZ)}},
    // 1: X YY, XX^2, YY^2, XX ZZ, XX X, YZ ZZ; f^2 into F: c0 = t - v -
    // v' v, c1 = 2 v, with v_i and t_i the Fp6 Karatsuba combines of the
    // products a = P .. P + 5 and b = P + 6 .. P + 11 (t0, t1, t2, t12,
    // t01, t02): a0 + XI (a12 - a1 - a2), a01 - a0 - a1 + XI a2, a02 - a0
    // - a2 + a1, t_i likewise over b; (YZ)^2 and y2' YZ
    {FTS_H(S + 0, 1, 1), {T1(TX), T1(P + 13)}},
    {FTS_H(S + 1, 1, 1), {T1(P + 12), T1(P + 12)}},
    {FTS_H(S + 2, 1, 1), {T1(P + 13), T1(P + 13)}},
    {FTS_H(S + 3, 1, 1), {T1(P + 12), T1(P + 14)}},
    {FTS_H(S + 4, 1, 1), {T1(P + 12), T1(TX)}},
    {FTS_H(S + 5, 1, 1), {T1(P + 15), T1(P + 14)}},
    // f0 = t0 - v0 - XI v2 = XI (b12 - b1 - b2 - a12 - a02 + a0 + 2 a2) + b0 - a0
    {FTS_H(F + 0, 9, 0),
     {T1(P + 9), TN(P + 7), TN(P + 8), TN(P + 3), TN(P + 5), T1(P + 0), T2(P + 2), TI(P + 6),
      TN(P + 0)}},
    // f1 = 2 v0 = XI (2 a12 - 2 a1 - 2 a2) + 2 a0
    {FTS_H(F + 1, 4, 0), {T2(P + 3), TN2(P + 1), TN2(P + 2), T2I(P + 0)}},
    // f2 = t1 - v1 - v0 = XI (b2 - a12 + a1) + b01 - b0 - b1 - a01 + a1
    {FTS_H(F + 2, 8, 0),
     {T1(P + 8), TN(P + 3), T1(P + 1), TI(P + 10), TN(P + 6), TN(P + 7), TN(P + 4), T1(P + 1)}},
    // f3 = 2 v1 = XI 2 a2 + 2 a01 - 2 a0 - 2 a1
    {FTS_H(F + 3, 4, 0), {T2(P + 2), T2I(P + 4), TN2(P + 0), TN2(P + 1)}},
    // f4 = t2 - v2 - v1 = XI (-a2) + b02 - b0 - b2 + b1 - a02 + 2 a0 + a2 - a01
    {FTS_H(F + 4, 9, 0),
     {TN(P + 2), TI(P + 11), TN(P + 6), TN(P + 8), T1(P + 7), TN(P + 5), T2(P + 0), T1(P + 2),
      TN(P + 4)}},
    // f5 = 2 v2 = 2 a02 - 2 a0 - 2 a2 + 2 a1
    {FTS_H(F + 5, 4, 0), {T2(P + 5), TN2(P + 0), TN2(P + 2), T2(P + 1)}},
    {FTS_H(PA0, 1, 1), {T1(P + 15), T1(P + 15)}},
    {FTS_H(PA1, 1, 1), {T1(P + 15), T1(QNY)}},
    // 2: the line l0 = -2 YZ^3 yp, l1 = 3 XX ZZ xp, l3 = 2 YY - 3 XX X;
    // XX (12 X YY - 9 XX^2) = XX (4 X YY - X3); X3 = 9 XX^2 - 8 X YY,
    // Z3 = 2 YZ; x2 Z3^2 = x2 4 (YZ)^2, y2 Z3^3 = 2 y2 YZ 4 (YZ)^2
    {FTS_H(L0, 1, 1), {TN2(S + 5), T1(YP)}},
    {FTS_H(L1, 1, 1), {T3(S + 3), T1(XP)}},
    {FTS_H(L3, 2, 0), {T2(P + 13), TN3(S + 4)}},
    {FTS_H(Y3, 1, 3), {T1(P + 12), T8(S + 0), T4(S + 0), TN9(S + 1)}},
    {FTS_H(TX, 2, 0), {T9(S + 1), TN8(S + 0)}},
    {FTS_H(TZ, 1, 0), {T2(P + 15)}},
    {FTS_H(XZ2, 1, 1), {T1(QNX), T4(PA0)}},
    {FTS_H(YZ3, 1, 1), {T2(PA1), T4(PA0)}},
    // 3: the line product's 18 products
    LINE(0, LINE_DBL, 1), LINE(1, LINE_DBL, 1), LINE(2, LINE_DBL, 1),
    LINE(3, LINE_DBL, 1), LINE(4, LINE_DBL, 1), LINE(5, LINE_DBL, 1),
    // 4: their sums into F; Y3 = 3 XX (4 X YY - X3) - 8 YY^2
    LINE_SUMS,
    {FTS_H(TY, 2, 0), {T3(Y3), TN8(S + 2)}},
    // 5 (add step): H = x2 Z^2 - X, r = y2 Z^3 - Y; HH, Z3 = Z H, rr,
    // r x2, Y H, r
    {FTS_H(S + 0, 2, 2), {T1(XZ2), TN(TX), T1(XZ2), TN(TX)}},
    {FTS_H(S + 1, 1, 2), {T1(TZ), T1(XZ2), TN(TX)}},
    {FTS_H(S + 2, 2, 2), {T1(YZ3), TN(TY), T1(YZ3), TN(TY)}},
    {FTS_H(S + 3, 2, 1), {T1(YZ3), TN(TY), T1(QAX)}},
    {FTS_H(S + 4, 1, 2), {T1(TY), T1(XZ2), TN(TX)}},
    {FTS_H(S + 5, 2, 0), {T1(YZ3), TN(TY)}},
    // 6: HHH = H HH, V = X HH, Z3 y2, Y H HH; the line l0 = -Z3 yp,
    // l1 = r xp; Z3^2 and y2' Z3
    {FTS_H(HHH, 2, 1), {T1(XZ2), TN(TX), T1(S + 0)}},
    {FTS_H(V, 1, 1), {T1(TX), T1(S + 0)}},
    {FTS_H(Z3Y2, 1, 1), {T1(S + 1), T1(QAY)}},
    {FTS_H(L3, 1, 1), {T1(S + 4), T1(S + 0)}},
    {FTS_H(L0, 1, 1), {TN(S + 1), T1(YP)}},
    {FTS_H(L1, 1, 1), {T1(S + 5), T1(XP)}},
    {FTS_H(PA0, 1, 1), {T1(S + 1), T1(S + 1)}},
    {FTS_H(PA1, 1, 1), {T1(S + 1), T1(QNY)}},
    // 7: the line product's 18 products (l3 = Z3 y2 - r x2); r (V - X3) =
    // r (3V - rr + HHH); X3 = rr - HHH - 2V, Z3; x2 Z3^2, y2 Z3^3
    LINE(0, LINE_ADD, 2), LINE(1, LINE_ADD, 2), LINE(2, LINE_ADD, 2),
    LINE(3, LINE_ADD, 2), LINE(4, LINE_ADD, 2), LINE(5, LINE_ADD, 2),
    {FTS_H(Y3, 1, 3), {T1(S + 5), T3(V), TN(S + 2), T1(HHH)}},
    {FTS_H(TX, 3, 0), {T1(S + 2), TN(HHH), TN2(V)}},
    {FTS_H(TZ, 1, 0), {T1(S + 1)}},
    {FTS_H(XZ2, 1, 1), {T1(QNX), T1(PA0)}},
    {FTS_H(YZ3, 1, 1), {T1(PA1), T1(PA0)}},
    // 8: their sums into F; Y3 = r (V - X3) - Y HHH
    LINE_SUMS,
    {FTS_H(TY, 2, 0), {T1(Y3), TN(L3)}},
};
#undef LINE
#undef LINE_DBL
#undef LINE_ADD
#undef LINE_SUMS
#undef FTS_H
#undef T1
#undef TN
#undef TI
#undef T2
#undef TN2
#undef T2I
#undef T3
#undef TN3
#undef T4
#undef T8
#undef TN8
#undef T9
#undef TN9
#undef FTS_T

// A phase: its first task, its tasks, and its tasks when no add follows
// (the phases in order cover the NTASKS tasks).
struct Phase {
  uint8_t first, n, n_last;
};
constexpr int PH_DBL = 0, PH_ADD = 5, PH_END = 9;
static __device__ __constant__ Phase PHASES[PH_END] = {
    {0, 16, 16}, {16, 14, 12}, {30, 8, 6},   {38, 18, 18}, {56, 7, 7},
    {63, 6, 6},  {69, 8, 6},   {77, 23, 21}, {100, 7, 7}};

// the combination of the next n terms of w (two a word, the next in the
// low half of w[0]); w moves on past them
template <int NG>
__device__ __forceinline__ Fe2 combination(const Row<NG>& r, uint32_t (&w)[8], uint32_t n, int qa,
                                           int qn) {
  const gtc::Group& g = r.g;
  Fe2 acc{coop::fe_zero<1>(), coop::fe_zero<1>()};
#pragma unroll 1
  for (uint32_t k = 0; k < n; ++k) {
    const uint32_t t = w[0] & 0xffffu;
    int c = (int)(t & 63u);
    if (c >= QAX) c = c < QNX ? qa + c - QAX : qn + c - QNX;
    const Fe2 v = r.load(c);
    Fe2 x = v;
#pragma unroll 1
    for (uint32_t s = (t >> 6) & 3u; s > 0; --s) x = coop::fe2_dbl(g, x);
    if ((t >> 8) & 1u) x = coop::fe2_add(g, x, v);
    if ((t >> 10) & 1u) acc = gtc::fe2_mul_xi(g, acc);
    if ((t >> 9) & 1u) {
      acc = coop::fe2_sub(g, acc, x);
    } else {
      acc = k > 0 ? coop::fe2_add(g, acc, x) : x;
    }
#pragma unroll
    for (int j = 0; j < 7; ++j) w[j] = (w[j] >> 16) | (w[j + 1] << 16);
    w[7] >>= 16;
  }
  return acc;
}

template <int NG>
__device__ __forceinline__ void run_task(const Row<NG>& r, int task, int qa, int qn) {
  const uint4* src = reinterpret_cast<const uint4*>(MILLER_TASKS + task);
  const uint4 a = __ldg(src), b = __ldg(src + 1);
  uint32_t w[8] = {a.x >> 16 | a.y << 16, a.y >> 16 | a.z << 16, a.z >> 16 | a.w << 16,
                   a.w >> 16 | b.x << 16, b.x >> 16 | b.y << 16, b.y >> 16 | b.z << 16,
                   b.z >> 16 | b.w << 16, b.w >> 16};
  const uint32_t hdr = a.x & 0xffffu, na = (hdr >> 6) & 15u, nb = hdr >> 10;
  Fe2 x = combination(r, w, na, qa, qn);
  if (nb > 0) x = coop::fe2_mul(r.g, x, combination(r, w, nb, qa, qn));
  r.store((int)(hdr & 63u), x);
}

__device__ __forceinline__ Fe2 load_fe2(const uint32_t* __restrict__ src) {
  Fe2 v;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    v.c0.w[k] = __ldg(src + k);
    v.c1.w[k] = __ldg(src + NW + k);
  }
  return v;
}
// The Miller loop of the leg at p (2, 8) and q (2, 2, 8) by this lane of
// NG: f is left in the leg's cells F .. F + 5 (slot 0 of its column),
// after a barrier. Every lane of the warp takes part in every barrier.
template <int NG>
__device__ __forceinline__ void miller_leg(const Row<NG>& r, const uint32_t* __restrict__ p,
                                           const uint32_t* __restrict__ q) {
  const gtc::Group& g = r.g;
  // T = (Q, 1), f = 1; pi(Q) = (conj(x) g12, conj(y) g13), -pi^2(Q) =
  // (x g22, -(y g23)), the gammas FROB_GAMMA[n - 1][2, 3]; (xp, 0), (yp, 0)
#pragma unroll 1
  for (int t = (int)r.grp; t < 9; t += NG) {
    const Fe zero = coop::fe_zero<1>();
    if (t >= 7) {
      Fe2 v{zero, zero};
#pragma unroll
      for (int k = 0; k < NW; ++k) v.c0.w[k] = __ldg(p + (t - 7) * NW + k);
      r.store(XP + t - 7, v);
      continue;
    }
    if (t == 2) {
      Fe2 one{zero, zero};
#pragma unroll
      for (int k = 0; k < NW; ++k) one.c0.w[k] = FP_ONE[k];
      r.store(TZ, one);
      r.store(F, one);
#pragma unroll 1
      for (int j = 1; j < 6; ++j) r.store(F + j, Fe2{zero, zero});
      continue;
    }
    const int c = t < 2 ? t : (t - 3) & 1;  // 0: x, 1: y
    Fe2 v = load_fe2(q + 2 * NW * c);
    if (t < 2) {
      r.store(TX + c, v);
      r.store(Q0 + c, v);
      continue;
    }
    const int n = t < 5 ? 0 : 1;
    if (n == 0) v.c1 = coop::fe_sub(g, zero, v.c1);
    Fe2 gam;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      gam.c0.w[k] = FROB_GAMMA[n][2 + c][0][k];
      gam.c1.w[k] = FROB_GAMMA[n][2 + c][1][k];
    }
    v = coop::fe2_mul(g, v, gam);
    if (t == 6) v = gtc::fe2_neg(g, v);
    r.store((n == 0 ? Q1 : Q2) + c, v);
  }
  r.sync();
  // the bits of 6u+2 below its top, then the two closing adds (i = -1,
  // -2): on a bit the doubling's phases, on a set bit then the add's
#pragma unroll 1
  for (int s = 0; s < ATE_NBITS + 2; ++s) {
    const int i = ATE_NBITS - 1 - s;
    const bool add = i < 0 || ((ATE_BITS >> i) & 1ull);
    const int qa = i >= 0 ? Q0 : (i == -1 ? Q1 : Q2);
    // the Q of the add step after the doubling, and after the add, or -1
    const int q_dbl = add ? qa : (i == 0 ? Q1 : -1);
    const int q_add = i == 0 ? Q1 : (i == -1 ? Q2 : -1);
#pragma unroll 1
    for (int ph = i >= 0 ? PH_DBL : PH_ADD; ph < (add ? PH_END : PH_ADD); ++ph) {
      const int qn = ph < PH_ADD ? q_dbl : q_add;
      const Phase d = PHASES[ph];
      const int n = qn >= 0 ? d.n : d.n_last;
#pragma unroll 1
      for (int t = (int)r.grp; t < n; t += NG) run_task(r, d.first + t, qa, qn);
      r.sync();
    }
  }
}

// One leg by this lane of NG, its canonical f stored at row `row` of out.
// `live` is false for a row past the last: it runs (every lane takes
// part in every barrier) and stores nothing.
template <int NG>
__device__ __forceinline__ void miller_row(const Row<NG>& r, const uint32_t* __restrict__ P_,
                                           const uint32_t* __restrict__ Q_,
                                           uint32_t* __restrict__ out, int row, bool live) {
  miller_leg(r, P_ + (size_t)row * 2 * NW, Q_ + (size_t)row * 4 * NW);
  gtc::store_slot(r, F / 6, out + (size_t)row * gtc::GT_WORDS, live);
}

}  // namespace miller
}  // namespace bn254
