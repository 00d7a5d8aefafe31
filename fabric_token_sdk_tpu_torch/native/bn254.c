/* bn254 — native host BN254 arithmetic for the token framework runtime.
 *
 * The reference SDK's host math is IBM mathlib backed by gnark-crypto's
 * assembly BN254 (vendored dep; see reference token/core/zkatdlog/crypto
 * usage of `math.Curve`). Our control plane is Python; this library is its
 * native hot path: 4x64-limb Montgomery Fp, Jacobian G1, windowed scalar
 * multiplication and multi-exponentiation, batched over arrays so one
 * ctypes call covers a whole proof's worth of group ops.
 *
 * Interface convention: field elements and scalars cross the boundary as
 * 4 little-endian uint64 limbs (non-Montgomery); points as affine (x, y)
 * limb pairs plus an infinity flag byte. All conversion to/from Montgomery
 * happens inside. Plain C99 + unsigned __int128; built on demand and
 * loaded via ctypes with a pure-Python fallback (see __init__.py).
 */

#include <stdint.h>
#include <string.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

/* ------------------------------------------------------------------ Fp */

static const u64 Pmod[4] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                            0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 R2[4] = {0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                          0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL};
static const u64 N0 = 0x87d20782e4866389ULL; /* -P^-1 mod 2^64 */
static const u64 MONT_ONE[4] = {0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
                                0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL};

typedef struct { u64 v[4]; } fp;

static inline int fp_is_zero(const fp *a) {
  return (a->v[0] | a->v[1] | a->v[2] | a->v[3]) == 0;
}

static inline int fp_eq(const fp *a, const fp *b) {
  return a->v[0] == b->v[0] && a->v[1] == b->v[1] && a->v[2] == b->v[2] &&
         a->v[3] == b->v[3];
}

/* a -= P if a >= P (constant shape, not constant time — host verifier) */
static inline void fp_reduce(fp *a) {
  u64 t[4];
  u128 bw = 0;
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)a->v[i] - Pmod[i] - (u64)bw;
    t[i] = (u64)d;
    bw = (d >> 64) & 1; /* borrow */
  }
  if (!bw)
    memcpy(a->v, t, sizeof t);
}

static inline void fp_add(fp *r, const fp *a, const fp *b) {
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (u128)a->v[i] + b->v[i];
    r->v[i] = (u64)c;
    c >>= 64;
  }
  /* a, b < P < 2^254 so no limb overflow past c; subtract P if needed */
  fp_reduce(r);
}

static inline void fp_sub(fp *r, const fp *a, const fp *b) {
  u128 bw = 0;
  u64 t[4];
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)a->v[i] - b->v[i] - (u64)bw;
    t[i] = (u64)d;
    bw = (d >> 64) & 1;
  }
  if (bw) {
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
      c += (u128)t[i] + Pmod[i];
      t[i] = (u64)c;
      c >>= 64;
    }
  }
  memcpy(r->v, t, sizeof t);
}

static inline void fp_neg(fp *r, const fp *a) {
  if (fp_is_zero(a)) {
    memset(r->v, 0, sizeof r->v);
    return;
  }
  u128 bw = 0;
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)Pmod[i] - a->v[i] - (u64)bw;
    r->v[i] = (u64)d;
    bw = (d >> 64) & 1;
  }
}

/* CIOS Montgomery multiplication: r = a*b*R^-1 mod P */
static void fp_mul(fp *r, const fp *a, const fp *b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; i++) {
    u128 c = 0;
    for (int j = 0; j < 4; j++) {
      c += (u128)a->v[j] * b->v[i] + t[j];
      t[j] = (u64)c;
      c >>= 64;
    }
    c += t[4];
    t[4] = (u64)c;
    t[5] = (u64)(c >> 64);

    u64 m = t[0] * N0;
    c = (u128)m * Pmod[0] + t[0];
    c >>= 64;
    for (int j = 1; j < 4; j++) {
      c += (u128)m * Pmod[j] + t[j];
      t[j - 1] = (u64)c;
      c >>= 64;
    }
    c += t[4];
    t[3] = (u64)c;
    t[4] = t[5] + (u64)(c >> 64);
  }
  memcpy(r->v, t, 4 * sizeof(u64));
  if (t[4]) { /* result >= 2^256: subtract P once (t < 2P always in CIOS) */
    u128 bw = 0;
    for (int i = 0; i < 4; i++) {
      u128 d = (u128)r->v[i] - Pmod[i] - (u64)bw;
      r->v[i] = (u64)d;
      bw = (d >> 64) & 1;
    }
  } else {
    fp_reduce(r);
  }
}

static inline void fp_sqr(fp *r, const fp *a) { fp_mul(r, a, a); }

static void fp_to_mont(fp *r, const fp *a) {
  fp rr;
  memcpy(rr.v, R2, sizeof R2);
  fp_mul(r, a, &rr);
}

static void fp_from_mont(fp *r, const fp *a) {
  fp one = {{1, 0, 0, 0}};
  fp_mul(r, a, &one);
}

/* r = a^e mod P (a in Montgomery; e plain little-endian limbs) */
static void fp_pow(fp *r, const fp *a, const u64 e[4]) {
  fp acc, base = *a;
  memcpy(acc.v, MONT_ONE, sizeof MONT_ONE);
  for (int limb = 0; limb < 4; limb++) {
    u64 bits = e[limb];
    for (int i = 0; i < 64; i++) {
      if (bits & 1)
        fp_mul(&acc, &acc, &base);
      fp_sqr(&base, &base);
      bits >>= 1;
    }
  }
  *r = acc;
}

static void fp_inv(fp *r, const fp *a) {
  /* a^(P-2) */
  u64 e[4];
  memcpy(e, Pmod, sizeof e);
  u128 bw = 2;
  for (int i = 0; i < 4 && bw; i++) {
    u128 d = (u128)e[i] - (u64)bw;
    e[i] = (u64)d;
    bw = (d >> 64) & 1;
  }
  fp_pow(r, a, e);
}

/* ------------------------------------------------------------------ G1 */

/* Jacobian coordinates in Montgomery form; infinity <=> Z == 0. */
typedef struct { fp X, Y, Z; } g1;

static void g1_set_inf(g1 *p) { memset(p, 0, sizeof *p); }

static inline int g1_is_inf(const g1 *p) { return fp_is_zero(&p->Z); }

static void g1_from_affine(g1 *p, const fp *x, const fp *y) {
  fp_to_mont(&p->X, x);
  fp_to_mont(&p->Y, y);
  memcpy(p->Z.v, MONT_ONE, sizeof MONT_ONE);
}

static void g1_to_affine(const g1 *p, fp *x, fp *y, uint8_t *inf) {
  if (g1_is_inf(p)) {
    memset(x, 0, sizeof *x);
    memset(y, 0, sizeof *y);
    *inf = 1;
    return;
  }
  fp zi, zi2, zi3, t;
  fp_inv(&zi, &p->Z);
  fp_sqr(&zi2, &zi);
  fp_mul(&zi3, &zi2, &zi);
  fp_mul(&t, &p->X, &zi2);
  fp_from_mont(x, &t);
  fp_mul(&t, &p->Y, &zi3);
  fp_from_mont(y, &t);
  *inf = 0;
}

/* dbl-2009-l (a = 0): 2M + 5S */
static void g1_dbl(g1 *r, const g1 *p) {
  if (g1_is_inf(p) || fp_is_zero(&p->Y)) {
    g1_set_inf(r);
    return;
  }
  fp A, B, C, D, E, F, t;
  fp_sqr(&A, &p->X);
  fp_sqr(&B, &p->Y);
  fp_sqr(&C, &B);
  fp_add(&t, &p->X, &B);
  fp_sqr(&t, &t);
  fp_sub(&t, &t, &A);
  fp_sub(&t, &t, &C);
  fp_add(&D, &t, &t);
  fp_add(&E, &A, &A);
  fp_add(&E, &E, &A);
  fp_sqr(&F, &E);
  fp newX, newY, newZ;
  fp_add(&t, &D, &D);
  fp_sub(&newX, &F, &t);
  fp_sub(&t, &D, &newX);
  fp_mul(&t, &E, &t);
  fp c8;
  fp_add(&c8, &C, &C);
  fp_add(&c8, &c8, &c8);
  fp_add(&c8, &c8, &c8);
  fp_sub(&newY, &t, &c8);
  fp_mul(&newZ, &p->Y, &p->Z);
  fp_add(&newZ, &newZ, &newZ);
  r->X = newX;
  r->Y = newY;
  r->Z = newZ;
}

/* add-2007-bl: 11M + 5S, with doubling/inverse handling */
static void g1_add(g1 *r, const g1 *p, const g1 *q) {
  if (g1_is_inf(p)) {
    *r = *q;
    return;
  }
  if (g1_is_inf(q)) {
    *r = *p;
    return;
  }
  fp Z1Z1, Z2Z2, U1, U2, S1, S2, t;
  fp_sqr(&Z1Z1, &p->Z);
  fp_sqr(&Z2Z2, &q->Z);
  fp_mul(&U1, &p->X, &Z2Z2);
  fp_mul(&U2, &q->X, &Z1Z1);
  fp_mul(&t, &q->Z, &Z2Z2);
  fp_mul(&S1, &p->Y, &t);
  fp_mul(&t, &p->Z, &Z1Z1);
  fp_mul(&S2, &q->Y, &t);
  if (fp_eq(&U1, &U2)) {
    if (fp_eq(&S1, &S2)) {
      g1_dbl(r, p);
    } else {
      g1_set_inf(r);
    }
    return;
  }
  fp H, I, J, rr, V;
  fp_sub(&H, &U2, &U1);
  fp_add(&I, &H, &H);
  fp_sqr(&I, &I);
  fp_mul(&J, &H, &I);
  fp_sub(&rr, &S2, &S1);
  fp_add(&rr, &rr, &rr);
  fp_mul(&V, &U1, &I);
  fp newX, newY, newZ;
  fp_sqr(&t, &rr);
  fp_sub(&t, &t, &J);
  fp v2;
  fp_add(&v2, &V, &V);
  fp_sub(&newX, &t, &v2);
  fp_sub(&t, &V, &newX);
  fp_mul(&t, &rr, &t);
  fp s1j;
  fp_mul(&s1j, &S1, &J);
  fp_add(&s1j, &s1j, &s1j);
  fp_sub(&newY, &t, &s1j);
  fp_add(&t, &p->Z, &q->Z);
  fp_sqr(&t, &t);
  fp_sub(&t, &t, &Z1Z1);
  fp_sub(&t, &t, &Z2Z2);
  fp_mul(&newZ, &t, &H);
  r->X = newX;
  r->Y = newY;
  r->Z = newZ;
}

/* 4-bit fixed-window scalar multiplication; scalar as plain LE limbs.
 *
 * TIMING CAVEAT: this is VARIABLE-TIME — the per-digit branch (`if (d)`),
 * the `started` skip of leading zero windows, and the non-constant-time
 * fp_reduce all leak scalar-dependent timing. That was acceptable while
 * the native library served only the host VERIFIER (public scalars), but
 * hostmath.py now installs it as the fast path for proof generation and
 * signing too, where scalars are secrets (blinding factors, signing
 * keys). This matches the equally variable-time pure-Python fallback, so
 * it is not a regression — but if the threat model ever includes
 * co-located attackers able to measure wall time, a constant-time ladder
 * (fixed window read via table scan + unconditional add-and-select) must
 * replace this for prover-side calls. The same applies to g2_scalar_mul.
 */
static void g1_scalar_mul(g1 *r, const g1 *p, const u64 k[4]) {
  g1 table[16];
  g1_set_inf(&table[0]);
  table[1] = *p;
  for (int i = 2; i < 16; i++)
    g1_add(&table[i], &table[i - 1], p);
  g1 acc;
  g1_set_inf(&acc);
  int started = 0;
  for (int limb = 3; limb >= 0; limb--) {
    for (int w = 60; w >= 0; w -= 4) {
      if (started) {
        g1_dbl(&acc, &acc);
        g1_dbl(&acc, &acc);
        g1_dbl(&acc, &acc);
        g1_dbl(&acc, &acc);
      }
      unsigned d = (unsigned)((k[limb] >> w) & 0xF);
      if (d) {
        g1_add(&acc, &acc, &table[d]);
        started = 1;
      }
    }
  }
  *r = acc;
}

/* ------------------------------------------------------- exported API
 *
 * Buffers: xs/ys = n*4 u64 limbs (LE, non-Montgomery), inf = n bytes,
 * ks = n*4 u64 limbs. Outputs likewise.
 */

static void load_point(g1 *p, const u64 *xs, const u64 *ys,
                       const uint8_t *inf, long i) {
  if (inf && inf[i]) {
    g1_set_inf(p);
    return;
  }
  fp x, y;
  memcpy(x.v, xs + 4 * i, 4 * sizeof(u64));
  memcpy(y.v, ys + 4 * i, 4 * sizeof(u64));
  g1_from_affine(p, &x, &y);
}

static void store_point(const g1 *p, u64 *ox, u64 *oy, uint8_t *oinf,
                        long i) {
  fp x, y;
  uint8_t f;
  g1_to_affine(p, &x, &y, &f);
  memcpy(ox + 4 * i, x.v, 4 * sizeof(u64));
  memcpy(oy + 4 * i, y.v, 4 * sizeof(u64));
  oinf[i] = f;
}

/* out[i] = ks[i] * P[i] */
void fts_g1_mul_batch(const u64 *xs, const u64 *ys, const uint8_t *inf,
                      const u64 *ks, long n, u64 *ox, u64 *oy,
                      uint8_t *oinf) {
  for (long i = 0; i < n; i++) {
    g1 p, r;
    load_point(&p, xs, ys, inf, i);
    g1_scalar_mul(&r, &p, ks + 4 * i);
    store_point(&r, ox, oy, oinf, i);
  }
}

/* out = sum_i ks[i] * P[i] (one point out) */
void fts_g1_multiexp(const u64 *xs, const u64 *ys, const uint8_t *inf,
                     const u64 *ks, long n, u64 *ox, u64 *oy,
                     uint8_t *oinf) {
  g1 acc, p, t;
  g1_set_inf(&acc);
  for (long i = 0; i < n; i++) {
    load_point(&p, xs, ys, inf, i);
    g1_scalar_mul(&t, &p, ks + 4 * i);
    g1_add(&acc, &acc, &t);
  }
  store_point(&acc, ox, oy, oinf, 0);
}

/* out = sum_i P[i] */
void fts_g1_sum(const u64 *xs, const u64 *ys, const uint8_t *inf, long n,
                u64 *ox, u64 *oy, uint8_t *oinf) {
  g1 acc, p;
  g1_set_inf(&acc);
  for (long i = 0; i < n; i++) {
    load_point(&p, xs, ys, inf, i);
    g1_add(&acc, &acc, &p);
  }
  store_point(&acc, ox, oy, oinf, 0);
}

/* out[i] = sum over row i: one multiexp per row of fixed width m.
 * Covers Pedersen commitments (3-term) and digit aggregates in one call. */
void fts_g1_multiexp_rows(const u64 *xs, const u64 *ys, const uint8_t *inf,
                          const u64 *ks, long rows, long m, u64 *ox,
                          u64 *oy, uint8_t *oinf) {
  for (long r0 = 0; r0 < rows; r0++) {
    g1 acc, p, t;
    g1_set_inf(&acc);
    for (long j = 0; j < m; j++) {
      long i = r0 * m + j;
      load_point(&p, xs, ys, inf, i);
      g1_scalar_mul(&t, &p, ks + 4 * i);
      g1_add(&acc, &acc, &t);
    }
    store_point(&acc, ox, oy, oinf, r0);
  }
}

/* ------------------------------------------------------------------ Fp2
 * a + b i with i^2 = -1; components in Montgomery form. */

typedef struct { fp a, b; } fp2;

static const fp2 XI_M = {/* 9 + i */
    {{0xf60647ce410d7ff7ULL, 0x2f3d6f4dd31bd011ULL, 0x2943337e3940c6d1ULL,
      0x1d9598e8a7e39857ULL}},
    {{0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL, 0x666ea36f7879462cULL,
      0x0e0a77c19a07df2fULL}}};

static inline void fp2_add_(fp2 *r, const fp2 *x, const fp2 *y) {
  fp_add(&r->a, &x->a, &y->a);
  fp_add(&r->b, &x->b, &y->b);
}

static inline void fp2_sub_(fp2 *r, const fp2 *x, const fp2 *y) {
  fp_sub(&r->a, &x->a, &y->a);
  fp_sub(&r->b, &x->b, &y->b);
}

static inline void fp2_neg_(fp2 *r, const fp2 *x) {
  fp_neg(&r->a, &x->a);
  fp_neg(&r->b, &x->b);
}

static inline int fp2_is_zero(const fp2 *x) {
  return fp_is_zero(&x->a) && fp_is_zero(&x->b);
}

static inline int fp2_eq(const fp2 *x, const fp2 *y) {
  return fp_eq(&x->a, &y->a) && fp_eq(&x->b, &y->b);
}

static void fp2_mul_(fp2 *r, const fp2 *x, const fp2 *y) {
  /* Karatsuba: (a+bi)(c+di) = ac - bd + ((a+b)(c+d) - ac - bd) i */
  fp ac, bd, s1, s2, t;
  fp_mul(&ac, &x->a, &y->a);
  fp_mul(&bd, &x->b, &y->b);
  fp_add(&s1, &x->a, &x->b);
  fp_add(&s2, &y->a, &y->b);
  fp_mul(&t, &s1, &s2);
  fp_sub(&t, &t, &ac);
  fp_sub(&t, &t, &bd);
  fp_sub(&r->a, &ac, &bd);
  r->b = t;
}

static void fp2_sqr_(fp2 *r, const fp2 *x) {
  /* (a+bi)^2 = (a+b)(a-b) + 2ab i */
  fp s, d, ab;
  fp_add(&s, &x->a, &x->b);
  fp_sub(&d, &x->a, &x->b);
  fp_mul(&ab, &x->a, &x->b);
  fp_mul(&r->a, &s, &d);
  fp_add(&r->b, &ab, &ab);
}

static void fp2_inv_(fp2 *r, const fp2 *x) {
  fp n, t, ninv;
  fp_sqr(&n, &x->a);
  fp_sqr(&t, &x->b);
  fp_add(&n, &n, &t);
  fp_inv(&ninv, &n);
  fp_mul(&r->a, &x->a, &ninv);
  fp_mul(&t, &x->b, &ninv);
  fp_neg(&r->b, &t);
}

static inline void fp2_conj_(fp2 *r, const fp2 *x) {
  r->a = x->a;
  fp_neg(&r->b, &x->b);
}

static inline void fp2_dbl_(fp2 *r, const fp2 *x) { fp2_add_(r, x, x); }

/* ------------------------------------------------------------------ G2
 * Jacobian over Fp2 on the D-twist y^2 = x^3 + 3/XI; infinity <=> Z = 0.
 * Same a = 0 formulas as G1. */

typedef struct { fp2 X, Y, Z; } g2;

static void g2_set_inf(g2 *p) { memset(p, 0, sizeof *p); }

static inline int g2_is_inf(const g2 *p) { return fp2_is_zero(&p->Z); }

static void g2_from_affine(g2 *p, const fp2 *x, const fp2 *y) {
  fp_to_mont(&p->X.a, &x->a);
  fp_to_mont(&p->X.b, &x->b);
  fp_to_mont(&p->Y.a, &y->a);
  fp_to_mont(&p->Y.b, &y->b);
  memcpy(p->Z.a.v, MONT_ONE, sizeof MONT_ONE);
  memset(p->Z.b.v, 0, sizeof p->Z.b.v);
}

static void g2_to_affine_mont(const g2 *p, fp2 *x, fp2 *y, uint8_t *inf) {
  if (g2_is_inf(p)) {
    memset(x, 0, sizeof *x);
    memset(y, 0, sizeof *y);
    *inf = 1;
    return;
  }
  fp2 zi, zi2, zi3;
  fp2_inv_(&zi, &p->Z);
  fp2_sqr_(&zi2, &zi);
  fp2_mul_(&zi3, &zi2, &zi);
  fp2_mul_(x, &p->X, &zi2);
  fp2_mul_(y, &p->Y, &zi3);
  *inf = 0;
}

static void g2_dbl(g2 *r, const g2 *p) {
  if (g2_is_inf(p) || fp2_is_zero(&p->Y)) {
    g2_set_inf(r);
    return;
  }
  fp2 A, B, C, D, E, F, t, newX, newY, newZ, c8;
  fp2_sqr_(&A, &p->X);
  fp2_sqr_(&B, &p->Y);
  fp2_sqr_(&C, &B);
  fp2_add_(&t, &p->X, &B);
  fp2_sqr_(&t, &t);
  fp2_sub_(&t, &t, &A);
  fp2_sub_(&t, &t, &C);
  fp2_dbl_(&D, &t);
  fp2_dbl_(&E, &A);
  fp2_add_(&E, &E, &A);
  fp2_sqr_(&F, &E);
  fp2_dbl_(&t, &D);
  fp2_sub_(&newX, &F, &t);
  fp2_sub_(&t, &D, &newX);
  fp2_mul_(&t, &E, &t);
  fp2_dbl_(&c8, &C);
  fp2_dbl_(&c8, &c8);
  fp2_dbl_(&c8, &c8);
  fp2_sub_(&newY, &t, &c8);
  fp2_mul_(&newZ, &p->Y, &p->Z);
  fp2_dbl_(&newZ, &newZ);
  r->X = newX;
  r->Y = newY;
  r->Z = newZ;
}

static void g2_add_(g2 *r, const g2 *p, const g2 *q) {
  if (g2_is_inf(p)) {
    *r = *q;
    return;
  }
  if (g2_is_inf(q)) {
    *r = *p;
    return;
  }
  fp2 Z1Z1, Z2Z2, U1, U2, S1, S2, t;
  fp2_sqr_(&Z1Z1, &p->Z);
  fp2_sqr_(&Z2Z2, &q->Z);
  fp2_mul_(&U1, &p->X, &Z2Z2);
  fp2_mul_(&U2, &q->X, &Z1Z1);
  fp2_mul_(&t, &q->Z, &Z2Z2);
  fp2_mul_(&S1, &p->Y, &t);
  fp2_mul_(&t, &p->Z, &Z1Z1);
  fp2_mul_(&S2, &q->Y, &t);
  if (fp2_eq(&U1, &U2)) {
    if (fp2_eq(&S1, &S2))
      g2_dbl(r, p);
    else
      g2_set_inf(r);
    return;
  }
  fp2 H, I, J, rr, V, newX, newY, newZ, v2, s1j;
  fp2_sub_(&H, &U2, &U1);
  fp2_dbl_(&I, &H);
  fp2_sqr_(&I, &I);
  fp2_mul_(&J, &H, &I);
  fp2_sub_(&rr, &S2, &S1);
  fp2_dbl_(&rr, &rr);
  fp2_mul_(&V, &U1, &I);
  fp2_sqr_(&t, &rr);
  fp2_sub_(&t, &t, &J);
  fp2_dbl_(&v2, &V);
  fp2_sub_(&newX, &t, &v2);
  fp2_sub_(&t, &V, &newX);
  fp2_mul_(&t, &rr, &t);
  fp2_mul_(&s1j, &S1, &J);
  fp2_dbl_(&s1j, &s1j);
  fp2_sub_(&newY, &t, &s1j);
  fp2_add_(&t, &p->Z, &q->Z);
  fp2_sqr_(&t, &t);
  fp2_sub_(&t, &t, &Z1Z1);
  fp2_sub_(&t, &t, &Z2Z2);
  fp2_mul_(&newZ, &t, &H);
  r->X = newX;
  r->Y = newY;
  r->Z = newZ;
}

static void g2_scalar_mul(g2 *r, const g2 *p, const u64 k[4]) {
  g2 table[16];
  g2_set_inf(&table[0]);
  table[1] = *p;
  for (int i = 2; i < 16; i++)
    g2_add_(&table[i], &table[i - 1], p);
  g2 acc;
  g2_set_inf(&acc);
  int started = 0;
  for (int limb = 3; limb >= 0; limb--) {
    for (int w = 60; w >= 0; w -= 4) {
      if (started) {
        g2_dbl(&acc, &acc);
        g2_dbl(&acc, &acc);
        g2_dbl(&acc, &acc);
        g2_dbl(&acc, &acc);
      }
      unsigned d = (unsigned)((k[limb] >> w) & 0xF);
      if (d) {
        g2_add_(&acc, &acc, &table[d]);
        started = 1;
      }
    }
  }
  *r = acc;
}

/* ----------------------------------------------------------------- Fp12
 * Flat basis c = sum_j c[j] w^j, c[j] in Fp2, w^6 = XI — mirrors the
 * pure-Python twin (crypto/hostmath.py) coefficient-for-coefficient so
 * the two paths are differentially testable. */

typedef struct { fp2 c[6]; } fp12;

/* Frobenius gammas XI^(j(P-1)/6), Montgomery (a, b) pairs. */
static const fp2 GAMMA[6] = {
    {{{0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL, 0x666ea36f7879462cULL,
       0x0e0a77c19a07df2fULL}},
     {{0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
       0x0000000000000000ULL}}},
    {{{0xaf9ba69633144907ULL, 0xca6b1d7387afb78aULL, 0x11bded5ef08a2087ULL,
       0x02f34d751a1f3a7cULL}},
     {{0xa222ae234c492d72ULL, 0xd00f02a4565de15bULL, 0xdc2ff3a253dfc926ULL,
       0x10a75716b3899551ULL}}},
    {{{0xb5773b104563ab30ULL, 0x347f91c8a9aa6454ULL, 0x7a007127242e0991ULL,
       0x1956bcd8118214ecULL}},
     {{0x6e849f1ea0aa4757ULL, 0xaa1c7b6d89f89141ULL, 0xb6e713cdfae0ca3aULL,
       0x26694fbb4e82ebc3ULL}}},
    {{{0xe4bbdd0c2936b629ULL, 0xbb30f162e133bacbULL, 0x31a9d1b6f9645366ULL,
       0x253570bea500f8ddULL}},
     {{0xa1d77ce45ffe77c7ULL, 0x07affd117826d1dbULL, 0x6d16bd27bb7edc6bULL,
       0x2c87200285defeccULL}}},
    {{{0x7361d77f843abe92ULL, 0xa5bb2bd3273411fbULL, 0x9c941f314b3e2399ULL,
       0x15df9cddbb9fd3ecULL}},
     {{0x5dddfd154bd8c949ULL, 0x62cb29a5a4445b60ULL, 0x37bc870a0c7dd2b9ULL,
       0x24830a9d3171f0fdULL}}},
    {{{0xc970692f41690fe7ULL, 0xe240342127694b0bULL, 0x32bee66b83c459e8ULL,
       0x12aabced0ab08841ULL}},
     {{0x0d485d2340aebfa9ULL, 0x05193418ab2fcc57ULL, 0xd3b0a40b8a4910f5ULL,
       0x2f21ebb535d2925aULL}}}};

static void fp12_set_one(fp12 *r) {
  memset(r, 0, sizeof *r);
  memcpy(r->c[0].a.v, MONT_ONE, sizeof MONT_ONE);
}

static int fp12_is_one(const fp12 *x) {
  fp one;
  memcpy(one.v, MONT_ONE, sizeof MONT_ONE);
  if (!fp_eq(&x->c[0].a, &one) || !fp_is_zero(&x->c[0].b))
    return 0;
  for (int j = 1; j < 6; j++)
    if (!fp2_is_zero(&x->c[j]))
      return 0;
  return 1;
}

static int fp12_eq(const fp12 *x, const fp12 *y) {
  for (int j = 0; j < 6; j++)
    if (!fp2_eq(&x->c[j], &y->c[j]))
      return 0;
  return 1;
}

static void fp12_add_(fp12 *r, const fp12 *x, const fp12 *y) {
  for (int j = 0; j < 6; j++)
    fp2_add_(&r->c[j], &x->c[j], &y->c[j]);
}

static void fp12_sub_(fp12 *r, const fp12 *x, const fp12 *y) {
  for (int j = 0; j < 6; j++)
    fp2_sub_(&r->c[j], &x->c[j], &y->c[j]);
}

static void fp12_neg_(fp12 *r, const fp12 *x) {
  for (int j = 0; j < 6; j++)
    fp2_neg_(&r->c[j], &x->c[j]);
}

static void fp12_mul_(fp12 *r, const fp12 *x, const fp12 *y) {
  /* schoolbook 6x6 with w^6 = XI folding (mirrors hostmath.fp12_mul) */
  fp2 acc[6];
  memset(acc, 0, sizeof acc);
  for (int jx = 0; jx < 6; jx++) {
    if (fp2_is_zero(&x->c[jx]))
      continue;
    for (int jy = 0; jy < 6; jy++) {
      if (fp2_is_zero(&y->c[jy]))
        continue;
      fp2 t;
      fp2_mul_(&t, &x->c[jx], &y->c[jy]);
      int j = jx + jy;
      if (j >= 6) {
        j -= 6;
        fp2_mul_(&t, &t, &XI_M);
      }
      fp2_add_(&acc[j], &acc[j], &t);
    }
  }
  memcpy(r->c, acc, sizeof acc);
}

static void fp12_sqr_(fp12 *r, const fp12 *x);

static void fp12_conj_(fp12 *r, const fp12 *x) {
  for (int j = 0; j < 6; j++) {
    if (j & 1)
      fp2_neg_(&r->c[j], &x->c[j]);
    else
      r->c[j] = x->c[j];
  }
}

static void fp12_frobenius1(fp12 *r, const fp12 *x) {
  for (int j = 0; j < 6; j++) {
    fp2 t;
    fp2_conj_(&t, &x->c[j]);
    fp2_mul_(&r->c[j], &t, &GAMMA[j]);
  }
}

static void fp12_frobenius(fp12 *r, const fp12 *x, int n) {
  fp12 t = *x;
  for (int i = 0; i < n; i++)
    fp12_frobenius1(&t, &t);
  *r = t;
}

/* tower split for inversion: Fp6 = Fp2[v]/(v^3 - XI), v = w^2 */
typedef struct { fp2 a0, a1, a2; } fp6t;

static void fp6_mul_(fp6t *r, const fp6t *a, const fp6t *b) {
  fp2 t0, t1, t2, s1, s2, u, c0, c1, c2;
  fp2_mul_(&t0, &a->a0, &b->a0);
  fp2_mul_(&t1, &a->a1, &b->a1);
  fp2_mul_(&t2, &a->a2, &b->a2);
  /* c0 = t0 + XI((a1+a2)(b1+b2) - t1 - t2) */
  fp2_add_(&s1, &a->a1, &a->a2);
  fp2_add_(&s2, &b->a1, &b->a2);
  fp2_mul_(&u, &s1, &s2);
  fp2_sub_(&u, &u, &t1);
  fp2_sub_(&u, &u, &t2);
  fp2_mul_(&u, &u, &XI_M);
  fp2_add_(&c0, &t0, &u);
  /* c1 = (a0+a1)(b0+b1) - t0 - t1 + XI t2 */
  fp2_add_(&s1, &a->a0, &a->a1);
  fp2_add_(&s2, &b->a0, &b->a1);
  fp2_mul_(&u, &s1, &s2);
  fp2_sub_(&u, &u, &t0);
  fp2_sub_(&u, &u, &t1);
  fp2 xit2;
  fp2_mul_(&xit2, &t2, &XI_M);
  fp2_add_(&c1, &u, &xit2);
  /* c2 = (a0+a2)(b0+b2) - t0 - t2 + t1 */
  fp2_add_(&s1, &a->a0, &a->a2);
  fp2_add_(&s2, &b->a0, &b->a2);
  fp2_mul_(&u, &s1, &s2);
  fp2_sub_(&u, &u, &t0);
  fp2_sub_(&u, &u, &t2);
  fp2_add_(&c2, &u, &t1);
  r->a0 = c0;
  r->a1 = c1;
  r->a2 = c2;
}

static void fp6_mul_v(fp6t *r, const fp6t *a) {
  fp2 t;
  fp2_mul_(&t, &a->a2, &XI_M);
  r->a2 = a->a1;
  r->a1 = a->a0;
  r->a0 = t;
}

static void fp6_sub_(fp6t *r, const fp6t *a, const fp6t *b) {
  fp2_sub_(&r->a0, &a->a0, &b->a0);
  fp2_sub_(&r->a1, &a->a1, &b->a1);
  fp2_sub_(&r->a2, &a->a2, &b->a2);
}

static void fp6_neg_(fp6t *r, const fp6t *a) {
  fp2_neg_(&r->a0, &a->a0);
  fp2_neg_(&r->a1, &a->a1);
  fp2_neg_(&r->a2, &a->a2);
}

static void fp6_inv_(fp6t *r, const fp6t *a) {
  fp2 c0, c1, c2, t, u, tinv;
  /* c0 = a0^2 - XI a1 a2 */
  fp2_sqr_(&c0, &a->a0);
  fp2_mul_(&t, &a->a1, &a->a2);
  fp2_mul_(&t, &t, &XI_M);
  fp2_sub_(&c0, &c0, &t);
  /* c1 = XI a2^2 - a0 a1 */
  fp2_sqr_(&c1, &a->a2);
  fp2_mul_(&c1, &c1, &XI_M);
  fp2_mul_(&t, &a->a0, &a->a1);
  fp2_sub_(&c1, &c1, &t);
  /* c2 = a1^2 - a0 a2 */
  fp2_sqr_(&c2, &a->a1);
  fp2_mul_(&t, &a->a0, &a->a2);
  fp2_sub_(&c2, &c2, &t);
  /* t = XI(a2 c1 + a1 c2) + a0 c0 */
  fp2_mul_(&t, &a->a2, &c1);
  fp2_mul_(&u, &a->a1, &c2);
  fp2_add_(&t, &t, &u);
  fp2_mul_(&t, &t, &XI_M);
  fp2_mul_(&u, &a->a0, &c0);
  fp2_add_(&t, &t, &u);
  fp2_inv_(&tinv, &t);
  fp2_mul_(&r->a0, &c0, &tinv);
  fp2_mul_(&r->a1, &c1, &tinv);
  fp2_mul_(&r->a2, &c2, &tinv);
}

static void fp12_split(const fp12 *x, fp6t *c0, fp6t *c1) {
  c0->a0 = x->c[0];
  c0->a1 = x->c[2];
  c0->a2 = x->c[4];
  c1->a0 = x->c[1];
  c1->a1 = x->c[3];
  c1->a2 = x->c[5];
}

static void fp12_join(fp12 *r, const fp6t *c0, const fp6t *c1) {
  r->c[0] = c0->a0;
  r->c[1] = c1->a0;
  r->c[2] = c0->a1;
  r->c[3] = c1->a1;
  r->c[4] = c0->a2;
  r->c[5] = c1->a2;
}

static void fp6_add_(fp6t *r, const fp6t *a, const fp6t *b) {
  fp2_add_(&r->a0, &a->a0, &b->a0);
  fp2_add_(&r->a1, &a->a1, &b->a1);
  fp2_add_(&r->a2, &a->a2, &b->a2);
}

/* x^2 via the tower: (c0 + c1 w)^2 = (c0^2 + v c1^2) + 2 c0 c1 w.
 * 3 Fp6 muls (18 Fp2 muls) vs 36 for schoolbook — final exponentiation
 * is squaring-dominated, so this roughly halves pairing cost. */
static void fp12_sqr_(fp12 *r, const fp12 *x) {
  fp6t c0, c1, t0, t1, vc1, s, r0, r1;
  fp12_split(x, &c0, &c1);
  fp6_mul_(&t0, &c0, &c0);
  fp6_mul_(&t1, &c1, &c1);
  fp6_mul_v(&vc1, &t1);
  fp6_add_(&r0, &t0, &vc1);
  /* 2 c0 c1 = (c0 + c1)^2 - c0^2 - c1^2 */
  fp6_add_(&s, &c0, &c1);
  fp6_mul_(&r1, &s, &s);
  fp6_sub_(&r1, &r1, &t0);
  fp6_sub_(&r1, &r1, &t1);
  fp12_join(r, &r0, &r1);
}

static void fp12_inv_(fp12 *r, const fp12 *x) {
  fp6t c0, c1, n, t, ninv, r0, r1;
  fp12_split(x, &c0, &c1);
  fp6_mul_(&n, &c0, &c0);
  fp6_mul_(&t, &c1, &c1);
  fp6_mul_v(&t, &t);
  fp6_sub_(&n, &n, &t);
  fp6_inv_(&ninv, &n);
  fp6_mul_(&r0, &c0, &ninv);
  fp6_mul_(&r1, &c1, &ninv);
  fp6_neg_(&r1, &r1);
  fp12_join(r, &r0, &r1);
}

/* ------------------------------------------------------------- pairing
 * Optimal ate, mirroring the Python twin: untwist into E(Fp12), affine
 * Miller loop over 6u+2, two Frobenius line corrections, final
 * exponentiation = easy part x hard-part square-and-multiply. */

typedef struct { fp12 x, y; int inf; } e12;

/* line through t1,t2 evaluated at (px, py) embedded in Fp12 */
static void linefunc(fp12 *out, const e12 *t1, const e12 *t2,
                     const fp12 *px12, const fp12 *py12) {
  fp12 m, t, u;
  if (!fp12_eq(&t1->x, &t2->x)) {
    fp12_sub_(&t, &t2->y, &t1->y);
    fp12_sub_(&u, &t2->x, &t1->x);
    fp12_inv_(&u, &u);
    fp12_mul_(&m, &t, &u);
  } else if (fp12_eq(&t1->y, &t2->y)) {
    fp12_sqr_(&t, &t1->x);
    fp12 t3;
    fp12_add_(&t3, &t, &t);
    fp12_add_(&t, &t3, &t);
    fp12_add_(&u, &t1->y, &t1->y);
    fp12_inv_(&u, &u);
    fp12_mul_(&m, &t, &u);
  } else {
    fp12_sub_(out, px12, &t1->x);
    return;
  }
  fp12_sub_(&t, px12, &t1->x);
  fp12_mul_(&t, &m, &t);
  fp12_sub_(&u, py12, &t1->y);
  fp12_sub_(out, &t, &u);
}

static void e12_add(e12 *r, const e12 *p1, const e12 *p2) {
  if (p1->inf) {
    *r = *p2;
    return;
  }
  if (p2->inf) {
    *r = *p1;
    return;
  }
  fp12 m, t, u;
  if (fp12_eq(&p1->x, &p2->x)) {
    fp12_add_(&t, &p1->y, &p2->y);
    fp12 zero;
    memset(&zero, 0, sizeof zero);
    if (fp12_eq(&t, &zero)) {
      r->inf = 1;
      memset(&r->x, 0, sizeof r->x);
      memset(&r->y, 0, sizeof r->y);
      return;
    }
    fp12_sqr_(&t, &p1->x);
    fp12 t3;
    fp12_add_(&t3, &t, &t);
    fp12_add_(&t, &t3, &t);
    fp12_add_(&u, &p1->y, &p1->y);
    fp12_inv_(&u, &u);
    fp12_mul_(&m, &t, &u);
  } else {
    fp12_sub_(&t, &p2->y, &p1->y);
    fp12_sub_(&u, &p2->x, &p1->x);
    fp12_inv_(&u, &u);
    fp12_mul_(&m, &t, &u);
  }
  fp12 x3, y3;
  fp12_sqr_(&x3, &m);
  fp12_sub_(&x3, &x3, &p1->x);
  fp12_sub_(&x3, &x3, &p2->x);
  fp12_sub_(&t, &p1->x, &x3);
  fp12_mul_(&t, &m, &t);
  fp12_sub_(&y3, &t, &p1->y);
  r->x = x3;
  r->y = y3;
  r->inf = 0;
}

/* low 64 bits of 6u+2 (bit 64, the leading 1, is implicit) */
static const u64 ATE_LOW = 0x9d797039be763ba8ULL;

/* G1 point (affine, Montgomery) and G2 point (affine fp2, Montgomery) ->
 * Miller loop value accumulated into f (callers chain products). */
static void miller_accum(fp12 *f, const fp *px, const fp *py,
                         const fp2 *qx, const fp2 *qy) {
  fp12 px12, py12;
  memset(&px12, 0, sizeof px12);
  memset(&py12, 0, sizeof py12);
  px12.c[0].a = *px;
  py12.c[0].a = *py;
  /* untwist: (x, y) -> (x w^2, y w^3) */
  e12 qe, t;
  memset(&qe, 0, sizeof qe);
  qe.x.c[2] = *qx;
  qe.y.c[3] = *qy;
  qe.inf = 0;
  t = qe;
  fp12 acc, l;
  fp12_set_one(&acc);
  for (int i = 63; i >= 0; i--) {
    fp12_sqr_(&acc, &acc);
    linefunc(&l, &t, &t, &px12, &py12);
    fp12_mul_(&acc, &acc, &l);
    e12_add(&t, &t, &t);
    if ((ATE_LOW >> i) & 1) {
      linefunc(&l, &t, &qe, &px12, &py12);
      fp12_mul_(&acc, &acc, &l);
      e12_add(&t, &t, &qe);
    }
  }
  /* Frobenius corrections: Q1 = pi(Q), Q2 = -pi^2(Q) */
  e12 q1, nq2;
  fp12_frobenius(&q1.x, &qe.x, 1);
  fp12_frobenius(&q1.y, &qe.y, 1);
  q1.inf = 0;
  fp12_frobenius(&nq2.x, &q1.x, 1);
  fp12_frobenius(&nq2.y, &q1.y, 1);
  fp12_neg_(&nq2.y, &nq2.y);
  nq2.inf = 0;
  linefunc(&l, &t, &q1, &px12, &py12);
  fp12_mul_(&acc, &acc, &l);
  e12_add(&t, &t, &q1);
  linefunc(&l, &t, &nq2, &px12, &py12);
  fp12_mul_(&acc, &acc, &l);
  fp12_mul_(f, f, &acc);
}

/* hard part exponent (p^4 - p^2 + 1)/r, 761 bits */
static const u64 FE_HARD[12] = {
    0xe81bb482ccdf42b1ULL, 0x5abf5cc4f49c36d4ULL, 0xf1154e7e1da014fdULL,
    0xdcc7b44c87cdbacfULL, 0xaaa441e3954bcf8aULL, 0x6b887d56d5095f23ULL,
    0x79581e16f3fd90c6ULL, 0x3b1b1355d189227dULL, 0x4e529a5861876f6bULL,
    0x6c0eb522d5b12278ULL, 0x331ec15183177fafULL, 0x01baaa710b0759adULL};

static void final_exp_(fp12 *r, const fp12 *f) {
  fp12 t, u;
  /* easy: f^(p^6-1) = conj(f) * f^-1, then ^(p^2+1) */
  fp12_conj_(&t, f);
  fp12_inv_(&u, f);
  fp12_mul_(&t, &t, &u);
  fp12_frobenius(&u, &t, 2);
  fp12_mul_(&t, &u, &t);
  /* hard part: square-and-multiply over FE_HARD */
  fp12 acc, base = t;
  fp12_set_one(&acc);
  for (int limb = 0; limb < 12; limb++) {
    u64 bits = FE_HARD[limb];
    for (int i = 0; i < 64; i++) {
      if (bits & 1)
        fp12_mul_(&acc, &acc, &base);
      fp12_sqr_(&base, &base);
      bits >>= 1;
    }
  }
  *r = acc;
}

/* -------------------------------------------------- exported API (G2/GT)
 * G2 points cross as 16 u64: x.a, x.b, y.a, y.b (4 LE limbs each,
 * non-Montgomery). GT crosses as 48 u64: flat w-basis c[j] = (a, b),
 * j = 0..5, non-Montgomery. */

static void load_g2(g2 *p, const u64 *coords, const uint8_t *inf, long i) {
  if (inf && inf[i]) {
    g2_set_inf(p);
    return;
  }
  fp2 x, y;
  memcpy(x.a.v, coords + 16 * i, 4 * sizeof(u64));
  memcpy(x.b.v, coords + 16 * i + 4, 4 * sizeof(u64));
  memcpy(y.a.v, coords + 16 * i + 8, 4 * sizeof(u64));
  memcpy(y.b.v, coords + 16 * i + 12, 4 * sizeof(u64));
  g2_from_affine(p, &x, &y);
}

static void store_g2(const g2 *p, u64 *out, uint8_t *oinf, long i) {
  fp2 xm, ym;
  uint8_t f;
  g2_to_affine_mont(p, &xm, &ym, &f);
  oinf[i] = f;
  if (f) {
    memset(out + 16 * i, 0, 16 * sizeof(u64));
    return;
  }
  fp t;
  fp_from_mont(&t, &xm.a);
  memcpy(out + 16 * i, t.v, 4 * sizeof(u64));
  fp_from_mont(&t, &xm.b);
  memcpy(out + 16 * i + 4, t.v, 4 * sizeof(u64));
  fp_from_mont(&t, &ym.a);
  memcpy(out + 16 * i + 8, t.v, 4 * sizeof(u64));
  fp_from_mont(&t, &ym.b);
  memcpy(out + 16 * i + 12, t.v, 4 * sizeof(u64));
}

static void store_gt(const fp12 *x, u64 *out) {
  for (int j = 0; j < 6; j++) {
    fp t;
    fp_from_mont(&t, &x->c[j].a);
    memcpy(out + 8 * j, t.v, 4 * sizeof(u64));
    fp_from_mont(&t, &x->c[j].b);
    memcpy(out + 8 * j + 4, t.v, 4 * sizeof(u64));
  }
}

void fts_g2_mul_batch(const u64 *coords, const uint8_t *inf, const u64 *ks,
                      long n, u64 *out, uint8_t *oinf) {
  for (long i = 0; i < n; i++) {
    g2 p, r;
    load_g2(&p, coords, inf, i);
    g2_scalar_mul(&r, &p, ks + 4 * i);
    store_g2(&r, out, oinf, i);
  }
}

void fts_g2_multiexp(const u64 *coords, const uint8_t *inf, const u64 *ks,
                     long n, u64 *out, uint8_t *oinf) {
  g2 acc, p, t;
  g2_set_inf(&acc);
  for (long i = 0; i < n; i++) {
    load_g2(&p, coords, inf, i);
    g2_scalar_mul(&t, &p, ks + 4 * i);
    g2_add_(&acc, &acc, &t);
  }
  store_g2(&acc, out, oinf, 0);
}

void fts_g2_sum(const u64 *coords, const uint8_t *inf, long n, u64 *out,
                uint8_t *oinf) {
  g2 acc, p;
  g2_set_inf(&acc);
  for (long i = 0; i < n; i++) {
    load_g2(&p, coords, inf, i);
    g2_add_(&acc, &acc, &p);
  }
  store_g2(&acc, out, oinf, 0);
}

/* prod_i e(P_i, Q_i) with one shared final exponentiation.
 * Pairs with an infinite side contribute the identity. Returns the GT
 * element; `is_one` out-param set when the product is unity. */
void fts_pairing_product(const u64 *g1xs, const u64 *g1ys,
                         const uint8_t *g1inf, const u64 *g2coords,
                         const uint8_t *g2inf, long n, u64 *out,
                         uint8_t *is_one) {
  fp12 f;
  fp12_set_one(&f);
  for (long i = 0; i < n; i++) {
    if ((g1inf && g1inf[i]) || (g2inf && g2inf[i]))
      continue;
    fp px, py;
    fp2 qx, qy;
    memcpy(px.v, g1xs + 4 * i, 4 * sizeof(u64));
    memcpy(py.v, g1ys + 4 * i, 4 * sizeof(u64));
    fp pxm, pym;
    fp_to_mont(&pxm, &px);
    fp_to_mont(&pym, &py);
    fp t;
    memcpy(t.v, g2coords + 16 * i, 4 * sizeof(u64));
    fp_to_mont(&qx.a, &t);
    memcpy(t.v, g2coords + 16 * i + 4, 4 * sizeof(u64));
    fp_to_mont(&qx.b, &t);
    memcpy(t.v, g2coords + 16 * i + 8, 4 * sizeof(u64));
    fp_to_mont(&qy.a, &t);
    memcpy(t.v, g2coords + 16 * i + 12, 4 * sizeof(u64));
    fp_to_mont(&qy.b, &t);
    miller_accum(&f, &pxm, &pym, &qx, &qy);
  }
  fp12 e;
  final_exp_(&e, &f);
  store_gt(&e, out);
  *is_one = (uint8_t)fp12_is_one(&e);
}
