"""Host (pure-Python) BN254 math — the framework's correctness anchor.

The reference SDK delegates all group/pairing math to IBM mathlib (backed by
gnark-crypto); see e.g. reference token/core/zkatdlog/crypto/setup.go:13 and
pssign/sign.go:153 (`Curve.Pairing2`, `Curve.FExp`). This module is the
control-plane twin of the TPU limb-tensor kernels in
``fabric_token_sdk_tpu.ops``: same curve (BN254 / alt_bn128), same canonical
serialization, used for setup, single-shot host ops, and differential tests
against the batched device path.

Representation choices (host-only, speed via Python big ints):
  Fp      : int mod P
  Fp2     : (a, b) = a + b*i,           i^2 = -1
  Fp12    : 6-tuple of Fp2 over basis {1, w, ..., w^5},  w^6 = XI = 9 + i
  G1      : (x, y) ints, None = infinity  (y^2 = x^3 + 3)
  G2      : (x, y) Fp2 pairs, None = infinity (y^2 = x^3 + 3/XI, D-twist)
  GT      : Fp12

Pairing: optimal ate, Miller loop over 6u+2 with the two Frobenius line
corrections, final exponentiation (p^12-1)/r.
"""

from __future__ import annotations

import hashlib
import secrets

# ---------------------------------------------------------------- constants

# BN parameter u and derived primes (p = 36u^4+36u^3+24u^2+6u+1, etc.)
U = 4965661367192848881
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
ATE_LOOP = 6 * U + 2

B1 = 3  # G1: y^2 = x^3 + 3
G1_GEN = (1, 2)

# Standard alt_bn128 G2 generator (EIP-197 ordering: x = x0 + x1*i).
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

# ---------------------------------------------------------------- Fp

def fp_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fp_sqrt(a: int):
    """Square root in Fp (P = 3 mod 4); returns None if a is not a QR."""
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a % P else None


# ---------------------------------------------------------------- Fp2

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)
XI = (9, 1)  # 9 + i, the sextic non-residue


def fp2(a: int, b: int = 0):
    return (a % P, b % P)


def fp2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def fp2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def fp2_neg(x):
    return (-x[0] % P, -x[1] % P)


def fp2_mul(x, y):
    a, b = x
    c, d = y
    ac = a * c
    bd = b * d
    # (a+bi)(c+di) = ac - bd + ((a+b)(c+d) - ac - bd) i
    return ((ac - bd) % P, ((a + b) * (c + d) - ac - bd) % P)


def fp2_sqr(x):
    a, b = x
    # (a+bi)^2 = (a+b)(a-b) + 2ab i
    return ((a + b) * (a - b) % P, 2 * a * b % P)


def fp2_scale(x, k: int):
    return (x[0] * k % P, x[1] * k % P)


def fp2_conj(x):
    return (x[0], -x[1] % P)


def fp2_inv(x):
    a, b = x
    n = fp_inv((a * a + b * b) % P)
    return (a * n % P, -b * n % P)


def fp2_sqrt(a):
    """Square root in Fp2 via the norm trick (valid for P = 3 mod 4)."""
    x, y = a
    if y == 0:
        r = fp_sqrt(x)
        if r is not None:
            return (r, 0)
        r = fp_sqrt(-x % P)
        return None if r is None else (0, r)
    s = fp_sqrt((x * x + y * y) % P)
    if s is None:
        return None
    half = fp_inv(2)
    for cand in ((x + s) * half % P, (x - s) * half % P):
        t = fp_sqrt(cand)
        if t is not None and t != 0:
            res = (t, y * fp_inv(2 * t % P) % P)
            if fp2_sqr(res) == (x % P, y % P):
                return res
    return None


def fp2_pow(x, e: int):
    if e < 0:
        return fp2_pow(fp2_inv(x), -e)
    acc = FP2_ONE
    base = x
    while e:
        if e & 1:
            acc = fp2_mul(acc, base)
        base = fp2_sqr(base)
        e >>= 1
    return acc


# ---------------------------------------------------------------- Fp12
# Flat representation: c = sum_j c[j] w^j, c[j] in Fp2, w^6 = XI.
# Tower view used for inversion: Fp6 = Fp2[v]/(v^3 - XI) with v = w^2,
# Fp12 = Fp6[w]/(w^2 - v).

FP12_ZERO = tuple(FP2_ZERO for _ in range(6))
FP12_ONE = (FP2_ONE,) + tuple(FP2_ZERO for _ in range(5))

# Frobenius coefficients gamma_j = XI^(j*(P-1)/6)
_G = [fp2_pow(XI, j * (P - 1) // 6) for j in range(6)]


def fp12_from_fp2(x):
    return (x,) + tuple(FP2_ZERO for _ in range(5))


def fp12_from_int(k: int):
    return fp12_from_fp2(fp2(k))


def fp12_add(x, y):
    return tuple(fp2_add(a, b) for a, b in zip(x, y))


def fp12_sub(x, y):
    return tuple(fp2_sub(a, b) for a, b in zip(x, y))


def fp12_neg(x):
    return tuple(fp2_neg(a) for a in x)


def fp12_mul(x, y):
    # schoolbook 6x6 with w^6 = XI folding
    acc = [[0, 0] for _ in range(6)]
    for jx in range(6):
        a = x[jx]
        if a == FP2_ZERO:
            continue
        for jy in range(6):
            b = y[jy]
            if b == FP2_ZERO:
                continue
            t = fp2_mul(a, b)
            j = jx + jy
            if j >= 6:
                j -= 6
                t = fp2_mul(t, XI)
            acc[j][0] += t[0]
            acc[j][1] += t[1]
    return tuple((c[0] % P, c[1] % P) for c in acc)


def fp12_sqr(x):
    return fp12_mul(x, x)


def fp12_scale_fp2(x, s):
    return tuple(fp2_mul(c, s) for c in x)


def fp12_conj(x):
    """Conjugate over Fp6 (negate odd powers of w) — inverse on unit cyclo."""
    return tuple(fp2_neg(c) if j & 1 else c for j, c in enumerate(x))


# --- tower split helpers: Fp12 = (c0 + c1 w), c0,c1 in Fp6 = (a0,a1,a2) ---

def _split(x):
    return (x[0], x[2], x[4]), (x[1], x[3], x[5])


def _join(c0, c1):
    return (c0[0], c1[0], c0[1], c1[1], c0[2], c1[2])


def _fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    c0 = fp2_add(t0, fp2_mul(XI, fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), fp2_add(t1, t2))))
    c1 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), fp2_add(t0, t1)), fp2_mul(XI, t2))
    c2 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), fp2_add(t0, t2)), t1)
    return (c0, c1, c2)


def _fp6_mul_v(a):
    a0, a1, a2 = a
    return (fp2_mul(XI, a2), a0, a1)


def _fp6_neg(a):
    return tuple(fp2_neg(c) for c in a)


def _fp6_sub(a, b):
    return tuple(fp2_sub(x, y) for x, y in zip(a, b))


def _fp6_inv(a):
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sqr(a0), fp2_mul(XI, fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul(XI, fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    t = fp2_mul(a2, c1)
    t = fp2_add(t, fp2_mul(a1, c2))
    t = fp2_mul(XI, t)
    t = fp2_add(t, fp2_mul(a0, c0))
    tinv = fp2_inv(t)
    return (fp2_mul(c0, tinv), fp2_mul(c1, tinv), fp2_mul(c2, tinv))


def fp12_inv(x):
    c0, c1 = _split(x)
    # (c0 + c1 w)^-1 = (c0 - c1 w) / (c0^2 - c1^2 v)
    n = _fp6_sub(_fp6_mul(c0, c0), _fp6_mul_v(_fp6_mul(c1, c1)))
    ninv = _fp6_inv(n)
    return _join(_fp6_mul(c0, ninv), _fp6_neg(_fp6_mul(c1, ninv)))


def fp12_frobenius(x, n: int = 1):
    """x -> x^(p^n) using precomputed gamma constants."""
    out = x
    for _ in range(n):
        out = tuple(fp2_mul(fp2_conj(c), _G[j]) for j, c in enumerate(out))
    return out


def fp12_pow(x, e: int):
    if e < 0:
        return fp12_pow(fp12_inv(x), -e)
    acc = FP12_ONE
    base = x
    while e:
        if e & 1:
            acc = fp12_mul(acc, base)
        base = fp12_sqr(base)
        e >>= 1
    return acc


# ---------------------------------------------------------------- G1

def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B1) % P == 0


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1] % P)


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        m = 3 * x1 * x1 % P * fp_inv(2 * y1 % P) % P
    else:
        m = (y2 - y1) * fp_inv((x2 - x1) % P) % P
    x3 = (m * m - x1 - x2) % P
    y3 = (m * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_double(pt):
    return g1_add(pt, pt)


def g1_mul(pt, k: int):
    k %= R
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = g1_add(acc, add)
        add = g1_add(add, add)
        k >>= 1
    return acc


def g1_sum(points):
    acc = None
    for pt in points:
        acc = g1_add(acc, pt)
    return acc


def g1_multiexp(points, scalars):
    if len(points) != len(scalars):
        raise ValueError(f"multiexp length mismatch: {len(points)} != {len(scalars)}")
    acc = None
    for pt, s in zip(points, scalars):
        acc = g1_add(acc, g1_mul(pt, s))
    return acc


# ---------------------------------------------------------------- G2 (twist)

B2 = fp2_mul(fp2(B1), fp2_inv(XI))  # 3 / (9 + i)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = fp2_sqr(y)
    rhs = fp2_add(fp2_mul(fp2_sqr(x), x), B2)
    return lhs == rhs


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], fp2_neg(pt[1]))


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fp2_add(y1, y2) == FP2_ZERO:
            return None
        m = fp2_mul(fp2_scale(fp2_sqr(x1), 3), fp2_inv(fp2_scale(y1, 2)))
    else:
        m = fp2_mul(fp2_sub(y2, y1), fp2_inv(fp2_sub(x2, x1)))
    x3 = fp2_sub(fp2_sub(fp2_sqr(m), x1), x2)
    y3 = fp2_sub(fp2_mul(m, fp2_sub(x1, x3)), y1)
    return (x3, y3)


def _g2_mul_raw(pt, k: int):
    """Scalar mul WITHOUT reduction mod R — for subgroup/order checks."""
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = g2_add(acc, add)
        add = g2_add(add, add)
        k >>= 1
    return acc


def g2_mul(pt, k: int):
    return _g2_mul_raw(pt, k % R)


def g2_in_subgroup(pt) -> bool:
    return pt is None or (g2_is_on_curve(pt) and _g2_mul_raw(pt, R) is None)


def g2_sum(points):
    acc = None
    for pt in points:
        acc = g2_add(acc, pt)
    return acc


def g2_multiexp(points, scalars):
    if len(points) != len(scalars):
        raise ValueError(f"multiexp length mismatch: {len(points)} != {len(scalars)}")
    acc = None
    for pt, s in zip(points, scalars):
        acc = g2_add(acc, g2_mul(pt, s))
    return acc


# ---------------------------------------------------------------- pairing

def _untwist(q):
    """Map a G2 (twist) point into E(Fp12): (x, y) -> (x w^2, y w^3)."""
    x, y = q
    xw2 = (FP2_ZERO, FP2_ZERO, x, FP2_ZERO, FP2_ZERO, FP2_ZERO)
    yw3 = (FP2_ZERO, FP2_ZERO, FP2_ZERO, y, FP2_ZERO, FP2_ZERO)
    return (xw2, yw3)


def _e12_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fp12_add(y1, y2) == FP12_ZERO:
            return None
        m = fp12_mul(fp12_scale_fp2(fp12_sqr(x1), fp2(3)), fp12_inv(fp12_scale_fp2(y1, fp2(2))))
    else:
        m = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    x3 = fp12_sub(fp12_sub(fp12_sqr(m), x1), x2)
    y3 = fp12_sub(fp12_mul(m, fp12_sub(x1, x3)), y1)
    return (x3, y3)


def _linefunc(t1, t2, px12, py12):
    """Evaluate the line through t1,t2 (E(Fp12) points) at embedded G1 point."""
    x1, y1 = t1
    x2, y2 = t2
    if x1 != x2:
        m = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    elif y1 == y2:
        m = fp12_mul(fp12_scale_fp2(fp12_sqr(x1), fp2(3)), fp12_inv(fp12_scale_fp2(y1, fp2(2))))
    else:
        return fp12_sub(px12, x1)
    return fp12_sub(fp12_mul(m, fp12_sub(px12, x1)), fp12_sub(py12, y1))


def miller_loop(p, q):
    """Miller loop of the optimal ate pairing (no final exponentiation)."""
    if p is None or q is None:
        return FP12_ONE
    px12 = fp12_from_int(p[0])
    py12 = fp12_from_int(p[1])
    qe = _untwist(q)
    t = qe
    f = FP12_ONE
    for bit in bin(ATE_LOOP)[3:]:
        f = fp12_mul(fp12_sqr(f), _linefunc(t, t, px12, py12))
        t = _e12_add(t, t)
        if bit == "1":
            f = fp12_mul(f, _linefunc(t, qe, px12, py12))
            t = _e12_add(t, qe)
    # Frobenius corrections: Q1 = pi(Q), Q2 = -pi^2(Q)
    q1 = (fp12_frobenius(qe[0]), fp12_frobenius(qe[1]))
    nq2 = (fp12_frobenius(q1[0]), fp12_neg(fp12_frobenius(q1[1])))
    f = fp12_mul(f, _linefunc(t, q1, px12, py12))
    t = _e12_add(t, q1)
    f = fp12_mul(f, _linefunc(t, nq2, px12, py12))
    return f


_FINAL_EXP_HARD = (P**4 - P**2 + 1) // R


def final_exp(f):
    """f^((p^12-1)/r) = easy part (p^6-1)(p^2+1), then hard part."""
    t = fp12_mul(fp12_conj(f), fp12_inv(f))          # f^(p^6 - 1)
    t = fp12_mul(fp12_frobenius(t, 2), t)            # ^(p^2 + 1)
    return fp12_pow(t, _FINAL_EXP_HARD)


def pairing(p, q):
    """Full optimal ate pairing e(P, Q) -> GT."""
    return final_exp(miller_loop(p, q))


def pairing_product(pairs):
    """prod e(P_i, Q_i) with one shared final exponentiation.

    Mirrors reference `Curve.Pairing2` + `Curve.FExp`
    (pssign/sign.go:153-154): callers combine two pairings and test unity.
    """
    f = FP12_ONE
    for p, q in pairs:
        f = fp12_mul(f, miller_loop(p, q))
    return final_exp(f)


def gt_is_unity(e) -> bool:
    return e == FP12_ONE


# ---------------------------------------------------------------- randomness

def rand_zr(rng=None) -> int:
    if rng is None:
        return secrets.randbelow(R - 1) + 1
    return rng.randrange(1, R)


def rand_g1(rng=None):
    return g1_mul(G1_GEN, rand_zr(rng))


def rand_g2(rng=None):
    return g2_mul(G2_GEN, rand_zr(rng))


# ---------------------------------------------------------------- encodings

def zr_to_bytes(z: int) -> bytes:
    return (z % R).to_bytes(32, "big")


def zr_from_bytes(raw: bytes) -> int:
    return int.from_bytes(raw, "big") % R


def g1_to_bytes(pt) -> bytes:
    if pt is None:
        return b"\x01" + bytes(64)
    return b"\x00" + pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def g1_from_bytes(raw: bytes):
    if len(raw) != 65:
        raise ValueError("invalid G1 encoding: wrong length")
    if raw[0] == 1:
        if any(raw[1:]):
            raise ValueError("invalid G1 encoding: non-canonical infinity")
        return None
    if raw[0] != 0:
        raise ValueError("invalid G1 encoding: bad tag")
    x = int.from_bytes(raw[1:33], "big")
    y = int.from_bytes(raw[33:65], "big")
    if x >= P or y >= P:
        raise ValueError("invalid G1 encoding: coordinate out of range")
    pt = (x, y)
    if not g1_is_on_curve(pt):
        raise ValueError("invalid G1 encoding: point not on curve")
    return pt


def g2_to_bytes(pt) -> bytes:
    if pt is None:
        return b"\x01" + bytes(128)
    (x0, x1), (y0, y1) = pt
    return (
        b"\x00"
        + x0.to_bytes(32, "big")
        + x1.to_bytes(32, "big")
        + y0.to_bytes(32, "big")
        + y1.to_bytes(32, "big")
    )


def g2_from_bytes(raw: bytes):
    if len(raw) != 129:
        raise ValueError("invalid G2 encoding: wrong length")
    if raw[0] == 1:
        if any(raw[1:]):
            raise ValueError("invalid G2 encoding: non-canonical infinity")
        return None
    if raw[0] != 0:
        raise ValueError("invalid G2 encoding: bad tag")
    vals = [int.from_bytes(raw[1 + 32 * k : 33 + 32 * k], "big") for k in range(4)]
    if any(v >= P for v in vals):
        raise ValueError("invalid G2 encoding: coordinate out of range")
    pt = ((vals[0], vals[1]), (vals[2], vals[3]))
    if not g2_is_on_curve(pt):
        raise ValueError("invalid G2 encoding: point not on curve")
    # The twist has a large cofactor: reject wrong-subgroup points
    # (small-subgroup attacks against pairing equations).
    if not g2_in_subgroup(pt):
        raise ValueError("invalid G2 encoding: point not in r-torsion subgroup")
    return pt


def gt_to_bytes(e) -> bytes:
    return b"".join(c[0].to_bytes(32, "big") + c[1].to_bytes(32, "big") for c in e)


# ------------------------------------------------- native G1 fast path
#
# The reference's host math is gnark-crypto assembly behind IBM mathlib;
# ours is ../native/bn254.c (Montgomery 4x64 Jacobian G1) behind ctypes.
# The pure-Python definitions above remain the correctness anchor (and the
# fallback when no C compiler is present): differential tests compare the
# two (tests/test_native_bn254.py).

g1_mul_py = g1_mul
g1_multiexp_py = g1_multiexp
g1_sum_py = g1_sum
g2_mul_py = g2_mul
g2_multiexp_py = g2_multiexp
g2_sum_py = g2_sum
pairing_py = pairing
pairing_product_py = pairing_product
NATIVE_G1 = False


def _selfcheck_fail(reason: str) -> None:
    from ..utils import metrics as _mx

    _mx.counter("native.selfcheck.fail").inc()
    _mx.REGISTRY.set_meta("native.selfcheck.last_failure", reason)


def _install_native() -> None:
    global g1_mul, g1_multiexp, g1_sum, NATIVE_G1
    global g2_mul, g2_multiexp, g2_sum, pairing, pairing_product
    try:
        from ..native import bn254py as _nb

        if not _nb.available():
            return
        # Round-trip self-checks before trusting the build. Every function
        # family the swap-in covers is exercised: a toolchain-specific
        # miscompile confined to the G2 or multi-leg pairing-product path
        # must not be silently adopted (the pytest differential suite does
        # not run at import time).
        if _nb.g1_mul(G1_GEN, 12345) != g1_mul_py(G1_GEN, 12345):
            _selfcheck_fail("g1_mul")  # pragma: no cover
            return  # pragma: no cover
        if _nb.g2_mul(G2_GEN, 98765) != g2_mul_py(G2_GEN, 98765):
            _selfcheck_fail("g2_mul")  # pragma: no cover
            return  # pragma: no cover
        if _nb.pairing(G1_GEN, G2_GEN) != pairing_py(G1_GEN, G2_GEN):
            _selfcheck_fail("pairing")  # pragma: no cover
            return  # pragma: no cover
        # e(P,Q) * e(-P,Q) == 1: exercises the multi-leg Miller product
        # and shared final exponentiation.
        if _nb.pairing_product([(G1_GEN, G2_GEN), (g1_neg(G1_GEN), G2_GEN)]) != FP12_ONE:
            _selfcheck_fail("pairing_product")  # pragma: no cover
            return  # pragma: no cover
        # The batch entry points (`g1_mul_batch` / `g1_multiexp_rows`) are
        # the host validation fast path for Schnorr/WF verification — a
        # miscompile confined to the batch loops (distinct C code from the
        # scalar entry) must fail the swap-in too.
        if _nb.g1_mul_batch([G1_GEN, g1_neg(G1_GEN)], [12345, 54321]) != [
            g1_mul_py(G1_GEN, 12345), g1_mul_py(g1_neg(G1_GEN), 54321)
        ]:
            _selfcheck_fail("g1_mul_batch")  # pragma: no cover
            return  # pragma: no cover
        if _nb.g1_multiexp_rows(
            [[G1_GEN, g1_neg(G1_GEN)], [G1_GEN, G1_GEN]], [[3, 5], [7, 11]]
        ) != [
            g1_multiexp_py([G1_GEN, g1_neg(G1_GEN)], [3, 5]),
            g1_multiexp_py([G1_GEN, G1_GEN], [7, 11]),
        ]:
            _selfcheck_fail("g1_multiexp_rows")  # pragma: no cover
            return  # pragma: no cover
    except Exception as e:  # pragma: no cover
        _selfcheck_fail(f"exception: {e}")
        return

    from ..utils import metrics as _mx

    _mx.counter("native.selfcheck.pass").inc()

    def _g1_sum(points):
        return _nb.g1_sum(list(points))

    def _g2_sum(points):
        return _nb.g2_sum(list(points))

    def _pairing(p, q):
        if p is None or q is None:
            return FP12_ONE  # final_exp(miller_loop) of an infinite pair
        return _nb.pairing(p, q)

    def _pairing_product(pairs):
        return _nb.pairing_product(list(pairs))

    # mul/multiexp bind straight to the ctypes layer (it validates lengths
    # and reduces scalars mod R itself); sum/product wrappers only coerce
    # generators / handle infinity.
    g1_mul = _nb.g1_mul
    g1_multiexp = _nb.g1_multiexp
    g1_sum = _g1_sum
    g2_mul = _nb.g2_mul
    g2_multiexp = _nb.g2_multiexp
    g2_sum = _g2_sum
    pairing = _pairing
    pairing_product = _pairing_product
    NATIVE_G1 = True
    _mx.gauge("native.installed").set(1)


_install_native()


def g1_mul_batch(points, scalars):
    """[k_i P_i] in one native call (falls back to a Python loop)."""
    points, scalars = list(points), list(scalars)
    if len(points) != len(scalars):
        raise ValueError(
            f"mul_batch length mismatch: {len(points)} != {len(scalars)}"
        )
    from ..utils import metrics as _mx

    if NATIVE_G1:
        from ..native import bn254py as _nb

        _mx.counter("hostmath.g1_mul_batch.native").inc()
        return _nb.g1_mul_batch(points, scalars)
    _mx.counter("hostmath.g1_mul_batch.python").inc()
    return [g1_mul_py(p, k) for p, k in zip(points, scalars)]


def g1_multiexp_rows(points_rows, scalar_rows):
    """One multiexp per row; same-width runs collapse into single native
    calls (the C kernel requires rectangular input), pure-Python multiexp
    per row otherwise. Rows may be ragged — grouping happens here so
    callers batch heterogeneous Schnorr statements in one shot."""
    points_rows = [list(r) for r in points_rows]
    scalar_rows = [list(r) for r in scalar_rows]
    if len(points_rows) != len(scalar_rows):
        raise ValueError(
            f"multiexp_rows length mismatch: {len(points_rows)} != {len(scalar_rows)}"
        )
    for pr, sr in zip(points_rows, scalar_rows):
        if len(pr) != len(sr):
            raise ValueError("multiexp_rows: row length mismatch")
    from ..utils import metrics as _mx

    if not NATIVE_G1:
        _mx.counter("hostmath.g1_multiexp_rows.python").inc()
        return [g1_multiexp_py(p, s) for p, s in zip(points_rows, scalar_rows)]
    from ..native import bn254py as _nb

    _mx.counter("hostmath.g1_multiexp_rows.native").inc()
    out = [None] * len(points_rows)
    widths = {}
    for i, pr in enumerate(points_rows):
        widths.setdefault(len(pr), []).append(i)
    for width, idxs in widths.items():
        if width == 0:
            continue  # multiexp over nothing is the identity (None)
        res = _nb.g1_multiexp_rows(
            [points_rows[i] for i in idxs], [scalar_rows[i] for i in idxs]
        )
        for i, pt in zip(idxs, res):
            out[i] = pt
    return out


# ---------------------------------------------------------------- hashing

def hash_to_zr(data: bytes, domain: bytes = b"fts-tpu/zr") -> int:
    """Fiat-Shamir hash to the scalar field (ref: Curve.HashToZr).

    Two-block SHA-256 expansion for negligible modular bias.
    """
    h0 = hashlib.sha256(domain + b"\x00" + data).digest()
    h1 = hashlib.sha256(domain + b"\x01" + data).digest()
    return int.from_bytes(h0 + h1, "big") % R


def hash_to_zr_many(items) -> list:
    """Block-level batch Fiat-Shamir: `hash_to_zr` over many (data, domain)
    pairs with ONE `native.sha256_batch` dispatch (fastser offsets buffer)
    instead of 2N per-proof hashlib round trips.

    Byte-identical to `[hash_to_zr(d, dom) for d, dom in items]` by
    construction — the two-block expansion messages are laid out in
    transcript order and hashed by the same primitive; `sha256_many`
    falls back to hashlib scalar hashing when no native library builds
    (differential-pinned in tests/test_host_batch.py, native on and off).
    """
    items = list(items)
    if not items:
        return []
    msgs = []
    for data, domain in items:
        msgs.append(domain + b"\x00" + data)
        msgs.append(domain + b"\x01" + data)
    from ..native import sha256_many

    digests = sha256_many(msgs)
    return [
        int.from_bytes(digests[2 * i] + digests[2 * i + 1], "big") % R
        for i in range(len(items))
    ]


def hash_to_g1(data: bytes, domain: bytes = b"fts-tpu/g1"):
    """Try-and-increment hash to G1 (cofactor 1, so any curve point works)."""
    ctr = 0
    while True:
        d0 = hashlib.sha256(domain + ctr.to_bytes(4, "big") + b"\x00" + data).digest()
        d1 = hashlib.sha256(domain + ctr.to_bytes(4, "big") + b"\x01" + data).digest()
        x = int.from_bytes(d0 + d1, "big") % P
        y = fp_sqrt((x * x * x + B1) % P)
        if y is not None:
            # normalize sign for determinism
            if y > P - y:
                y = P - y
            return (x, y)
        ctr += 1
