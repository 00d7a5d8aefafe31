"""Batched optimal-ate pairing on BN254: constants, host I/O, plain torch
versions and the staged pairing product.

Counterpart of `fabric_token_sdk_tpu/ops/pairing.py`. The Miller loop
runs on the twist in Jacobian coordinates with the reference's
denominator-free line formulas (`_dbl_step`, `_add_step`: same T
coordinates, same line scaling), so Miller values equal the reference's
as canonical Fp12, not only after the final exponentiation. The final
exponentiation is the easy part (one tower inversion) and the hard part
by the reference's balanced base-p / u-basis decomposition, checked at
import: three exponentiations by u, a 4x4 Straus step over the
coefficient bits, and a Frobenius combine.

The functions on half-word tensors are the plain versions of the
`miller`, `gt_product` and `final_exp` CUDA kernels (`csrc/`), which
`ops/stages.py` launches; `pairing_product_staged` chains the three
stages, one launch each over all rows, and `pairing_product` runs the
whole product a row in one launch of the fused kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import limbs as lb, tower as tw
from .field import FP, words_to_half
from ..crypto import hostmath as hm

# ---------------------------------------------------------------- constants

# bits of 6u+2 after the leading one, MSB first
_ATE_BITS = np.array([int(b) for b in bin(hm.ATE_LOOP)[3:]], dtype=np.int32)
# ALL bits of u MSB-first; _pow_u scans _U_BITS[1:]
_U_BITS = np.array([int(b) for b in bin(hm.U)[2:]], dtype=np.int32)

# hard-part u-basis coefficients (c0..c3) per lambda_i, checked at import
_LAMBDA_COEFFS = [
    (-2, -18, -30, -36),
    (1, -12, -18, -36),
    (1, 0, 6, 0),
    (1, 0, 0, 0),
]


def _check_lambda_decomposition() -> None:
    D = (hm.P**4 - hm.P**2 + 1) // hm.R
    total = 0
    for i, cs in enumerate(_LAMBDA_COEFFS):
        lam = sum(c * hm.U**k for k, c in enumerate(cs))
        total += lam * hm.P**i
    if total != D:
        raise AssertionError("final-exponentiation decomposition is wrong")


_check_lambda_decomposition()

# Straus tables for the hard part: bits (nbits, 4 outputs, 4 bases) of
# |c_ik| MSB-first, and the sign matrix (4, 4)
_HP_NBITS = max(abs(c).bit_length() for cs in _LAMBDA_COEFFS for c in cs)
_HP_BITS = np.zeros((_HP_NBITS, 4, 4), dtype=np.int32)
_HP_SIGN = np.zeros((4, 4), dtype=np.int32)
for _i, _cs in enumerate(_LAMBDA_COEFFS):
    for _k, _c in enumerate(_cs):
        _HP_SIGN[_i, _k] = -1 if _c < 0 else 1
        for _b in range(_HP_NBITS):
            _HP_BITS[_HP_NBITS - 1 - _b, _i, _k] = (abs(_c) >> _b) & 1


@functools.lru_cache(maxsize=None)
def _twist_frob_consts() -> np.ndarray:
    """(4, 2, 8): c_x1, c_y1, c_x2, c_y2 = XI^((p^n-1)/3), XI^((p^n-1)/2)
    for n = 1, 2."""
    cx1 = hm.fp2_pow(hm.XI, (hm.P - 1) // 3)
    cy1 = hm.fp2_pow(hm.XI, (hm.P - 1) // 2)
    cx2 = hm.fp2_pow(hm.XI, (hm.P**2 - 1) // 3)
    cy2 = hm.fp2_pow(hm.XI, (hm.P**2 - 1) // 2)
    return tw.encode_fp2([cx1, cy1, cx2, cy2])


# ---------------------------------------------------------------- host I/O

_RM = (1 << lb.WORD_BITS * lb.NWORDS) % hm.P


def encode_g1(points) -> np.ndarray:
    """Host G1 affine points -> (N, 2, 8) Montgomery (x, y). Infinity
    encodes as (0, 0) and must be masked by the caller."""
    vals = []
    for pt in points:
        vals.extend((0, 0) if pt is None else (pt[0] * _RM % hm.P, pt[1] * _RM % hm.P))
    if not vals:
        return np.zeros((0, 2, lb.NWORDS), dtype=np.int32)
    return lb.ints_to_words(vals).reshape(-1, 2, lb.NWORDS)


def encode_g2(points) -> np.ndarray:
    """Host G2 affine points -> (N, 2, 2, 8): x, y as Fp2."""
    out = np.zeros((len(points), 2, 2, lb.NWORDS), dtype=np.int32)
    for i, pt in enumerate(points):
        if pt is not None:
            out[i] = tw.encode_fp2([pt[0], pt[1]])
    return out


_GT_ONE = ((1, 0), (0, 0), (0, 0), (0, 0), (0, 0), (0, 0))


def decode_gt(arr) -> list:
    """GT words (..., 6, 2, 8) -> host flat Fp12 tuples (hostmath layout)."""
    return tw.decode_fp12(arr)


def gt_is_one_host(arr) -> np.ndarray:
    """Host GT == 1 test on (B, 6, 2, 8) words."""
    return np.array([v == _GT_ONE for v in tw.decode_fp12(arr)], dtype=bool)


# ---------------------------------------------------------------- Miller loop
# Half-word tensors, digit axis first: xp, yp (16, N); Fp2 (16, N, 2);
# a G2 point T is a tuple of three Fp2.

def _times2(x):
    return FP.add(x, x)


def _dbl_step(T, xp, yp):
    """Jacobian doubling + denominator-free line at P = (xp, yp).
    Returns (T2, l0, l1, l3)."""
    X, Y, Z = T
    XX, YY, ZZ = tw.fp2_sqr(torch.stack([X, Y, Z], dim=-2)).unbind(-2)
    M = FP.add(FP.add(XX, XX), XX)  # 3X^2
    XYY, ZZZ, YZ = tw.fp2_mul_pairs((X, YY), (ZZ, Z), (Y, Z))
    S = _times2(_times2(XYY))  # 4XY^2
    M2, YYYY, YZZZ, MZZ, MX = tw.fp2_mul_pairs((M, M), (YY, YY), (Y, ZZZ), (M, ZZ), (M, X))
    X3 = FP.sub(M2, _times2(S))
    Y3 = FP.sub(tw.fp2_mul(M, FP.sub(S, X3)), _times2(_times2(_times2(YYYY))))
    Z3 = _times2(YZ)
    # line: l0 = -2YZ^3 yp ; l1 = 3X^2 Z^2 xp ; l3 = 2Y^2 - 3X^3
    l0 = tw.fp2_scale(FP.neg(_times2(YZZZ)), yp)
    l1 = tw.fp2_scale(MZZ, xp)
    l3 = FP.sub(_times2(YY), MX)
    return (X3, Y3, Z3), l0, l1, l3


def _add_step(T, Q, xp, yp):
    """Mixed addition T + Q (Q affine) + line at P; denominator-free."""
    X, Y, Z = T
    x2, y2 = Q
    ZZ = tw.fp2_sqr(Z)
    U2, ZZZ = tw.fp2_mul_pairs((x2, ZZ), (ZZ, Z))
    H = FP.sub(U2, X)
    S2, HH, Z3 = tw.fp2_mul_pairs((y2, ZZZ), (H, H), (Z, H))
    r = FP.sub(S2, Y)
    HHH, V, rr, rx2 = tw.fp2_mul_pairs((H, HH), (X, HH), (r, r), (r, x2))
    X3 = FP.sub(FP.sub(rr, HHH), _times2(V))
    t, yh, zy = tw.fp2_mul_pairs((r, FP.sub(V, X3)), (Y, HHH), (Z3, y2))
    Y3 = FP.sub(t, yh)
    l3 = FP.sub(zy, rx2)
    l0 = tw.fp2_scale(FP.neg(Z3), yp)
    l1 = tw.fp2_scale(r, xp)
    return (X3, Y3, Z3), l0, l1, l3


def miller_loop(xp, yp, qx, qy):
    """Plain Miller loop: G1 affine (xp, yp) (16, N) each, G2 affine
    (qx, qy) (16, N, 2) each -> f (16, N, 6, 2). No infinity handling:
    a (0, 0) leg runs through the formulas like any other. The bits are
    public constants, so the add step runs only on set bits, as in the
    kernel (the reference computes it always and selects; the values
    are the same)."""
    one2 = torch.zeros_like(qx)
    one2[..., 0] = FP.one_half(qx[..., 0])
    T = (qx, qy, one2)
    f = tw.fp12_one_half(torch.zeros(qx.shape[:-1] + (6, 2), dtype=qx.dtype, device=qx.device))
    for bit in _ATE_BITS:
        f = tw.fp12_sqr(f)
        T, l0, l1, l3 = _dbl_step(T, xp, yp)
        f = tw.fp12_mul_sparse013(f, l0, l1, l3)
        if bit:
            T, l0, l1, l3 = _add_step(T, (qx, qy), xp, yp)
            f = tw.fp12_mul_sparse013(f, l0, l1, l3)
    # Frobenius corrections: Q1 = pi(Q), Q2n = -pi^2(Q)
    c = torch.from_numpy(_twist_frob_consts()).to(qx.device)
    cx1, cy1, cx2, cy2 = (h.unsqueeze(1) for h in words_to_half(c).unbind(1))
    q1x, q1y, q2x, q2y = tw.fp2_mul_pairs((tw.fp2_conj(qx), cx1.expand_as(qx)), (tw.fp2_conj(qy), cy1.expand_as(qy)),
                               (qx, cx2.expand_as(qx)), (qy, cy2.expand_as(qy)))
    T, l0, l1, l3 = _add_step(T, (q1x, q1y), xp, yp)
    f = tw.fp12_mul_sparse013(f, l0, l1, l3)
    _, l0, l1, l3 = _add_step(T, (q2x, FP.neg(q2y)), xp, yp)
    return tw.fp12_mul_sparse013(f, l0, l1, l3)


# ---------------------------------------------------------------- product

def product_rows(f):
    """(16, B, K, 6, 2) -> (16, B, 6, 2): per-row product of K values,
    as the reference's pairwise tree (legs i and i + K/2 first)."""
    while f.shape[2] > 1:
        half = f.shape[2] // 2
        rest = f[:, :, 2 * half :]
        f2 = tw.fp12_mul(f[:, :, :half], f[:, :, half : 2 * half])
        f = torch.cat([f2, rest], dim=2) if rest.shape[2] else f2
    return f[:, :, 0]


# ---------------------------------------------------------------- final exp

def _pow_u(f):
    """f^u by the fixed bits of u, MSB first."""
    acc = f
    for bit in _U_BITS[1:]:
        acc = tw.fp12_sqr(acc)
        if bit:
            acc = tw.fp12_mul(acc, f)
    return acc


def final_exp(f):
    """Plain f^((p^12-1)/r) on (16, B, 6, 2)."""
    t = tw.fp12_mul(tw.fp12_conj(f), tw.fp12_inv(f))
    t = tw.fp12_mul(tw.fp12_frobenius(t, 2), t)
    fu = _pow_u(t)
    fu2 = _pow_u(fu)
    fu3 = _pow_u(fu2)
    powers = torch.stack([t, fu, fu2, fu3], dim=1)  # (16, 4 bases, B, 6, 2)
    conj = tw.fp12_conj(powers)
    sign = torch.from_numpy(_HP_SIGN > 0).to(f.device)  # (4 out, 4 base)
    sel = sign.view((1, 4, 4) + (1,) * (f.dim() - 1))
    bases = torch.where(sel, powers.unsqueeze(1), conj.unsqueeze(1))  # (16, 4o, 4b, B, 6, 2)
    acc = tw.fp12_one_half(torch.zeros_like(powers))  # (16, 4 out, B, 6, 2)
    take_shape = (1, 4) + (1,) * (f.dim() - 1)
    for bits in _HP_BITS:  # (4 out, 4 base)
        acc = tw.fp12_sqr(acc)
        for k in range(4):
            col = bits[:, k]
            if not col.any():
                continue
            mult = tw.fp12_mul(acc, bases[:, :, k])
            take = torch.from_numpy(col > 0).to(f.device).view(take_shape)
            acc = torch.where(take, mult, acc)
    r01 = tw.fp12_mul(acc[:, 0], tw.fp12_frobenius(acc[:, 1], 1))
    r23 = tw.fp12_mul(tw.fp12_frobenius(acc[:, 2], 2), tw.fp12_frobenius(acc[:, 3], 3))
    return tw.fp12_mul(r01, r23)


# ---------------------------------------------------------------- staged product

def pairing_product_staged(Ps: torch.Tensor, Qs: torch.Tensor, inf_mask=None) -> torch.Tensor:
    """prod_k e(P_k, Q_k) for each row, one launch per stage over all
    rows: Miller over the B*K flat legs, the per-row product, the final
    exponentiation.

    Ps (B, K, 2, 8) and Qs (B, K, 2, 2, 8) Montgomery affine words on one
    device; inf_mask (B, K) bool or None: True legs become GT one before
    the product. Returns (B, 6, 2, 8) canonical GT words on that device.
    """
    from . import stages as st

    B, K = Ps.shape[0], Ps.shape[1]
    if B == 0:
        return torch.zeros((0, 6, 2, lb.NWORDS), dtype=torch.int32, device=Ps.device)
    f = st.miller_rows(Ps.reshape(B * K, 2, lb.NWORDS).contiguous(),
                       Qs.reshape(B * K, 2, 2, lb.NWORDS).contiguous())
    if inf_mask is not None:
        mask = torch.as_tensor(np.asarray(inf_mask), device=f.device).reshape(B * K)
        one = torch.from_numpy(tw.fp12_one_np()).to(f.device)
        f = torch.where(mask.view(-1, 1, 1, 1), one, f)
    g = st.gt_product_rows(f.reshape(B, K, 6, 2, lb.NWORDS).contiguous())
    return st.final_exp_rows(g)


def pairing_product(Ps: torch.Tensor, Qs: torch.Tensor, inf_mask=None) -> torch.Tensor:
    """prod_k e(P_k, Q_k) for each row in ONE launch of the fused kernel
    (`csrc/pairing_fused.cu`): the counterpart of the reference's jitted
    `pairing_product`. Same arguments and result as
    `pairing_product_staged`, and the same GT values."""
    from . import stages as st

    if Ps.shape[0] == 0:
        return torch.zeros((0, 6, 2, lb.NWORDS), dtype=torch.int32, device=Ps.device)
    return st.pairing_product_rows(Ps.contiguous(), Qs.contiguous(), inf_mask)
