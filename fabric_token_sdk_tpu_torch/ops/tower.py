"""BN254 extension-field towers: host I/O and the plain torch versions.

Counterpart of `fabric_token_sdk_tpu/ops/tower.py`. Layouts as words
(leading axes = batch), the reference's exactly:

  Fp2  : (..., 2, 8)        c0 + c1*i,          i^2 = -1
  Fp12 : (..., 6, 2, 8)     flat w-basis, w^6 = XI = 9 + i

The tower view Fp12 = Fp6[w]/(w^2 - v), Fp6 = Fp2[v]/(v^3 - XI) is
recovered by index parity: c0 = x[0::2], c1 = x[1::2] over the w axis.

The plain versions below work on the half-word tensors of `ops/field.py`
(digit axis first): an Fp2 is (16, ..., 2), an Fp6 (16, ..., 3, 2), an
Fp12 (16, ..., 6, 2). As in the reference, every composite op stacks its
independent base-field products into one `FP.mul` call (an Fp12 product
is one call on a 54-wide stack): the plain version's cost is its count
of torch operations. Values live in [0, 2p) like the base field's;
canonical results equal the reference's and the CUDA device functions'
(`csrc/bn254_tower.cuh`), since each op returns a unique field element.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import limbs as lb
from .field import FP, words_to_half
from ..crypto import hostmath as hm

_RM = (1 << lb.WORD_BITS * lb.NWORDS) % hm.P  # Montgomery R mod p
_RINV = pow(1 << lb.WORD_BITS * lb.NWORDS, -1, hm.P)


# ---------------------------------------------------------------- Fp2

def fp2_add(x, y):
    return FP.add(x, y)


def fp2_sub(x, y):
    return FP.sub(x, y)


def fp2_neg(x):
    return FP.neg(x)


def fp2_conj(x):
    return torch.stack([x[..., 0], FP.neg(x[..., 1])], dim=-1)


def fp2_mul(x, y):
    """Karatsuba: (a0 b0 - a1 b1) + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) i,
    the three products in one stacked FP.mul."""
    x, y = torch.broadcast_tensors(x, y)
    a0, a1 = x[..., 0], x[..., 1]
    b0, b1 = y[..., 0], y[..., 1]
    v = FP.mul(torch.stack([a0, a1, FP.add(a0, a1)], dim=-1),
               torch.stack([b0, b1, FP.add(b0, b1)], dim=-1))
    v0, v1, v01 = v.unbind(-1)
    return torch.stack([FP.sub(v0, v1), FP.sub(v01, FP.add(v0, v1))], dim=-1)


def fp2_mul_pairs(*pairs):
    """Several independent Fp2 products (a, b) in one stacked call."""
    a = torch.stack([p[0] for p in pairs], dim=-2)
    b = torch.stack([p[1] for p in pairs], dim=-2)
    return fp2_mul(a, b).unbind(-2)


def fp2_sqr(x):
    """(a0 + a1)(a0 - a1) + 2 a0 a1 i: two products."""
    a0, a1 = x[..., 0], x[..., 1]
    v = FP.mul(torch.stack([FP.add(a0, a1), a0], dim=-1),
               torch.stack([FP.sub(a0, a1), a1], dim=-1))
    return torch.stack([v[..., 0], FP.add(v[..., 1], v[..., 1])], dim=-1)


def fp2_scale(x, k):
    """Both components times a base-field element k (16, ...)."""
    return FP.mul(x, k.unsqueeze(-1))


def _times(x, k: int):
    """k x by doubling and adding (k >= 1)."""
    acc = None
    d = x
    while k:
        if k & 1:
            acc = d if acc is None else FP.add(acc, d)
        k >>= 1
        if k:
            d = FP.add(d, d)
    return acc


def fp2_mul_xi(x):
    """Times XI = 9 + i: (9 a0 - a1) + (a0 + 9 a1) i. Add-only."""
    a0, a1 = x[..., 0], x[..., 1]
    n = _times(x, 9)
    return torch.stack([FP.sub(n[..., 0], a1), FP.add(a0, n[..., 1])], dim=-1)


def fp2_inv(x):
    """(a0 - a1 i) / (a0^2 + a1^2): one base-field inversion; 0 -> 0."""
    sq = FP.mul(x, x)
    n = FP.inv(FP.add(sq[..., 0], sq[..., 1]))
    v = FP.mul(x, n.unsqueeze(-1))
    return torch.stack([v[..., 0], FP.neg(v[..., 1])], dim=-1)


def fp2_is_zero(x):
    return FP.is_zero(x).all(dim=-1)


def fp2_eq(x, y):
    return FP.eq(x, y).all(dim=-1)


# ---------------------------------------------------------------- Fp6
# (16, ..., 3, 2): a0 + a1 v + a2 v^2. The six Karatsuba cross products
# go through ONE fp2_mul.

def _fp6_mul(a, b):
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a.unbind(-2)
    b0, b1, b2 = b.unbind(-2)
    X = torch.stack([a0, a1, a2, FP.add(a1, a2), FP.add(a0, a1), FP.add(a0, a2)], dim=-2)
    Y = torch.stack([b0, b1, b2, FP.add(b1, b2), FP.add(b0, b1), FP.add(b0, b2)], dim=-2)
    t0, t1, t2, t12, t01, t02 = fp2_mul(X, Y).unbind(-2)
    c0 = FP.add(t0, fp2_mul_xi(FP.sub(t12, FP.add(t1, t2))))
    c1 = FP.add(FP.sub(t01, FP.add(t0, t1)), fp2_mul_xi(t2))
    c2 = FP.add(FP.sub(t02, FP.add(t0, t2)), t1)
    return torch.stack([c0, c1, c2], dim=-2)


def _fp6_mul_v(a):
    a0, a1, a2 = a.unbind(-2)
    return torch.stack([fp2_mul_xi(a2), a0, a1], dim=-2)


def _fp6_inv(a):
    a0, a1, a2 = a.unbind(-2)
    s = fp2_mul(torch.stack([a0, a2, a1, a1, a0, a0], dim=-2),
                torch.stack([a0, a2, a1, a2, a1, a2], dim=-2))
    a0a0, a2a2, a1a1, a1a2, a0a1, a0a2 = s.unbind(-2)
    c0 = FP.sub(a0a0, fp2_mul_xi(a1a2))
    c1 = FP.sub(fp2_mul_xi(a2a2), a0a1)
    c2 = FP.sub(a1a1, a0a2)
    u = fp2_mul(torch.stack([a2, a1, a0], dim=-2), torch.stack([c1, c2, c0], dim=-2))
    u0, u1, u2 = u.unbind(-2)
    t = FP.add(fp2_mul_xi(FP.add(u0, u1)), u2)
    c = torch.stack([c0, c1, c2], dim=-2)
    return fp2_mul(c, fp2_inv(t).unsqueeze(-2))


# ---------------------------------------------------------------- Fp12

def _split(x):
    return x[..., 0::2, :], x[..., 1::2, :]


def _join(c0, c1):
    out = torch.stack([c0, c1], dim=-2)  # (..., 3, 2(c), 2)
    return out.flatten(-3, -2)


def fp12_mul(x, y):
    """Karatsuba over Fp6: three stacked Fp6 products, one FP.mul."""
    x, y = torch.broadcast_tensors(x, y)
    x0, x1 = _split(x)
    y0, y1 = _split(y)
    A = torch.stack([x0, x1, FP.add(x0, x1)], dim=1)
    B = torch.stack([y0, y1, FP.add(y0, y1)], dim=1)
    v0, v1, v01 = _fp6_mul(A, B).unbind(1)
    c0 = FP.add(v0, _fp6_mul_v(v1))
    c1 = FP.sub(v01, FP.add(v0, v1))
    return _join(c0, c1)


def fp12_sqr(x):
    """Complex squaring over Fp6: two stacked Fp6 products."""
    x0, x1 = _split(x)
    A = torch.stack([x0, FP.add(x0, x1)], dim=1)
    B = torch.stack([x1, FP.add(x0, _fp6_mul_v(x1))], dim=1)
    V = _fp6_mul(A, B)
    v, t0 = V[:, 0], V[:, 1]
    c0 = FP.sub(FP.sub(t0, v), _fp6_mul_v(v))
    c1 = FP.add(v, v)
    return _join(c0, c1)


_ODD_W = torch.tensor([False, True, False, True, False, True])


def fp12_cyclo_sqr(x):
    """x^2 for x in the cyclotomic subgroup (every value after the final
    exponentiation's easy part), by Granger and Scott: Fp12 as three Fp4
    elements (x[j], x[j+3]) over w^3 (w^6 = XI), each squared from three
    Fp2 squarings, 18 base products in all (the kernel's, `csrc/
    bn254_gt_coop.cuh`); fp12_sqr takes 36. Wrong outside that subgroup."""
    a, b = x[..., 0:3, :], x[..., 3:6, :]  # pairs (x0, x3), (x1, x4), (x2, x5)
    sq = fp2_sqr(torch.cat([a, b, FP.add(a, b)], dim=-2))
    a2, b2, ab2 = sq[..., 0:3, :], sq[..., 3:6, :], sq[..., 6:9, :]
    te = FP.add(a2, fp2_mul_xi(b2))  # t0, t2, t4
    to = FP.sub(FP.sub(ab2, a2), b2)  # t1, t3, t5
    # coefficient j takes 3 T_j - 2 x_j (even j) or 3 T_j + 2 x_j (odd j)
    t = torch.stack([te[..., 0, :], fp2_mul_xi(to[..., 2, :]), te[..., 1, :], to[..., 0, :],
                     te[..., 2, :], to[..., 1, :]], dim=-2)
    odd = _ODD_W.to(x.device).view(6, 1)
    d = torch.where(odd, FP.add(t, x), FP.sub(t, x))
    d = FP.add(d, d)
    return FP.add(d, t)


def fp12_conj(x):
    """Negate the odd powers of w (the p^6 Frobenius)."""
    odd = _ODD_W.to(x.device).view(6, 1)
    return torch.where(odd, FP.neg(x), x)


def fp12_inv(x):
    x0, x1 = _split(x)
    S = _fp6_mul(torch.stack([x0, x1], dim=1), torch.stack([x0, x1], dim=1))
    n = FP.sub(S[:, 0], _fp6_mul_v(S[:, 1]))
    ninv = _fp6_inv(n)
    R = _fp6_mul(torch.stack([x0, x1], dim=1), ninv.unsqueeze(1))
    return _join(R[:, 0], FP.neg(R[:, 1]))


def fp12_eq(x, y):
    return FP.eq(x, y).all(dim=-1).all(dim=-1)


@functools.lru_cache(maxsize=None)
def frob_gammas_np(n: int) -> np.ndarray:
    """(6, 2, 8) Montgomery words of XI^(j (p^n - 1) / 6), j = 0..5."""
    return encode_fp2([hm.fp2_pow(hm.XI, j * (hm.P**n - 1) // 6) for j in range(6)])


def fp12_frobenius(x, n: int = 1):
    """x^(p^n): conjugate each coefficient when n is odd, then times
    gamma_j; for n = 1, 2, 3."""
    gam = words_to_half(torch.from_numpy(frob_gammas_np(n)).to(x.device))  # (16, 6, 2)
    c = x if n % 2 == 0 else fp2_conj(x)
    gam = gam.view((16,) + (1,) * (x.dim() - 3) + (6, 2))
    return fp2_mul(c, gam)


def fp12_mul_sparse013(f, l0, l1, l3):
    """f * (l0 + l1 w + l3 w^3), l* Fp2 (16, ..., 2): 18 Fp2 products in
    one stacked fp2_mul."""
    rows = list(f.unbind(-2))
    X = torch.stack([rows[j] for j in range(6)] + [rows[(j - 1) % 6] for j in range(6)]
                    + [rows[(j - 3) % 6] for j in range(6)], dim=-2)
    Y = torch.stack([l0] * 6 + [l1] * 6 + [l3] * 6, dim=-2)
    prod = fp2_mul(X, Y).unbind(-2)
    out = []
    for j in range(6):
        u = prod[6 + j] if j >= 1 else fp2_mul_xi(prod[6 + j])
        t = FP.add(prod[j], u)
        u = prod[12 + j] if j >= 3 else fp2_mul_xi(prod[12 + j])
        out.append(FP.add(t, u))
    return torch.stack(out, dim=-2)


def fp12_one_np() -> np.ndarray:
    """The Fp12/GT identity as (6, 2, 8) Montgomery words."""
    out = np.zeros((6, 2, lb.NWORDS), dtype=np.int32)
    out[0, 0] = FP.one_mont
    return out


def fp12_one_half(like: torch.Tensor) -> torch.Tensor:
    """The identity as half-words shaped like `like` (16, ..., 6, 2)."""
    one = words_to_half(torch.from_numpy(fp12_one_np()).to(like.device))
    return one.view((16,) + (1,) * (like.dim() - 3) + (6, 2)).expand_as(like).clone()


# ------------------------------------------------------- host conversions

def encode_fp2(vals) -> np.ndarray:
    """Host Fp2 tuples [(a, b), ...] -> (N, 2, 8) Montgomery words."""
    flat = [c * _RM % hm.P for v in vals for c in v]
    if not flat:
        return np.zeros((0, 2, lb.NWORDS), dtype=np.int32)
    return lb.ints_to_words(flat).reshape(-1, 2, lb.NWORDS)


def decode_fp2(arr) -> list:
    """Montgomery words (..., 2, 8) -> host Fp2 tuples."""
    flat = [v * _RINV % hm.P for v in lb.batch_words_to_ints(arr)]
    return [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]


def encode_fp12(vals) -> np.ndarray:
    """Host flat Fp12 tuples (6 x Fp2) -> (N, 6, 2, 8)."""
    return encode_fp2([c for v in vals for c in v]).reshape(-1, 6, 2, lb.NWORDS)


def decode_fp12(arr) -> list:
    pairs = decode_fp2(arr)
    return [tuple(pairs[6 * i : 6 * i + 6]) for i in range(len(pairs) // 6)]
