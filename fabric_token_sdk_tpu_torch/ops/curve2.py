"""BN254 G2 on the twist: the plain torch group ops and host I/O.

Counterpart of `fabric_token_sdk_tpu/ops/curve2.py`. A batch of points
is an int32 tensor `(..., 3, 2, 8)`: Jacobian (X, Y, Z) over Fp2 in
Montgomery form, Z == 0 encoding infinity.

The group ops here are the plain torch versions that the CUDA kernels
(`csrc/bn254_g2.cuh`, `csrc/g2_*.cu`, launched from `ops/stages.py`)
are held against. They use the reference's formulas (dbl-2009-l,
add-2007-bl over Fp2) and its edge-case selects in its order, so a
result's canonical Jacobian coordinates equal the reference's and the
kernels'. Internally a point is a tuple of three Fp2 half-word tensors
(16, ..., 2), digit axis first (`ops/field.py`, `ops/tower.py`);
independent Fp2 products are stacked into one call.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import limbs as lb, tower as tw
from .field import FP, half_to_words, words_to_half
from ..crypto import hostmath as hm

Half3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------- conversions

def to_half3(points: torch.Tensor) -> Half3:
    """int32 (N, 3, 2, 8) -> (x, y, z) Fp2 half-word tensors, each (16, N, 2)."""
    h = words_to_half(points)  # (16, N, 3, 2)
    return h[..., 0, :], h[..., 1, :], h[..., 2, :]


def from_half3(p: Half3) -> torch.Tensor:
    """(x, y, z) half-words (16, N, 2) -> canonical int32 (N, 3, 2, 8)."""
    return half_to_words(FP.canon(torch.stack(p, dim=-2)))


def _sqr2(*xs):
    return tw.fp2_sqr(torch.stack(xs, dim=-2)).unbind(-2)


def _sel(mask: torch.Tensor, a: Half3, b: Half3) -> Half3:
    m = mask.unsqueeze(-1)
    return tuple(torch.where(m, u, v) for u, v in zip(a, b))


# ---------------------------------------------------------------- group ops

def infinity_half(like: torch.Tensor) -> Half3:
    z = torch.zeros_like(like)
    return z, z.clone(), z.clone()


def neg(p: Half3) -> Half3:
    return p[0], FP.neg(p[1]), p[2]


def double(p: Half3) -> Half3:
    """dbl-2009-l (a = 0) over Fp2, the reference's stacking."""
    x, y, z = p
    a, b = _sqr2(x, y)
    c, t = _sqr2(b, FP.add(x, b))
    d = FP.sub(t, FP.add(a, c))
    d = FP.add(d, d)
    e = FP.add(FP.add(a, a), a)
    f, yz = tw.fp2_mul_pairs((e, e), (y, z))
    x3 = FP.sub(f, FP.add(d, d))
    c8 = FP.add(c, c)
    c8 = FP.add(c8, c8)
    c8 = FP.add(c8, c8)
    y3 = FP.sub(tw.fp2_mul(e, FP.sub(d, x3)), c8)
    z3 = FP.add(yz, yz)
    return x3, y3, z3


def add(p: Half3, q: Half3) -> Half3:
    """add-2007-bl over Fp2 with the reference's selects, in its order:
    P == Q -> double(P); P == -Q -> all-zero infinity; P at infinity ->
    Q; Q at infinity -> P. (The plain version computes the doubling
    only when some row needs it; the kernel computes it always.)"""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = _sqr2(z1, z2)
    u1, u2, s1p, s2p = tw.fp2_mul_pairs((x1, z2z2), (x2, z1z1), (y1, z2), (y2, z1))
    s1, s2 = tw.fp2_mul_pairs((s1p, z2z2), (s2p, z1z1))
    h = FP.sub(u2, u1)
    rr = FP.sub(s2, s1)
    rr = FP.add(rr, rr)
    i = tw.fp2_sqr(FP.add(h, h))
    j, v = tw.fp2_mul_pairs((h, i), (u1, i))
    x3 = FP.sub(tw.fp2_sqr(rr), FP.add(j, FP.add(v, v)))
    zsum = FP.sub(tw.fp2_sqr(FP.add(z1, z2)), FP.add(z1z1, z2z2))
    t, s1j, z3 = tw.fp2_mul_pairs((rr, FP.sub(v, x3)), (s1, j), (zsum, h))
    y3 = FP.sub(t, FP.add(s1j, s1j))
    out = (x3, y3, z3)

    same_x, same_y, inf1, inf2 = tw.fp2_is_zero(torch.stack([h, rr, z1, z2], dim=1)).unbind(0)
    finite = ~inf1 & ~inf2
    dbl = same_x & same_y & finite
    if bool(dbl.any()):
        out = _sel(dbl, double(p), out)
    out = _sel(same_x & ~same_y & finite, infinity_half(x1), out)
    out = _sel(inf1, q, out)
    out = _sel(inf2, p, out)
    return out


def scalar_mul(p: Half3, scalars: torch.Tensor) -> Half3:
    """[k]Q by 256 MSB-first steps of double, add and select; `scalars`
    are canonical (non-Montgomery) int32 words (N, 8)."""
    k = scalars.to(torch.int64) & 0xFFFFFFFF
    acc = infinity_half(p[0])
    for i in range(255, -1, -1):
        acc = double(acc)
        bit = ((k[:, i // 32] >> (i % 32)) & 1).bool()
        acc = _sel(bit, add(acc, p), acc)
    return acc


def to_affine(p: Half3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jacobian -> affine (x, y) by one Fp2 inversion; infinity comes
    back as (0, 0), as in the reference."""
    x, y, z = p
    zi = tw.fp2_inv(z)
    zi2 = tw.fp2_sqr(zi)
    yzi = tw.fp2_mul(y, zi)
    ax, ay = tw.fp2_mul_pairs((x, zi2), (yzi, zi2))
    return ax, ay


# ---------------------------------------------------------------- host I/O

def encode_points(pts: Sequence) -> np.ndarray:
    """Host G2 affine (Fp2 pairs) or None -> (N, 3, 2, 8) Montgomery Jacobian."""
    out = np.zeros((len(pts), 3, 2, lb.NWORDS), dtype=np.int32)
    one = tw.encode_fp2([(1, 0)])[0]
    for i, pt in enumerate(pts):
        if pt is None:
            continue
        out[i, :2] = tw.encode_fp2([pt[0], pt[1]])
        out[i, 2] = one
    return out


def decode_points(arr) -> list:
    """(..., 3, 2, 8) Montgomery Jacobian -> host affine Fp2 pairs (None
    for infinity); the inversion runs on the host."""
    coords = tw.decode_fp2(arr)
    out = []
    for i in range(0, len(coords), 3):
        x, y, z = coords[i : i + 3]
        if z == (0, 0):
            out.append(None)
            continue
        zinv = hm.fp2_inv(z)
        zi2 = hm.fp2_mul(zinv, zinv)
        out.append((hm.fp2_mul(x, zi2), hm.fp2_mul(hm.fp2_mul(y, zi2), zinv)))
    return out
