"""BN254 G1: the plain torch group ops, the fixed-base table, host I/O.

Counterpart of `fabric_token_sdk_tpu/ops/curve.py`. A batch of points is
an int32 tensor `(..., 3, 8)`: Jacobian (X, Y, Z) in Montgomery form,
Z == 0 encoding infinity.

The group ops here are the plain torch versions that the CUDA kernels
(`csrc/bn254_g1.cuh` and the `csrc/g1_*.cu` kernels, launched from
`ops/stages.py`) are held against. They use the reference's formulas
(dbl-2009-l, add-2007-bl) and its edge-case selects, so a result's
canonical Jacobian coordinates equal the reference's and the kernels'.
Internally a point is a tuple of three half-word coordinate tensors,
digit axis first (`ops/field.py`); field products that do not depend on
each other are stacked into one `FP.mul` call (the 16 products of an
addition become 5 calls, the 7 of a doubling 4), since the plain
version's cost is its count of torch operations; no value changes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import limbs as lb
from .field import FP, half_to_words, words_to_half
from ..crypto import hostmath as hm

WINDOW_BITS = 4
DIGITS_PER_SCALAR = 256 // WINDOW_BITS  # 64
WINDOW_SIZE = 1 << WINDOW_BITS  # 16

Half3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------- conversions

def to_half3(points: torch.Tensor) -> Half3:
    """int32 (N, 3, 8) -> (x, y, z) half-word tensors, each (16, N)."""
    h = words_to_half(points)  # (16, N, 3)
    return h[..., 0], h[..., 1], h[..., 2]


def from_half3(p: Half3) -> torch.Tensor:
    """(x, y, z) half-words (16, N) -> canonical int32 (N, 3, 8)."""
    x, y, z = (FP.canon(c) for c in p)
    return half_to_words(torch.stack([x, y, z], dim=-1))


def _stacked(op, *pairs):
    """Apply a field op to several independent operand pairs in one call."""
    a = torch.stack([p[0] for p in pairs], dim=1)
    b = torch.stack([p[1] for p in pairs], dim=1)
    return op(a, b).unbind(dim=1)


def _mul_n(*pairs):
    return _stacked(FP.mul, *pairs)


def _sel(mask: torch.Tensor, a: Half3, b: Half3) -> Half3:
    return tuple(torch.where(mask, u, v) for u, v in zip(a, b))


# ---------------------------------------------------------------- group ops

def infinity_half(like: torch.Tensor) -> Half3:
    z = torch.zeros_like(like)
    return z, z.clone(), z.clone()


def neg(p: Half3) -> Half3:
    return p[0], FP.neg(p[1]), p[2]


def double(p: Half3) -> Half3:
    """dbl-2009-l (a = 0); Z = 0 and Y = 0 fall out as Z3 = 0."""
    x, y, z = p
    a, b, yz = _mul_n((x, x), (y, y), (y, z))
    e = FP.add(FP.add(a, a), a)
    xb = FP.add(x, b)
    c, xb2, f = _mul_n((b, b), (xb, xb), (e, e))
    d = FP.sub(xb2, FP.add(a, c))
    d = FP.add(d, d)
    x3 = FP.sub(f, FP.add(d, d))
    c8 = FP.add(c, c)
    c8 = FP.add(c8, c8)
    c8 = FP.add(c8, c8)
    y3 = FP.sub(FP.mul(e, FP.sub(d, x3)), c8)
    z3 = FP.add(yz, yz)  # (y + y) z
    return x3, y3, z3


def add(p: Half3, q: Half3) -> Half3:
    """add-2007-bl with the reference's selects, in its order: P == Q ->
    double(P); P == -Q -> all-zero infinity; P at infinity -> Q; Q at
    infinity -> P. (The plain version computes the doubling only when
    some row needs it; the kernel computes it always.)"""
    x1, y1, z1 = p
    x2, y2, z2 = q
    zs = FP.add(z1, z2)
    z1z1, z2z2, zz, y1z2, y2z1 = _mul_n((z1, z1), (z2, z2), (zs, zs), (y1, z2), (y2, z1))
    u1, u2, s1, s2 = _mul_n((x1, z2z2), (x2, z1z1), (y1z2, z2z2), (y2z1, z1z1))
    h, rr = _stacked(FP.sub, (u2, u1), (s2, s1))
    hh, rr = _stacked(FP.add, (h, h), (rr, rr))
    zh = FP.sub(zz, FP.add(z1z1, z2z2))
    i, r2, z3 = _mul_n((hh, hh), (rr, rr), (zh, h))
    j, v = _mul_n((h, i), (u1, i))
    x3 = FP.sub(r2, FP.add(j, FP.add(v, v)))
    s1j, t = _mul_n((s1, j), (rr, FP.sub(v, x3)))
    y3 = FP.sub(t, FP.add(s1j, s1j))
    out = (x3, y3, z3)

    same_x, same_y, inf1, inf2 = FP.is_zero(torch.stack([h, rr, z1, z2], dim=1)).unbind(0)
    finite = ~inf1 & ~inf2
    dbl = same_x & same_y & finite
    if bool(dbl.any()):
        out = _sel(dbl, double(p), out)
    out = _sel(same_x & ~same_y & finite, infinity_half(x1), out)
    out = _sel(inf1, q, out)
    out = _sel(inf2, p, out)
    return out


def scalar_mul(p: Half3, scalars: torch.Tensor) -> Half3:
    """[k]P by 256 MSB-first steps of double, add and select; `scalars`
    are canonical (non-Montgomery) int32 words (N, 8)."""
    k = scalars.to(torch.int64) & 0xFFFFFFFF
    acc = infinity_half(p[0])
    for i in range(255, -1, -1):
        acc = double(acc)
        bit = ((k[:, i // 32] >> (i % 32)) & 1).bool()
        acc = _sel(bit, add(acc, p), acc)
    return acc


def msm(table: torch.Tensor, scalars: torch.Tensor, select: bool = False) -> Half3:
    """Fixed-base multiexp: sum_b scalars[:, b] * base_b, by adding the
    window entries in the reference's order (base-major, 4-bit windows
    LSB-first). table (nb*64, 16, 3, 8); scalars (N, nb, 8).

    Each window's entry is gathered by the digit, or with `select` picked
    as the reference's `msm_select` does for secret scalars: the 16-way
    one-hot of the digit times all 16 entries, summed, in exact integer
    arithmetic. Both give the same points."""
    n, nbases = scalars.shape[0], scalars.shape[1]
    tab = words_to_half(table)  # (16, nb*64, 16, 3)
    k = scalars.to(torch.int64) & 0xFFFFFFFF
    entries = torch.arange(WINDOW_SIZE, device=tab.device)
    acc = infinity_half(tab.new_zeros((tab.shape[0], n)))
    for b in range(nbases):
        for w in range(DIGITS_PER_SCALAR):
            digit = (k[:, b, w // 8] >> (WINDOW_BITS * (w % 8))) & (WINDOW_SIZE - 1)
            window = tab[:, b * DIGITS_PER_SCALAR + w]  # (16, 16 entries, 3)
            if select:
                onehot = (digit[:, None] == entries).to(tab.dtype)  # (N, 16)
                sel = (onehot[None, :, :, None] * window[:, None]).sum(dim=2)  # (16, N, 3)
            else:
                sel = window[:, digit]
            acc = add(acc, (sel[..., 0], sel[..., 1], sel[..., 2]))
    return acc


# ---------------------------------------------------------------- host I/O

_R_MOD_P = (1 << lb.WORD_BITS * lb.NWORDS) % hm.P


def encode_point(pt) -> np.ndarray:
    """Host affine (x, y) or None -> (3, 8) Montgomery Jacobian words."""
    return encode_points([pt])[0]


def encode_points(pts: Sequence) -> np.ndarray:
    """Host affine points (None = infinity) -> (N, 3, 8) int32 words."""
    vals = []
    for pt in pts:
        if pt is None:
            vals.extend((0, 0, 0))
        else:
            x, y = pt
            vals.extend((x * _R_MOD_P % hm.P, y * _R_MOD_P % hm.P, _R_MOD_P))
    if not vals:
        return np.zeros((0, 3, lb.NWORDS), dtype=np.int32)
    return lb.ints_to_words(vals).reshape(-1, 3, lb.NWORDS)


def decode_points(arr) -> list:
    """(..., 3, 8) Montgomery Jacobian words -> host affine tuples (None
    for infinity). Pure host arithmetic: one multiply by R^-1 per
    coordinate and a Fermat inverse of Z."""
    rinv = pow(1 << lb.WORD_BITS * lb.NWORDS, -1, hm.P)
    vals = lb.batch_words_to_ints(arr)
    out = []
    for i in range(0, len(vals), 3):
        x, y, z = (v * rinv % hm.P for v in vals[i : i + 3])
        if z == 0:
            out.append(None)
            continue
        zinv = hm.fp_inv(z)
        zi2 = zinv * zinv % hm.P
        out.append((x * zi2 % hm.P, y * zi2 % hm.P * zinv % hm.P))
    return out


def encode_scalars(ks) -> np.ndarray:
    """Host ints -> canonical scalar words (N, 8), reduced mod r."""
    return lb.ints_to_words([k % hm.R for k in ks])


# ---------------------------------------------------------------- fixed base

class FixedBaseTable(torch.nn.Module):
    """Windowed multiples of fixed bases for the batched multiexp.

    The buffer `table` has shape (nbases*64, 16, 3, 8): entry [64b + w][d]
    is base_b * d * 16^w as Montgomery Jacobian words, so `.to(device)`
    moves it with the module. For 3 bases it is 295 KB.
    """

    def __init__(self, host_points: Sequence = (), table: torch.Tensor = None):
        super().__init__()
        if table is None:
            entries = []
            for pt in host_points:
                for w in range(DIGITS_PER_SCALAR):
                    step = hm.g1_mul(pt, (1 << (WINDOW_BITS * w)) % hm.R)
                    acc = None
                    for _ in range(WINDOW_SIZE):
                        entries.append(acc)
                        acc = hm.g1_add(acc, step)
            table = torch.from_numpy(encode_points(entries)).reshape(
                -1, WINDOW_SIZE, 3, lb.NWORDS
            )
        if table.dim() != 4 or table.shape[0] % DIGITS_PER_SCALAR or table.shape[1:] != (
            WINDOW_SIZE, 3, lb.NWORDS
        ):
            raise ValueError(f"bad fixed-base table shape {tuple(table.shape)}")
        self.register_buffer("table", table.to(torch.int32).contiguous())

    @property
    def nbases(self) -> int:
        return self.table.shape[0] // DIGITS_PER_SCALAR

    @classmethod
    def from_reference(cls, flat) -> "FixedBaseTable":
        """Take the reference's (nbases*64, 16, 96) 8-bit-limb table."""
        flat = np.asarray(flat)
        limbs = flat.reshape(flat.shape[:2] + (3, lb.REF_NLIMBS))
        return cls(table=lb.from_reference_limbs(limbs, hm.P))

    def forward(self, scalars: torch.Tensor) -> torch.Tensor:
        """Canonical scalars (N, nbases, 8) -> (N, 3, 8) points."""
        from . import stages

        return stages.g1_msm_rows(self.table, scalars)
