"""BN254 G1: the plain torch group ops, the fixed-base table, host I/O.

Counterpart of `fabric_token_sdk_tpu/ops/curve.py`. A batch of points is
an int32 tensor `(..., 3, 8)`: Jacobian (X, Y, Z) in Montgomery form,
Z == 0 encoding infinity.

The group ops here are the plain torch versions that the CUDA kernels
(the `csrc/g1_*.cu` kernels, launched from `ops/stages.py`) are held
against. They use the reference's formulas (dbl-2009-l, add-2007-bl)
and its edge-case selects, so a result's
canonical Jacobian coordinates equal the reference's and the kernels';
the variable-base `scalar_mul` takes the kernels' 4-bit window ladder
(`window_mul`), and the fixed-base `msm` the g1_msm kernels' split
windows and complete projective additions: both reach the reference's
group element with another Jacobian Z.
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


def window_mul(p: Half3, scalars: torch.Tensor, dbl, add) -> Half3:
    """[k]P by the 4-bit fixed window of the g1_mul and g2_mul kernels
    (`csrc/bn254_ladder.cuh`): the table T[0] = infinity, T[1] = P,
    T[2] = dbl(P), T[i] = add(T[i-1], P); then acc = T[d63] and, for
    each window below it MSB-first, acc = add(dbl^4(acc), T[d]).
    `scalars` are canonical (non-Montgomery) int32 words (N, 8), read as
    given; `dbl` and `add` are the group's formulas (G1 here, G2 in
    `curve2`). The same group element as the reference's bit ladder,
    with another Jacobian Z."""
    k = scalars.to(torch.int64) & 0xFFFFFFFF
    table = [tuple(torch.zeros_like(c) for c in p), p, dbl(p)]
    for _ in range(3, WINDOW_SIZE):
        table.append(add(table[-1], p))
    stacked = [torch.stack([t[c] for t in table]) for c in range(3)]  # (16, limbs, N, ...)

    def pick(w: int) -> Half3:
        digit = (k[:, w // 8] >> (WINDOW_BITS * (w % 8))) & (WINDOW_SIZE - 1)
        out = []
        for s in stacked:
            idx = digit.view((1, 1, -1) + (1,) * (s.dim() - 3)).expand((1,) + s.shape[1:])
            out.append(torch.gather(s, 0, idx)[0])
        return tuple(out)

    acc = pick(DIGITS_PER_SCALAR - 1)
    for w in range(DIGITS_PER_SCALAR - 2, -1, -1):
        for _ in range(WINDOW_BITS):
            acc = dbl(acc)
        acc = add(acc, pick(w))
    return acc


def scalar_mul(p: Half3, scalars: torch.Tensor) -> Half3:
    """[k]P on G1 by the kernels' window ladder (`window_mul`)."""
    return window_mul(p, scalars, double, add)


# ---------------------------------------------------------------- multiexp
# The fixed-base multiexp of the g1_msm kernels (csrc/g1_msm.cu), in
# homogeneous projective coordinates (x = X/Z, y = Y/Z) with the complete
# formulas of Renes, Costello and Batina (2016) for a = 0: every input,
# P == Q, P == -Q and the identity (0 : 1 : 0) included, takes the same
# field operations, so no case needs a select or a doubling.

# lanes that share a row's windows in the kernels (FTS_G1_MSM_S)
MSM_SPLIT = 8


def _times9(x):
    """9x = 8x + x by doubling (3b for b = 3)."""
    x2 = FP.add(x, x)
    x4 = FP.add(x2, x2)
    return FP.add(FP.add(x4, x4), x)


def proj_madd(p: Half3, x2, y2) -> Half3:
    """Complete mixed addition (RCB Algorithm 8, a = 0): projective P
    plus the affine point (x2, y2), which must not be the identity. 11
    products; the operation order is the kernel's."""
    x1, y1, z1 = p
    t0, t1, t4, y3 = _mul_n((x1, x2), (y1, y2), (y2, z1), (x2, z1))
    t3 = FP.mul(FP.add(x2, y2), FP.add(x1, y1))
    t3 = FP.sub(t3, FP.add(t0, t1))
    t4 = FP.add(t4, y1)
    y3 = FP.add(y3, x1)
    x3 = FP.add(t0, t0)
    t0 = FP.add(x3, t0)
    t2 = _times9(z1)
    z3 = FP.add(t1, t2)
    t1 = FP.sub(t1, t2)
    y3 = _times9(y3)
    x3, t2, y3, t1, t0, z3 = _mul_n((t4, y3), (t3, t1), (y3, t0), (t1, z3), (t0, t3), (z3, t4))
    return FP.sub(t2, x3), FP.add(t1, y3), FP.add(z3, t0)


def proj_add(p: Half3, q: Half3) -> Half3:
    """Complete addition (RCB Algorithm 7, a = 0) of projective points.
    12 products; the operation order is the kernel's."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0, t1, t2 = _mul_n((x1, x2), (y1, y2), (z1, z2))
    t3, t4, x3 = _mul_n((FP.add(x1, y1), FP.add(x2, y2)), (FP.add(y1, z1), FP.add(y2, z2)),
                        (FP.add(x1, z1), FP.add(x2, z2)))
    t3 = FP.sub(t3, FP.add(t0, t1))
    t4 = FP.sub(t4, FP.add(t1, t2))
    y3 = FP.sub(x3, FP.add(t0, t2))
    x3 = FP.add(t0, t0)
    t0 = FP.add(x3, t0)
    t2 = _times9(t2)
    z3 = FP.add(t1, t2)
    t1 = FP.sub(t1, t2)
    y3 = _times9(y3)
    x3, t2, y3, t1, t0, z3 = _mul_n((t4, y3), (t3, t1), (y3, t0), (t1, z3), (t0, t3), (z3, t4))
    return FP.sub(t2, x3), FP.add(t1, y3), FP.add(z3, t0)


def proj_to_jacobian(p: Half3) -> Half3:
    """(X : Y : Z) projective -> (X Z, Y Z^2, Z) Jacobian: the same point,
    and the identity (Z = 0) becomes the all-zero Jacobian infinity."""
    x, y, z = p
    zz, xz = _mul_n((z, z), (x, z))
    return xz, FP.mul(y, zz), z


def msm(table: torch.Tensor, scalars: torch.Tensor, select: bool = False,
        split: int = MSM_SPLIT) -> Half3:
    """Fixed-base multiexp: sum_b scalars[:, b] * base_b over 4-bit
    windows, in the g1_msm kernels' exact sequence. table (nb*64, 16, 3,
    8) with affine (Z = 1) or all-zero entries; scalars (N, nb, 8).

    A row's nb*64 windows t = 64 b + w (base-major, windows LSB-first)
    fall into `split` equal shares, lane j owning t in [j T/S, (j+1) T/S);
    each lane adds its entries in order into a projective accumulator
    that starts at the identity (a complete mixed addition; an all-zero
    entry, digit 0, keeps the accumulator by a select). The lanes' sums
    are then joined by a pairwise tree of complete additions (lane 2i
    with 2i + 1, lower lane first), as the kernel's butterfly leaves them
    in lane 0, and the sum is returned in Jacobian coordinates. The same
    point as the reference's scan of Jacobian adds, with another Z.

    Each window's entry is gathered by the digit, or with `select` picked
    as the reference's `msm_select` does for secret scalars: the 16-way
    one-hot of the digit times all 16 entries, summed, in exact integer
    arithmetic. Both give the same words."""
    n, nbases = scalars.shape[0], scalars.shape[1]
    total = nbases * DIGITS_PER_SCALAR
    if total % split:
        raise ValueError(f"{total} windows do not split into {split} lanes")
    share = total // split
    tab = words_to_half(table)[..., :2]  # (16, nb*64, 16 entries, 2): X, Y
    k = scalars.to(torch.int64) & 0xFFFFFFFF
    entries = torch.arange(WINDOW_SIZE, device=tab.device)
    lanes = torch.arange(split, device=tab.device) * share
    zero = tab.new_zeros((tab.shape[0], n, split))
    acc = (zero, FP.one_half(zero), zero.clone())
    for i in range(share):
        t = lanes + i  # (S,) this step's window of every lane
        b, w = t // DIGITS_PER_SCALAR, t % DIGITS_PER_SCALAR
        word = k[:, b, w // 8]  # (N, S)
        digit = (word >> (WINDOW_BITS * (w % 8))) & (WINDOW_SIZE - 1)
        if select:
            onehot = (digit[..., None] == entries).to(tab.dtype)  # (N, S, 16)
            sel = (onehot[None, ..., None] * tab[:, t][:, None]).sum(dim=3)  # (16, N, S, 2)
        else:
            sel = tab[:, t[None, :], digit]  # (16, N, S, 2)
        x2, y2 = sel[..., 0], sel[..., 1]
        out = proj_madd(acc, x2, y2)
        keep = FP.is_zero(y2)  # an all-zero entry: no affine point has y = 0
        acc = tuple(torch.where(keep, a, o) for a, o in zip(acc, out))
    while acc[0].shape[-1] > 1:
        acc = proj_add(tuple(c[..., 0::2] for c in acc), tuple(c[..., 1::2] for c in acc))
    return proj_to_jacobian(tuple(c[..., 0] for c in acc))


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

def check_affine_table(table: torch.Tensor) -> None:
    """Raise unless every entry of a fixed-base table is affine (Z is
    Montgomery one) or the all-zero infinity (X, Y and Z zero), mod p: the
    g1_msm kernels and `msm` read only X and Y of an entry."""
    vals = lb.batch_words_to_ints(table.reshape(-1, 3, lb.NWORDS))
    for i in range(0, len(vals), 3):
        x, y, z = (v % hm.P for v in vals[i : i + 3])
        if z != _R_MOD_P and (x, y, z) != (0, 0, 0):
            raise ValueError(f"fixed-base table entry {i // 3} is neither affine nor the "
                             "all-zero infinity")


class FixedBaseTable(torch.nn.Module):
    """Windowed multiples of fixed bases for the batched multiexp.

    The buffer `table` has shape (nbases*64, 16, 3, 8): entry [64b + w][d]
    is base_b * d * 16^w as Montgomery Jacobian words with Z = 1 (the
    all-zero infinity for d = 0), so `.to(device)` moves it with the
    module. For 3 bases it is 295 KB. A table given as `table=` or loaded
    from a state dict is checked to be affine (`check_affine_table`).
    """

    def __init__(self, host_points: Sequence = (), table: torch.Tensor = None):
        super().__init__()
        if table is not None:
            check_affine_table(table)
        else:
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

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if prefix + "table" in state_dict:
            check_affine_table(state_dict[prefix + "table"])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

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
