"""BN254 Montgomery prime fields: host constants and the plain torch oracle.

Counterpart of `fabric_token_sdk_tpu/ops/field.py`. A `FieldSpec` holds
the modulus and its Montgomery constants (R = 2^256, the same integers
as the reference). Field arithmetic has two implementations:

* the CUDA `__device__` functions in `csrc/bn254_fp.cuh` (CIOS
  Montgomery multiply, add, sub, neg, canonicalize, Fermat inverse),
  which every G1 kernel includes;
* the plain torch version below, which the CPU tests run and against
  which the kernels are held on the card.

The plain version works on int64 tensors of 16 little-endian 16-bit
half-words, digit axis first, `(16, ...)`: a half-word product is below 2^32, so a whole
schoolbook column and the Montgomery reduction's additions stay far
inside int64. It uses integer ops only (no float matmul, so TF32 cannot
touch it) and signed int64 shifts, whose floor semantics are exact for
the borrows of a subtraction.

Values live in the redundant domain [0, 2p), as in the reference:
`mul`, `add`, `sub` and `neg` take and return values there, and
`canon` maps to [0, p).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from . import limbs as lb
from ..crypto import hostmath as hm

HALF_BITS = 16
NHALF = 16  # half-words per element
HALF_MASK = (1 << HALF_BITS) - 1
R_BITS = lb.WORD_BITS * lb.NWORDS  # Montgomery R = 2^256


def words_to_half(w: torch.Tensor) -> torch.Tensor:
    """int32 words (..., 8) -> int64 half-words, digit axis first: (16, ...)."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    h = torch.stack([u & HALF_MASK, u >> HALF_BITS], dim=-1).flatten(-2)
    return h.movedim(-1, 0).contiguous()


def half_to_words(h: torch.Tensor) -> torch.Tensor:
    """Normalized int64 half-words (16, ...) -> int32 words (..., 8)."""
    u = h[0::2] | (h[1::2] << HALF_BITS)
    return (u - ((u >> 31) << 32)).to(torch.int32).movedim(0, -1).contiguous()


def _carry(x: torch.Tensor) -> torch.Tensor:
    """Propagate carries (or borrows) through signed int64 digits (digit
    axis first): every digit but the top lands in [0, 2^16); the top
    digit takes what is left (negative when the value is)."""
    x = x.clone()
    for i in range(x.shape[0] - 1):
        x[i + 1] += x[i] >> HALF_BITS
    x[:-1] &= HALF_MASK
    return x


def _pad1(x: torch.Tensor) -> torch.Tensor:
    """Append one zero digit (the digit axis is first)."""
    return torch.cat([x, torch.zeros_like(x[:1])])


@dataclass(frozen=True, eq=False)
class FieldSpec:
    """A prime field with its Montgomery constants, R = 2^256."""

    name: str
    modulus: int
    p_words: np.ndarray = field(init=False, repr=False)
    twop_words: np.ndarray = field(init=False, repr=False)
    one_mont: np.ndarray = field(init=False, repr=False)  # R mod p
    r2_words: np.ndarray = field(init=False, repr=False)  # R^2 mod p
    pinv32: int = field(init=False, repr=False)  # -p^-1 mod 2^32
    pinv16: int = field(init=False, repr=False)  # -p^-1 mod 2^16
    _consts: Dict = field(init=False, repr=False, default_factory=dict)

    def __post_init__(self):
        R = 1 << R_BITS
        # the redundant-domain REDC needs 4p <= R: products of two [0, 2p)
        # values then reduce back into [0, 2p) with no final subtraction
        if 4 * self.modulus > R or self.modulus % 2 == 0:
            raise ValueError("modulus must be odd with 4p within 2^256")
        put = functools.partial(object.__setattr__, self)
        put("p_words", lb.int_to_words(self.modulus))
        put("twop_words", lb.int_to_words(2 * self.modulus))
        put("one_mont", lb.int_to_words(R % self.modulus))
        put("r2_words", lb.int_to_words(R * R % self.modulus))
        put("pinv32", (-pow(self.modulus, -1, 1 << 32)) % (1 << 32))
        put("pinv16", (-pow(self.modulus, -1, 1 << 16)) % (1 << 16))

    # ------------------------------------------------------------ constants

    def half_const(self, value: int, like: torch.Tensor) -> torch.Tensor:
        """`value` as half-words shaped (16, 1, ...) to broadcast against
        `like` (digit axis first), on its device; cached per device."""
        key = (value, str(like.device))
        t = self._consts.get(key)
        if t is None:
            t = words_to_half(torch.from_numpy(lb.int_to_words(value))).to(like.device)
            self._consts[key] = t
        return t.view((NHALF,) + (1,) * (like.dim() - 1))

    # ------------------------------------------------------------ plain ops
    #
    # Operands are int64 half-word tensors with the digit axis FIRST,
    # (16, ...): `x[i]` is then a cheap view, and the carry loops touch
    # whole rows of the batch at once.

    def _select_sub(self, x: torch.Tensor, m: int) -> torch.Tensor:
        """x - m if x >= m else x (x normalized, below 2^256)."""
        d = _carry(_pad1(x) - _pad1(self.half_const(m, x)))
        return torch.where(d[-1] < 0, x, d[:-1])

    def canon(self, x: torch.Tensor) -> torch.Tensor:
        """[0, 2p) -> [0, p)."""
        return self._select_sub(x, self.modulus)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """[0, 2p) + [0, 2p) -> [0, 2p): add, then subtract 2p unless
        that borrows (a + b < 4p < 2^256, so nothing carries out)."""
        return self._select_sub(_carry(a + b), 2 * self.modulus)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a - b in [0, 2p): subtract, and add 2p back if it borrowed
        (the carry out of that addition is dropped: it is the 2^256 the
        borrow lent)."""
        d = _carry(_pad1(a) - _pad1(b))
        e = _carry(_pad1(d[:-1] + self.half_const(2 * self.modulus, a)))[:-1]
        return torch.where(d[-1] < 0, e, d[:-1])

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a*b/R mod p, in [0, 2p): schoolbook columns,
        then one 16-bit REDC step per half-word.

        Bounds: a column holds at most 16 products below 2^32 plus 16
        reduction terms below 2^32 and the carries, so below 2^38, and
        `t[i] * pinv16` stays below 2^54."""
        a, b = torch.broadcast_tensors(a, b)
        t = torch.zeros((2 * NHALF + 2,) + a.shape[1:], dtype=torch.int64, device=a.device)
        for i in range(NHALF):
            t[i : i + NHALF].addcmul_(a[i][None], b)
        p16 = self.half_const(self.modulus, a)
        for i in range(NHALF):
            m = (t[i] * self.pinv16) & HALF_MASK
            t[i : i + NHALF].addcmul_(m[None], p16)
            t[i + 1] += t[i] >> HALF_BITS  # t[i] is 0 mod 2^16 now
        return _carry(t[NHALF : 2 * NHALF + 1])[:NHALF]

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def pow_const(self, x: torch.Tensor, e: int) -> torch.Tensor:
        """x^e (Montgomery) for a python-int exponent, MSB first."""
        acc = self.one_half(x)
        for bit in bin(e)[2:] if e else "":
            acc = self.sqr(acc)
            if bit == "1":
                acc = self.mul(acc, x)
        return acc

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        """Montgomery inverse by Fermat, x^(p-2); maps 0 to 0."""
        return self.pow_const(x, self.modulus - 2)

    def is_zero(self, x: torch.Tensor) -> torch.Tensor:
        """Zero test in the redundant domain (0 and p both represent 0)."""
        return (self.canon(x) == 0).all(dim=0)

    def eq(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return (self.canon(x) == self.canon(y)).all(dim=0)

    def to_mont(self, x: torch.Tensor) -> torch.Tensor:
        return self.mul(x, self.half_const(int(lb.words_to_int(self.r2_words)), x))

    def from_mont(self, x: torch.Tensor) -> torch.Tensor:
        return self.mul(x, self.half_const(1, x))

    def one_half(self, like: torch.Tensor) -> torch.Tensor:
        """Montgomery one (R mod p), shaped like `like`."""
        return self.half_const((1 << R_BITS) % self.modulus, like).expand_as(like).clone()


@functools.lru_cache(maxsize=None)
def _specs():
    return FieldSpec("bn254_fp", hm.P), FieldSpec("bn254_fr", hm.R)


FP, FR = _specs()


# ------------------------------------------------------------ field check

def fp_ops_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the fp_ops kernel: for Montgomery words a, b
    (N, 8) in [0, 2p), canonical (mul, add, sub, inv(a)) as (N, 4, 8)."""
    x, y = words_to_half(a), words_to_half(b)
    outs = [FP.mul(x, y), FP.add(x, y), FP.sub(x, y), FP.inv(x)]
    return half_to_words(torch.stack([FP.canon(o) for o in outs], dim=-1))


def fp_ops(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The field layer alone, for checking it on the card: launches the
    fp_ops kernel for CUDA tensors, runs the plain version on the CPU."""
    from ._build import FP_OPS, check_cuda_tensor

    if a.device.type == "cpu" and b.device.type == "cpu":
        return fp_ops_plain(a, b)
    n = a.shape[0]
    check_cuda_tensor("fp_ops a", a, (n, lb.NWORDS))
    check_cuda_tensor("fp_ops b", b, (n, lb.NWORDS))
    out = torch.empty((n, 4, lb.NWORDS), dtype=torch.int32, device=a.device)
    FP_OPS.launch(a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), n)
    return out
