"""256-bit integers as 8 little-endian 32-bit words in int32 tensors.

A field element or scalar is a `(..., 8)` int32 tensor whose words are
reinterpreted as `uint32` by the CUDA kernels (`csrc/bn254_fp.cuh`). The
JAX package stores the same integers as 32 little-endian 8-bit limbs
(`fabric_token_sdk_tpu/ops/limbs.py`); Montgomery form uses R = 2^256 in
both, so a Montgomery value is the same integer in either layout.

Host helpers here convert python ints and the reference's limb arrays
to and from words. The carry-over functions canonicalize, because the
reference's field values may lie anywhere in its redundant [0, 2p).
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
NWORDS = 8  # 256-bit elements
REF_RADIX_BITS = 8
REF_NLIMBS = 32  # the reference's limbs per element


def int_to_words(x: int) -> np.ndarray:
    """Host: python int in [0, 2^256) -> (8,) int32 words."""
    if x < 0 or x >> (WORD_BITS * NWORDS):
        raise ValueError("int_to_words: value out of range")
    return np.frombuffer(x.to_bytes(4 * NWORDS, "little"), dtype="<i4").copy()


def ints_to_words(xs) -> np.ndarray:
    """Host: iterable of ints -> (N, 8) int32 words."""
    xs = list(xs)
    for x in xs:
        if x < 0 or x >> (WORD_BITS * NWORDS):
            raise ValueError("ints_to_words: value out of range")
    raw = b"".join(x.to_bytes(4 * NWORDS, "little") for x in xs)
    return np.frombuffer(raw, dtype="<i4").reshape(len(xs), NWORDS).copy()


def words_to_int(v) -> int:
    """Host: (8,) words (int32 or uint32 view) -> python int."""
    arr = np.ascontiguousarray(np.asarray(v).astype("<u4", copy=False))
    return int.from_bytes(arr.tobytes(), "little")


def batch_words_to_ints(arr) -> list:
    """Host: (..., 8) words -> flat list of python ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    flat = np.ascontiguousarray(np.asarray(arr, dtype=np.int32)).reshape(-1, NWORDS)
    raw = flat.astype("<i4", copy=False).tobytes()
    n = 4 * NWORDS
    return [int.from_bytes(raw[i * n : (i + 1) * n], "little") for i in range(flat.shape[0])]


# ------------------------------------------------------- reference carry-over

def from_reference_limbs(limbs: np.ndarray, modulus: int) -> torch.Tensor:
    """Reference `(..., 32)` int32 8-bit limbs -> `(..., 8)` int32 words,
    reduced into [0, modulus). The reference's redundant values in
    [0, 2p) come out canonical."""
    limbs = np.asarray(limbs)
    if limbs.shape[-1] != REF_NLIMBS:
        raise ValueError(f"expected (..., {REF_NLIMBS}) limbs, got {limbs.shape}")
    lead = limbs.shape[:-1]
    flat = limbs.reshape(-1, REF_NLIMBS).astype(object)
    vals = [
        sum(int(row[i]) << (REF_RADIX_BITS * i) for i in range(REF_NLIMBS)) % modulus
        for row in flat
    ]
    words = ints_to_words(vals) if vals else np.zeros((0, NWORDS), np.int32)
    return torch.from_numpy(words.reshape(lead + (NWORDS,)))


def to_reference_limbs(words) -> np.ndarray:
    """`(..., 8)` words (tensor or array) -> reference `(..., 32)` int32
    8-bit limbs, little-endian, of the same integers."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    w = np.ascontiguousarray(np.asarray(words, dtype=np.int32))
    if w.shape[-1] != NWORDS:
        raise ValueError(f"expected (..., {NWORDS}) words, got {w.shape}")
    as_bytes = w.astype("<i4", copy=False).view(np.uint8)
    return as_bytes.reshape(w.shape[:-1] + (REF_NLIMBS,)).astype(np.int32)
