"""PyTorch port, field layer: words, carry-over, and the plain Fp/Fr
oracle against hostmath and the JAX package's FieldSpec.

Inputs come from `random.Random(seed)` and go to both packages; values
are compared as canonical integers (exact equality: the arithmetic is
integer). Redundant inputs in [p, 2p) are part of every batch."""

import os
import random
import re

import numpy as np
import pytest
import torch

from fabric_token_sdk_tpu.crypto import hostmath as ref_hm
from fabric_token_sdk_tpu.ops import field as ref_field, limbs as ref_lb
from fabric_token_sdk_tpu_torch.ops import field as fd, limbs as lb

P, R = ref_hm.P, ref_hm.R
RMONT = 1 << 256
CSRC = os.path.join(os.path.dirname(__file__), "..", "fabric_token_sdk_tpu_torch", "csrc")


def _values(seed, modulus, n=24):
    rng = random.Random(seed)
    edges = [0, 1, modulus - 1, modulus, modulus + 1, 2 * modulus - 1]
    return edges + [rng.randrange(2 * modulus) for _ in range(n)]


def _half(vals):
    return fd.words_to_half(torch.from_numpy(lb.ints_to_words(vals)))


def _ints(h):
    return lb.batch_words_to_ints(fd.half_to_words(h))


def _ref_canon_ints(spec, x):
    return ref_lb.batch_limbs_to_ints(np.asarray(spec.cond_sub_p(x)))


def test_words_roundtrip_and_bounds():
    rng = random.Random(1)
    vals = [0, 1, (1 << 256) - 1, 1 << 255] + [rng.getrandbits(256) for _ in range(20)]
    w = lb.ints_to_words(vals)
    assert w.dtype == np.int32 and w.shape == (len(vals), 8)
    assert lb.batch_words_to_ints(w) == vals
    assert [lb.words_to_int(row) for row in w] == vals
    assert lb.words_to_int(lb.int_to_words(vals[5])) == vals[5]
    for bad in (-1, 1 << 256):
        with pytest.raises(ValueError):
            lb.int_to_words(bad)


def test_reference_limbs_carry_over_canonicalizes():
    vals = _values(2, P)
    ref = ref_lb.ints_to_limbs(vals)  # (N, 32) 8-bit limbs, some in [p, 2p)
    words = lb.from_reference_limbs(ref, P)
    assert words.dtype == torch.int32 and words.shape == (len(vals), 8)
    assert lb.batch_words_to_ints(words) == [v % P for v in vals]
    canon = ref_lb.ints_to_limbs([v % P for v in vals])
    np.testing.assert_array_equal(lb.to_reference_limbs(words), canon)


def test_cuda_header_constants_match_hostmath():
    """The constants written into csrc/bn254_fp.cuh by hand are p, 2p,
    p - 2, R mod p and -p^-1 mod 2^32."""
    src = open(os.path.join(CSRC, "bn254_fp.cuh")).read()

    def arr(name):
        body = re.search(name + r"\[NW\] = \{([^}]*)\}", src).group(1)
        words = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        return sum(w << (32 * i) for i, w in enumerate(words))

    assert arr("FP_P") == P
    assert arr("FP_2P") == 2 * P
    assert arr("FP_PM2") == P - 2
    assert arr("FP_ONE") == RMONT % P
    pinv = int(re.search(r"FP_PINV = (0x[0-9a-f]+)u", src).group(1), 16)
    assert pinv == fd.FP.pinv32 == (-pow(P, -1, 1 << 32)) % (1 << 32)
    assert int(re.search(r"FP_PM2_BITS = (\d+)", src).group(1)) == (P - 2).bit_length()


@pytest.mark.parametrize("which", ["fp", "fr"])
def test_plain_ring_ops_match_hostmath(which):
    spec = fd.FP if which == "fp" else fd.FR
    m = spec.modulus
    xs, ys = _values(3, m), _values(4, m)[::-1]
    a, b = _half(xs), _half(ys)
    rinv = pow(RMONT, -1, m)
    for name, got, want in (
        ("mul", spec.mul(a, b), [x * y * rinv % m for x, y in zip(xs, ys)]),
        ("add", spec.add(a, b), [(x + y) % m for x, y in zip(xs, ys)]),
        ("sub", spec.sub(a, b), [(x - y) % m for x, y in zip(xs, ys)]),
        ("neg", spec.neg(a), [(-x) % m for x in xs]),
    ):
        raw = _ints(got)
        assert all(v < 2 * m for v in raw), name  # stays in the redundant domain
        assert [v % m for v in raw] == want, name
        assert _ints(spec.canon(got)) == want, name
    assert spec.is_zero(a).tolist() == [x % m == 0 for x in xs]
    assert spec.eq(a, _half([x % m for x in xs])).all()


def test_plain_chained_ops_stay_exact():
    """Outputs of one op feed the next (the G1 formulas do nothing else):
    a carry that escaped the top half-word would show here."""
    xs, ys = _values(5, P), _values(6, P)
    a, b = _half(xs), _half(ys)
    rinv = pow(RMONT, -1, P)
    got = _ints(fd.FP.canon(fd.FP.mul(fd.FP.sub(a, b), fd.FP.add(fd.FP.sub(b, a), fd.FP.neg(a)))))
    want = [(x - y) * ((y - x) - x) * rinv % P for x, y in zip(xs, ys)]
    assert got == want


def test_plain_inverse_and_domain():
    xs = _values(7, P, n=4)
    a = _half(xs)
    inv = _ints(fd.FP.canon(fd.FP.inv(a)))
    for x, got in zip(xs, inv):
        plain = x * pow(RMONT, -1, P) % P  # the value x represents
        want = pow(plain, -1, P) * RMONT % P if plain else 0
        assert got == want
        assert ref_hm.fp_inv(plain) * RMONT % P == want or plain == 0
    mont = fd.FP.to_mont(_half([x % P for x in xs]))
    assert _ints(fd.FP.canon(mont)) == [x % P * RMONT % P for x in xs]
    assert _ints(fd.FP.canon(fd.FP.from_mont(mont))) == [x % P for x in xs]


def test_plain_ops_match_reference_fieldspec():
    ref = ref_field.FP
    xs, ys = _values(8, P), _values(9, P)[::-1]
    ra, rb = ref_lb.ints_to_limbs(xs), ref_lb.ints_to_limbs(ys)
    a, b = _half(xs), _half(ys)
    for got, want in (
        (fd.FP.mul(a, b), ref.mul(ra, rb)),
        (fd.FP.add(a, b), ref.add(ra, rb)),
        (fd.FP.sub(a, b), ref.sub(ra, rb)),
        (fd.FP.neg(a), ref.neg(ra)),
    ):
        assert _ints(fd.FP.canon(got)) == _ref_canon_ints(ref, want)


def test_fp_ops_plain_layout():
    xs, ys = _values(10, P), _values(11, P)
    a = torch.from_numpy(lb.ints_to_words(xs))
    b = torch.from_numpy(lb.ints_to_words(ys))
    out = fd.fp_ops(a, b)  # CPU tensors: the plain version
    assert out.shape == (len(xs), 4, 8) and out.dtype == torch.int32
    rinv = pow(RMONT, -1, P)
    vals = lb.batch_words_to_ints(out)
    for i, (x, y) in enumerate(zip(xs, ys)):
        assert vals[4 * i : 4 * i + 3] == [x * y * rinv % P, (x + y) % P, (x - y) % P]
