"""PyTorch port, the host BN254 math (`crypto/hostmath.py`, a copy of
the JAX package's): mirrors of `tests/test_hostmath.py` (curve constants,
group laws, Fp2/Fp12, encodings, hashes, non-canonical encodings, the G2
subgroup check, multiexp lengths), each value held to the reference's.

Where the copy differs: the reference's `FTS_TPU_NO_NATIVE` opt-out of
the native library is not read (the port takes the native path whenever
it builds and passes its self-check), and `hash_to_zr_many` calls
`native.sha256_many` without the reference's `force_native` (the port's
`sha256_many` takes the native library whenever it loads); the digests
are the same either way. The two pairing cases are slow, as in the
reference."""

import hashlib
import inspect
import random

import pytest

from fabric_token_sdk_tpu.crypto import hostmath as ref_hm
from fabric_token_sdk_tpu_torch import native
from fabric_token_sdk_tpu_torch.crypto import hostmath as hm


def test_curve_constants():
    u = hm.U
    assert hm.P == 36 * u**4 + 36 * u**3 + 24 * u**2 + 6 * u + 1
    assert hm.R == 36 * u**4 + 36 * u**3 + 18 * u**2 + 6 * u + 1
    assert hm.g1_is_on_curve(hm.G1_GEN) and hm.g2_is_on_curve(hm.G2_GEN)
    assert (hm.P, hm.R, hm.U, hm.G1_GEN, hm.G2_GEN) == (
        ref_hm.P, ref_hm.R, ref_hm.U, ref_hm.G1_GEN, ref_hm.G2_GEN)


def test_g1_group_law(rng):
    g = hm.G1_GEN
    assert hm.g1_mul(g, hm.R) is None
    a, b = hm.rand_zr(rng), hm.rand_zr(rng)
    left = hm.g1_mul(g, (a + b) % hm.R)
    assert left == hm.g1_add(hm.g1_mul(g, a), hm.g1_mul(g, b)) == ref_hm.g1_mul(g, (a + b) % hm.R)
    assert hm.g1_add(left, hm.g1_neg(left)) is None


def test_g2_group_law(rng):
    q = hm.G2_GEN
    assert hm.g2_mul(q, hm.R) is None
    a, b = hm.rand_zr(rng), hm.rand_zr(rng)
    left = hm.g2_mul(q, (a + b) % hm.R)
    assert left == hm.g2_add(hm.g2_mul(q, a), hm.g2_mul(q, b)) == ref_hm.g2_mul(q, (a + b) % hm.R)


def test_fp2_fp12_field(rng):
    a = hm.fp2(rng.randrange(hm.P), rng.randrange(hm.P))
    assert hm.fp2_mul(a, hm.fp2_inv(a)) == hm.FP2_ONE
    x = tuple(hm.fp2(rng.randrange(hm.P), rng.randrange(hm.P)) for _ in range(6))
    assert hm.fp12_mul(x, hm.fp12_inv(x)) == hm.FP12_ONE
    assert hm.fp12_frobenius(x) == hm.fp12_pow(x, hm.P) == ref_hm.fp12_frobenius(x)


@pytest.mark.slow
def test_pairing_bilinear():
    p, q = hm.G1_GEN, hm.G2_GEN
    e = hm.pairing(p, q)
    assert e != hm.FP12_ONE and hm.fp12_pow(e, hm.R) == hm.FP12_ONE
    assert hm.pairing(hm.g1_mul(p, 17), hm.g2_mul(q, 29)) == hm.fp12_pow(e, 17 * 29)
    assert e == ref_hm.pairing(p, q)


@pytest.mark.slow
def test_pairing_product_unity():
    a = 123456789
    one = hm.pairing_product([(hm.g1_mul(hm.G1_GEN, a), hm.G2_GEN),
                              (hm.g1_neg(hm.G1_GEN), hm.g2_mul(hm.G2_GEN, a))])
    assert hm.gt_is_unity(one)


def test_encodings_roundtrip(rng):
    pt, q, z = hm.rand_g1(rng), hm.rand_g2(rng), hm.rand_zr(rng)
    assert hm.g1_from_bytes(hm.g1_to_bytes(pt)) == pt
    assert hm.g1_from_bytes(hm.g1_to_bytes(None)) is None
    assert hm.g2_from_bytes(hm.g2_to_bytes(q)) == q
    assert hm.zr_from_bytes(hm.zr_to_bytes(z)) == z
    assert (hm.g1_to_bytes(pt), hm.g2_to_bytes(q), hm.zr_to_bytes(z)) == (
        ref_hm.g1_to_bytes(pt), ref_hm.g2_to_bytes(q), ref_hm.zr_to_bytes(z))


def test_hash_to_zr_and_g1():
    z1 = hm.hash_to_zr(b"hello")
    assert z1 == hm.hash_to_zr(b"hello") == ref_hm.hash_to_zr(b"hello") and 0 <= z1 < hm.R
    assert hm.hash_to_zr(b"world") != z1
    pt = hm.hash_to_g1(b"hello")
    assert hm.g1_is_on_curve(pt) and pt == hm.hash_to_g1(b"hello") == ref_hm.hash_to_g1(b"hello")


def test_noncanonical_encodings_rejected(rng):
    pt = hm.rand_g1(rng)
    raw = bytearray(hm.g1_to_bytes(pt))
    big = b"\x00" + (pt[0] + hm.P).to_bytes(32, "big") + pt[1].to_bytes(32, "big")
    raw[0] = 7
    for bad in (big, bytes(raw), b"\x01" + b"\x00" * 63 + b"\x02", b"\x00" * 10):
        for mod in (hm, ref_hm):
            with pytest.raises(ValueError):
                mod.g1_from_bytes(bad)


def test_g2_subgroup_check(rng):
    while True:
        x = (rng.randrange(hm.P), rng.randrange(hm.P))
        y = hm.fp2_sqrt(hm.fp2_add(hm.fp2_mul(hm.fp2_sqr(x), x), hm.B2))
        if y is not None:
            pt = (x, y)
            break
    assert hm.g2_is_on_curve(pt) and not hm.g2_in_subgroup(pt)
    for mod in (hm, ref_hm):
        with pytest.raises(ValueError):
            mod.g2_from_bytes(hm.g2_to_bytes(pt))


def test_multiexp_length_mismatch():
    with pytest.raises(ValueError):
        hm.g1_multiexp([hm.G1_GEN], [1, 2])
    with pytest.raises(ValueError):
        hm.g2_multiexp([hm.G2_GEN, hm.G2_GEN], [1])


def test_the_copy_reads_no_opt_out_and_hashes_as_the_reference(monkeypatch):
    """The port's differences from the reference's copy: no
    `FTS_TPU_NO_NATIVE` opt-out, and `sha256_many` without `force_native`;
    `hash_to_zr_many` gives the reference's values and hashlib's digests."""
    assert "FTS_TPU_NO_NATIVE" not in inspect.getsource(hm)
    assert "force_native" not in inspect.signature(native.sha256_many).parameters
    rng = random.Random(0x5A5A)
    items = [(rng.randbytes(rng.randrange(1, 90)), b"fts-tpu/zr") for _ in range(9)]
    want = [hm.hash_to_zr(d, dom) for d, dom in items]
    assert hm.hash_to_zr_many(items) == want == ref_hm.hash_to_zr_many(items)
    msgs = [d for d, _ in items]
    assert native.sha256_many(msgs) == [hashlib.sha256(m).digest() for m in msgs]
    monkeypatch.setenv("FTS_TPU_NO_NATIVE", "1")  # read by nothing in the port
    assert hm.hash_to_zr_many(items) == want
