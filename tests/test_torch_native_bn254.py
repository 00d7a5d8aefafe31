"""PyTorch port, the native BN254 host library (`native/bn254.c` behind
`native/bn254py.py`, copies of the JAX package's): mirrors of
`tests/test_native_bn254.py`, the C library against the pure-Python
definitions on every exported operation (G1 and G2 ladders, batches,
multiexps, sums, pairings) and the reference's native library on the
same inputs; and `crypto/hostmath.py:_install_native`'s self-check,
which adopts the native path only when every function family agrees
with the pure twin, counting `native.selfcheck.pass`, or else counts
`native.selfcheck.fail` with the failed family and keeps the pure
path."""

import random

import pytest

from fabric_token_sdk_tpu.native import bn254py as ref_nb
from fabric_token_sdk_tpu_torch.crypto import hostmath as hm
from fabric_token_sdk_tpu_torch.native import bn254py as nb
from fabric_token_sdk_tpu_torch.utils import metrics as mx

pytestmark = pytest.mark.skipif(not nb.available(),
                                reason="no C compiler: the native library does not build")

rng = random.Random(0xBEEF)


def _rand_pts(n):
    pts = [hm.g1_mul_py(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(n)]
    pts[n // 2] = None  # infinity
    return pts


def test_mul_batch_matches_python_and_reference():
    pts = _rand_pts(8)
    ks = [rng.randrange(hm.R) for _ in range(8)]
    got = nb.g1_mul_batch(pts, ks)
    assert got == [hm.g1_mul_py(p, k) for p, k in zip(pts, ks)]
    if ref_nb.available():
        assert got == ref_nb.g1_mul_batch(pts, ks)


def test_mul_edge_scalars():
    g = hm.G1_GEN
    assert nb.g1_mul(g, 0) is None and nb.g1_mul(g, hm.R) is None
    assert nb.g1_mul(g, 1) == g and nb.g1_mul(g, hm.R - 1) == hm.g1_neg(g)
    assert nb.g1_mul(None, 123) is None
    k = rng.randrange(hm.R)
    assert nb.g1_mul(g, k + hm.R) == hm.g1_mul_py(g, k)  # reduced mod R


def test_multiexp_sum_and_rows_match_python():
    pts = _rand_pts(6)
    ks = [rng.randrange(hm.R) for _ in range(6)]
    assert nb.g1_multiexp(pts, ks) == hm.g1_multiexp_py(pts, ks)
    assert nb.g1_sum(pts) == hm.g1_sum_py(pts)
    assert nb.g1_multiexp([], []) is None
    rows_p = [_rand_pts(3) for _ in range(4)]
    rows_k = [[rng.randrange(hm.R) for _ in range(3)] for _ in range(4)]
    assert nb.g1_multiexp_rows(rows_p, rows_k) == [
        hm.g1_multiexp_py(p, k) for p, k in zip(rows_p, rows_k)]


def test_hostmath_fast_path_installed():
    """The import adopted the native path (its self-check passed), and its
    results equal the pure twin's."""
    assert hm.NATIVE_G1
    k = rng.randrange(hm.R)
    assert hm.g1_mul(hm.G1_GEN, k) == hm.g1_mul_py(hm.G1_GEN, k)
    pts = _rand_pts(4)
    ks = [rng.randrange(hm.R) for _ in range(4)]
    assert hm.g1_multiexp(pts, ks) == hm.g1_multiexp_py(pts, ks)
    assert hm.g1_sum(pts) == hm.g1_sum_py(pts)
    assert hm.g1_mul_batch(pts, ks) == [hm.g1_mul_py(p, k) for p, k in zip(pts, ks)]


def test_g2_ops_match_python():
    ks = [rng.randrange(hm.R) for _ in range(3)]
    pts = [hm.g2_mul_py(hm.G2_GEN, k + 1) for k in ks] + [None]
    ks.append(7)
    assert nb.g2_mul_batch(pts, ks) == [hm.g2_mul_py(p, k) for p, k in zip(pts, ks)]
    assert nb.g2_mul(hm.G2_GEN, 0) is None and nb.g2_mul(hm.G2_GEN, 1) == hm.G2_GEN
    assert nb.g2_mul(hm.G2_GEN, hm.R - 1) == hm.g2_neg(hm.G2_GEN)
    assert nb.g2_multiexp(pts, ks) == hm.g2_multiexp_py(pts, ks)
    assert nb.g2_sum(pts) == hm.g2_sum_py(pts)


def test_pairings_match_python_and_are_bilinear():
    p, q = hm.g1_mul_py(hm.G1_GEN, 3), hm.g2_mul_py(hm.G2_GEN, 5)
    assert nb.pairing(p, q) == hm.pairing_py(p, q)
    a = rng.randrange(1, 1 << 30)
    assert nb.pairing(hm.g1_mul_py(p, a), q) == nb.pairing(p, hm.g2_mul_py(q, a))
    assert nb.pairing_product([(p, q), (hm.g1_neg(p), q)]) == hm.FP12_ONE
    assert nb.pairing_product([(None, q), (p, None)]) == hm.FP12_ONE
    assert hm.gt_is_unity(nb.pairing_product([]))
    assert hm.pairing(None, q) == hm.FP12_ONE
    assert hm.pairing_product([(p, q)]) == hm.pairing_product_py([(p, q)])


def test_cancellation_inside_sum():
    p = hm.g1_mul_py(hm.G1_GEN, 7)
    assert nb.g1_sum([p, hm.g1_neg(p)]) is None
    assert nb.g1_sum([p, p]) == hm.g1_mul_py(hm.G1_GEN, 14)
    assert nb.g1_multiexp([p, p], [5, hm.R - 5]) is None


@pytest.mark.parametrize("family", ["g1_mul", "g2_mul", "pairing", "pairing_product",
                                    "g1_mul_batch", "g1_multiexp_rows"])
def test_install_native_self_check_refuses_a_wrong_family(monkeypatch, family):
    """`_install_native` (ADVICE.md #2): a native function family that
    disagrees with the pure twin keeps the pure path, counted with the
    family; an agreeing build is adopted and counted as a pass."""
    names = ("g1_mul", "g1_multiexp", "g1_sum", "g2_mul", "g2_multiexp", "g2_sum", "pairing",
             "pairing_product", "NATIVE_G1")
    for name in names:  # the import's state, restored by monkeypatch
        monkeypatch.setattr(hm, name, getattr(hm, name))
    for name in names[:-1]:
        monkeypatch.setattr(hm, name, getattr(hm, f"{name}_py"))
    monkeypatch.setattr(hm, "NATIVE_G1", False)
    real = getattr(nb, family)

    def wrong(*a, **kw):
        out = real(*a, **kw)
        if family == "pairing_product" and len(a[0]) < 2:
            return out  # `pairing` is a one-leg product: only the multi-leg one is wrong
        if isinstance(out, list):
            return out[::-1]
        return None if out is not None else hm.G1_GEN

    monkeypatch.setattr(nb, family, wrong)
    fail0 = mx.REGISTRY.counter("native.selfcheck.fail").value
    hm._install_native()
    assert mx.REGISTRY.counter("native.selfcheck.fail").value - fail0 == 1
    assert mx.REGISTRY.snapshot()["meta"]["native.selfcheck.last_failure"] == family
    assert hm.NATIVE_G1 is False and hm.g1_mul is hm.g1_mul_py
    monkeypatch.setattr(nb, family, real)
    pass0 = mx.REGISTRY.counter("native.selfcheck.pass").value
    hm._install_native()
    assert mx.REGISTRY.counter("native.selfcheck.pass").value - pass0 == 1
    assert hm.NATIVE_G1 is True and hm.g1_mul is not hm.g1_mul_py
