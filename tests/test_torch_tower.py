"""PyTorch port, the extension tower: every plain torch op of
`ops/tower.py` against the JAX package's `ops/tower.py` functions and
hostmath, on the same inputs.

Inputs are random Fp2/Fp12 values from a seeded `random.Random` plus the
edges 0, 1 and p-1, with some coefficients given in the redundant range
[p, 2p). Results are compared as canonical integers (the reference's
values may lie anywhere in [0, 2p)); every op returns a unique field
element, so equality is exact."""

import random

import numpy as np
import pytest
import torch

from fabric_token_sdk_tpu.ops import tower as ref_tw
from fabric_token_sdk_tpu_torch.crypto import hostmath as hm
from fabric_token_sdk_tpu_torch.ops import field as fd, limbs as lb, tower as tw
from fabric_token_sdk_tpu_torch.ops.field import FP

# The plain versions are many small tensor ops: one intra-op thread runs
# them faster than several and leaves the other test workers their cores.
torch.set_num_threads(1)

P = hm.P


def _lift(words: np.ndarray, every: int) -> np.ndarray:
    """Add p to every `every`-th coefficient: the same values, given in
    [p, 2p) as the reference's redundant domain produces them."""
    flat = words.reshape(-1, lb.NWORDS).copy()
    for i in range(0, flat.shape[0], every):
        flat[i] = lb.int_to_words(lb.words_to_int(flat[i]) + P)
    return flat.reshape(words.shape)


def _fp2_vals(seed, n):
    rng = random.Random(seed)
    edges = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1), (1, P - 1)]
    return edges + [(rng.randrange(P), rng.randrange(P)) for _ in range(n)]


def _fp12_vals(seed, n):
    rng = random.Random(seed)
    edges = [hm.FP12_ZERO, hm.FP12_ONE, tuple((P - 1, P - 1) for _ in range(6))]
    return edges + [tuple((rng.randrange(P), rng.randrange(P)) for _ in range(6)) for _ in range(n)]


def _words(vals, fp12: bool) -> np.ndarray:
    return _lift(tw.encode_fp12(vals) if fp12 else tw.encode_fp2(vals), every=3)


def _half(words: np.ndarray) -> torch.Tensor:
    return fd.words_to_half(torch.from_numpy(words))


def _canon(h: torch.Tensor) -> torch.Tensor:
    return fd.half_to_words(FP.canon(h))


def _ref(words) -> np.ndarray:
    return lb.to_reference_limbs(words)


def _from_ref(limbs) -> torch.Tensor:
    return lb.from_reference_limbs(np.asarray(limbs), P)


# ---------------------------------------------------------------- Fp2

FP2_BINARY = {
    "add": (tw.fp2_add, ref_tw.fp2_add, hm.fp2_add),
    "sub": (tw.fp2_sub, ref_tw.fp2_sub, hm.fp2_sub),
    "mul": (tw.fp2_mul, ref_tw.fp2_mul, hm.fp2_mul),
}
FP2_UNARY = {
    "neg": (tw.fp2_neg, ref_tw.fp2_neg, hm.fp2_neg),
    "conj": (tw.fp2_conj, ref_tw.fp2_conj, hm.fp2_conj),
    "sqr": (tw.fp2_sqr, ref_tw.fp2_sqr, hm.fp2_sqr),
    "mul_xi": (tw.fp2_mul_xi, ref_tw.fp2_mul_xi, lambda x: hm.fp2_mul(x, hm.XI)),
    "inv": (tw.fp2_inv, ref_tw.fp2_inv, lambda x: hm.fp2_inv(x) if x != (0, 0) else (0, 0)),
}


@pytest.mark.parametrize("op", sorted(FP2_BINARY))
def test_fp2_binary(op):
    port, ref, host = FP2_BINARY[op]
    xs = _fp2_vals(1, 6)
    ys = xs[::-1]
    X, Y = _words(xs, False), _words(ys, False)
    got = _canon(port(_half(X), _half(Y)))
    assert torch.equal(got, _from_ref(ref(_ref(X), _ref(Y))))
    assert tw.decode_fp2(got) == [host(x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("op", sorted(FP2_UNARY))
def test_fp2_unary(op):
    port, ref, host = FP2_UNARY[op]
    xs = _fp2_vals(2, 6)
    X = _words(xs, False)
    got = _canon(port(_half(X)))
    assert torch.equal(got, _from_ref(ref(_ref(X))))
    assert tw.decode_fp2(got) == [host(x) for x in xs]


def test_fp2_scale_is_zero_eq():
    xs = _fp2_vals(3, 4)
    ks = [0, 1, P - 1] + [random.Random(4).randrange(P) for _ in range(len(xs) - 3)]
    X = _words(xs, False)
    K = _lift(tw.encode_fp2([(k, 0) for k in ks])[:, 0], every=2)
    got = _canon(tw.fp2_scale(_half(X), _half(K)))
    assert torch.equal(got, _from_ref(ref_tw.fp2_scale(_ref(X), _ref(K))))
    assert tw.decode_fp2(got) == [hm.fp2_scale(x, k) for x, k in zip(xs, ks)]
    # is_zero / eq in the redundant domain: v and v + p are equal
    zero = _half(_lift(tw.encode_fp2([(0, 0), (0, 0), (1, 0)]), every=2))
    assert tw.fp2_is_zero(zero).tolist() == [True, True, False]
    assert np.asarray(ref_tw.fp2_is_zero(_ref(fd.half_to_words(zero)))).tolist() == [True, True, False]
    plain = _half(tw.encode_fp2(xs))
    assert tw.fp2_eq(plain, _half(X)).all()
    assert not tw.fp2_eq(plain, _half(_words(xs[::-1], False))).all()


# ---------------------------------------------------------------- Fp6

def _fp6_split(vals):
    """Fp12 values -> their Fp6 halves c0 (even w powers) as host tuples."""
    return [(v[0], v[2], v[4]) for v in vals]


@pytest.mark.parametrize("op", ["mul", "mul_v", "inv"])
def test_fp6_ops(op):
    vals = _fp12_vals(5, 3)
    X12 = _words(vals, True)
    Y12 = _words(vals[::-1], True)
    x6 = X12[:, 0::2]  # (N, 3, 2, 8): the c0 halves
    y6 = Y12[:, 0::2]
    hx, hy = _fp6_split(vals), _fp6_split(vals[::-1])
    if op == "mul":
        got = _canon(tw._fp6_mul(_half(x6), _half(y6)))
        want_ref = ref_tw._fp6_mul(_ref(x6), _ref(y6))
        want_host = [hm._fp6_mul(a, b) for a, b in zip(hx, hy)]
    elif op == "mul_v":
        got = _canon(tw._fp6_mul_v(_half(x6)))
        want_ref = ref_tw._fp6_mul_v(_ref(x6))
        want_host = [hm._fp6_mul_v(a) for a in hx]
    else:
        got = _canon(tw._fp6_inv(_half(x6)))
        want_ref = ref_tw._fp6_inv(_ref(x6))
        zero6 = (hm.FP2_ZERO,) * 3
        want_host = [hm._fp6_inv(a) if a != zero6 else zero6 for a in hx]
    assert torch.equal(got, _from_ref(want_ref))
    pairs = tw.decode_fp2(got)
    assert [tuple(pairs[3 * i : 3 * i + 3]) for i in range(len(hx))] == want_host


# ---------------------------------------------------------------- Fp12

FP12_OPS = {
    "mul": (lambda x, y: tw.fp12_mul(x, y), lambda x, y: ref_tw.fp12_mul(x, y), hm.fp12_mul),
    "sqr": (lambda x, y: tw.fp12_sqr(x), lambda x, y: ref_tw.fp12_sqr(x), lambda x, y: hm.fp12_sqr(x)),
    "conj": (lambda x, y: tw.fp12_conj(x), lambda x, y: ref_tw.fp12_conj(x),
             lambda x, y: hm.fp12_conj(x)),
    "inv": (lambda x, y: tw.fp12_inv(x), lambda x, y: ref_tw.fp12_inv(x),
            lambda x, y: hm.fp12_inv(x) if x != hm.FP12_ZERO else x),
    "frobenius1": (lambda x, y: tw.fp12_frobenius(x, 1), lambda x, y: ref_tw.fp12_frobenius(x, 1),
                   lambda x, y: hm.fp12_frobenius(x, 1)),
    "frobenius2": (lambda x, y: tw.fp12_frobenius(x, 2), lambda x, y: ref_tw.fp12_frobenius(x, 2),
                   lambda x, y: hm.fp12_frobenius(x, 2)),
    "frobenius3": (lambda x, y: tw.fp12_frobenius(x, 3), lambda x, y: ref_tw.fp12_frobenius(x, 3),
                   lambda x, y: hm.fp12_frobenius(x, 3)),
}


@pytest.mark.parametrize("op", sorted(FP12_OPS))
def test_fp12_ops(op):
    port, ref, host = FP12_OPS[op]
    xs = _fp12_vals(6, 3)
    ys = xs[::-1]
    X, Y = _words(xs, True), _words(ys, True)
    got = _canon(port(_half(X), _half(Y)))
    assert torch.equal(got, _from_ref(ref(_ref(X), _ref(Y))))
    assert tw.decode_fp12(got) == [host(x, y) for x, y in zip(xs, ys)]


def test_fp12_mul_sparse013():
    xs = _fp12_vals(8, 3)
    ls = _fp2_vals(9, 3 * len(xs) - 5)
    X = _words(xs, True)
    L = _words(ls, False).reshape(3, len(xs), 2, lb.NWORDS)
    hl = [ls[j * len(xs) : (j + 1) * len(xs)] for j in range(3)]
    got = _canon(tw.fp12_mul_sparse013(_half(X), *(_half(L[j]) for j in range(3))))
    want = ref_tw.fp12_mul_sparse013(_ref(X), *(_ref(L[j]) for j in range(3)))
    assert torch.equal(got, _from_ref(want))
    z = hm.FP2_ZERO
    assert tw.decode_fp12(got) == [
        hm.fp12_mul(x, (hl[0][i], hl[1][i], z, hl[2][i], z, z)) for i, x in enumerate(xs)
    ]


def test_fp12_eq_one_and_host_io():
    xs = _fp12_vals(10, 2)
    X = _words(xs, True)
    plain = _half(tw.encode_fp12(xs))
    assert tw.fp12_eq(_half(X), plain).all()
    assert tw.fp12_eq(_half(X), _half(tw.encode_fp12(xs[::-1]))).tolist() == [
        a == b for a, b in zip(xs, xs[::-1])
    ]
    one = tw.fp12_one_np()
    assert np.array_equal(lb.to_reference_limbs(one), ref_tw.fp12_one_np())
    assert tw.decode_fp12(one[None]) == [hm.FP12_ONE]
    assert tw.decode_fp12(tw.encode_fp12(xs)) == xs
    assert tw.decode_fp12(X) == xs  # decoding reduces [p, 2p) values
    assert tw.fp12_eq(tw.fp12_one_half(plain), _half(np.broadcast_to(one, X.shape).copy())).all()
