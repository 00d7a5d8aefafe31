"""PyTorch port, variable-base G1 rows (`g1_mul_rows`, `g1_sub_rows`,
`g1_add_rows`) against hostmath and the JAX package's g1 tiles, with the
edge cases: scalars 0, 1 and r-1, points at infinity, P+P, P-P, P+(-P),
and coordinates given in the redundant range [p, 2p).

Same inputs go to both packages. The add and sub results must be equal
canonical Jacobian coordinates (the formulas and selects are the
reference's); `g1_mul` takes a 4-bit window ladder where the reference
takes a bit ladder, so its results are the reference's group elements
with another Jacobian Z, compared as affine points."""

import random

import numpy as np
import pytest
import torch

from fabric_token_sdk_tpu.ops import stages as ref_st
from fabric_token_sdk_tpu_torch.crypto import hostmath as hm
from fabric_token_sdk_tpu_torch.ops import curve as cv, limbs as lb, stages as st


def _pts(seed, n):
    rng = random.Random(seed)
    return [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(n)]


def _lift(words: torch.Tensor, rows) -> torch.Tensor:
    """Add p to every coordinate of the given rows: same points, values
    in [p, 2p) as the reference's redundant domain produces."""
    out = words.clone()
    for r in rows:
        for c in range(3):
            out[r, c] = torch.from_numpy(lb.int_to_words(lb.words_to_int(out[r, c].numpy()) + hm.P))
    return out


def _ref(arr):
    return lb.to_reference_limbs(arr)


def test_g1_mul_rows_matches_reference_and_hostmath():
    rng = random.Random(400)
    pts = _pts(401, 5) + [None]
    ks = [0, 1, hm.R - 1, rng.randrange(hm.R), rng.randrange(hm.R), 77]
    p = _lift(torch.from_numpy(cv.encode_points(pts)), [3, 5])
    k = torch.from_numpy(cv.encode_scalars(ks))
    got = st.g1_mul_rows(p, k)
    assert cv.decode_points(got) == [hm.g1_mul(q, s) if q else None for q, s in zip(pts, ks)]
    ref_out = ref_st.g1_mul_rows(_ref(p), _ref(k))
    assert cv.decode_points(got) == cv.decode_points(lb.from_reference_limbs(ref_out, hm.P))


@pytest.mark.parametrize("case", ["random", "edges"])
def test_g1_mul_window_plain_matches_reference_as_points(case):
    """The windowed plain version against the JAX package's bit ladder
    as group elements (affine, infinity included), on inputs drawn with
    numpy from a seed: random points and scalars, or the window edges
    (scalars 0, 1, r-1, every digit 15 below a zero top digit, a single
    top digit; points at infinity; coordinates in [p, 2p))."""
    rng = np.random.default_rng(410 if case == "random" else 411)
    draw = [int.from_bytes(rng.bytes(32), "little") % hm.R for _ in range(12)]
    pts = [hm.g1_mul(hm.G1_GEN, d or 1) for d in draw[:6]]
    ks = draw[6:]
    if case == "edges":
        pts[4] = None
        ks = [0, 1, hm.R - 1, 16 ** 63 - 1, 15 << 248, ks[5]]
    p = torch.from_numpy(cv.encode_points(pts))
    if case == "edges":
        p = _lift(p, [1, 3])
    k = torch.from_numpy(cv.encode_scalars(ks))
    got = cv.decode_points(st.g1_mul_plain(p, k))
    assert got == [hm.g1_mul(q, s) if q else None for q, s in zip(pts, ks)]
    ref_out = lb.from_reference_limbs(ref_st.g1_mul_rows(_ref(p), _ref(k)), hm.P)
    assert got == cv.decode_points(ref_out)


@pytest.mark.parametrize("op", ["sub", "add"])
def test_g1_addsub_rows_match_reference_and_hostmath(op):
    p0, p1, p2 = _pts(402, 3)
    A = [p0, p0, p0, None, None, p1, p2]
    B = [p0, hm.g1_neg(p0), p1, p2, None, None, p0]
    a = _lift(torch.from_numpy(cv.encode_points(A)), [1, 6])
    b = _lift(torch.from_numpy(cv.encode_points(B)), [0, 3])
    got = (st.g1_sub_rows if op == "sub" else st.g1_add_rows)(a, b)
    neg = op == "sub"
    assert cv.decode_points(got) == [
        hm.g1_add(x, hm.g1_neg(y) if (neg and y) else y) for x, y in zip(A, B)
    ]
    ref_fn = ref_st.g1_sub_rows if op == "sub" else ref_st.g1_add_rows
    assert torch.equal(got, lb.from_reference_limbs(ref_fn(_ref(a), _ref(b)), hm.P))


def test_affine_to_jac_np_and_row_checks():
    pts = _pts(403, 2)
    jac = torch.from_numpy(cv.encode_points(pts)).numpy()
    assert np.array_equal(st.affine_to_jac_np(jac[:, :2]), jac)
    with pytest.raises(ValueError):
        st.g1_sub_rows(torch.zeros((0, 3, 8), dtype=torch.int32), torch.zeros((0, 3, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        st.g1_mul_rows(torch.zeros((1, 3, 8), dtype=torch.int32), torch.zeros((1, 8), dtype=torch.int32, device="meta"))
