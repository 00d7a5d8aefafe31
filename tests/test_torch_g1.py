"""PyTorch port, variable-base G1 rows (`g1_mul_rows`, `g1_sub_rows`,
`g1_add_rows`) against hostmath and the JAX package's g1 tiles, with the
edge cases: scalars 0, 1 and r-1, points at infinity, P+P, P-P, P+(-P),
and coordinates given in the redundant range [p, 2p).

Same inputs go to both packages; results must be equal canonical
Jacobian coordinates (the formulas and selects are the reference's)."""

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
    assert torch.equal(got, lb.from_reference_limbs(ref_out, hm.P))


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
