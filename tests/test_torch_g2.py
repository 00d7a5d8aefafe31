"""PyTorch port, G2 rows and G1 to-affine (`g2_mul_rows`, `g2_add_rows`,
`g2_to_affine_rows`, `g2_tree_sum_rows`, `g1_to_affine_rows`) against
the JAX package's stage functions of the same names and hostmath, with
the edge cases of the G1 tests: scalars 0, 1 and r-1, points at
infinity, P+P, P-P, P+(-P), and coordinates in the redundant range
[p, 2p).

Same inputs go to both packages; results must be equal canonical
coordinates (the formulas and selects are the reference's)."""

import random

import numpy as np
import pytest
import torch

from fabric_token_sdk_tpu.ops import stages as ref_st
from fabric_token_sdk_tpu_torch.crypto import hostmath as hm
from fabric_token_sdk_tpu_torch.ops import curve as cv, curve2 as cv2, limbs as lb
from fabric_token_sdk_tpu_torch.ops import pairing as pr, stages as st

# The plain versions are many small tensor ops: one intra-op thread runs
# them faster than several and leaves the other test workers their cores.
torch.set_num_threads(1)


def _g2pts(seed, n):
    rng = random.Random(seed)
    return [hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(n)]


def _lift(words: torch.Tensor, rows) -> torch.Tensor:
    """Add p to every coordinate word-group of the given rows: the same
    points, values in [p, 2p)."""
    out = words.clone()
    flat = out.view(out.shape[0], -1, lb.NWORDS)
    for r in rows:
        for c in range(flat.shape[1]):
            flat[r, c] = torch.from_numpy(lb.int_to_words(lb.words_to_int(flat[r, c].numpy()) + hm.P))
    return out


def _ref(arr):
    return lb.to_reference_limbs(arr)


def _from_ref(limbs):
    return lb.from_reference_limbs(np.asarray(limbs), hm.P)


def test_g2_mul_rows_matches_reference_and_hostmath():
    rng = random.Random(500)
    pts = _g2pts(501, 3) + [None]
    ks = [0, 1, hm.R - 1, rng.randrange(hm.R)]
    p = _lift(torch.from_numpy(cv2.encode_points(pts)), [2])
    k = torch.from_numpy(cv.encode_scalars(ks))
    got = st.g2_mul_rows(p, k)
    assert cv2.decode_points(got) == [hm.g2_mul(q, s) if q else None for q, s in zip(pts, ks)]
    assert torch.equal(got, _from_ref(ref_st.g2_mul_rows(_ref(p), _ref(k))))


def test_g2_add_and_to_affine_rows_match_reference_and_hostmath():
    q0, q1, q2 = _g2pts(502, 3)
    A = [q0, q0, q0, None, None, q1, q2]
    B = [q0, hm.g2_neg(q0), q1, q2, None, None, q0]
    a = _lift(torch.from_numpy(cv2.encode_points(A)), [1, 6])
    b = _lift(torch.from_numpy(cv2.encode_points(B)), [0, 3])
    got = st.g2_add_rows(a, b)
    want = [hm.g2_add(x, y) for x, y in zip(A, B)]
    assert cv2.decode_points(got) == want
    assert torch.equal(got, _from_ref(ref_st.g2_add_rows(_ref(a), _ref(b))))
    lifted = _lift(got, [0, 2])
    aff = st.g2_to_affine_rows(lifted)
    assert torch.equal(aff, torch.from_numpy(pr.encode_g2(want)))  # infinity -> (0, 0)
    assert torch.equal(aff, _from_ref(ref_st.g2_to_affine_rows(_ref(lifted))))


def test_g2_tree_sum_rows_matches_reference_and_hostmath():
    q = _g2pts(503, 5)
    rows = [[q[0], q[1], q[2]], [q[3], None, hm.g2_neg(q[3])], [q[4], q[4], q[0]]]
    terms = torch.from_numpy(np.stack([cv2.encode_points(r) for r in rows]))  # (3, 3, 3, 2, 8)
    got = st.g2_tree_sum_rows(terms)
    assert cv2.decode_points(got) == [hm.g2_sum(r) for r in rows]
    assert torch.equal(got, _from_ref(ref_st.g2_tree_sum_rows(_ref(terms))))


def test_g1_to_affine_rows_matches_reference_and_hostmath():
    rng = random.Random(504)
    pts = [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(4)] + [None]
    jac = cv.encode_points(pts)
    # a non-trivial Z: 2P as a Jacobian doubling, and lifted coordinates
    p = _lift(st.g1_add_rows(torch.from_numpy(jac), torch.from_numpy(jac)), [1, 4])
    got = st.g1_to_affine_rows(p)
    assert torch.equal(got, torch.from_numpy(pr.encode_g1([hm.g1_add(x, x) for x in pts])))
    assert torch.equal(got, _from_ref(ref_st.g1_to_affine_rows(_ref(p))))


def test_row_checks():
    z = torch.zeros((0, 3, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        st.g2_add_rows(z, z)
    with pytest.raises(ValueError):
        st.g2_mul_rows(torch.zeros((1, 3, 2, 8), dtype=torch.int32),
                       torch.zeros((1, 8), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        st.miller_rows(torch.zeros((0, 2, 8), dtype=torch.int32), torch.zeros((0, 2, 2, 8), dtype=torch.int32))
