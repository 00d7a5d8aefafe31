"""PyTorch port, the pairing: the plain Miller loop against the JAX
package's `pairing.miller_loop` (equal Miller values, a (0, 0) leg
included), the plain GT product and final exponentiation against the
JAX package's hostmath (their outputs are unique field elements, so
equality with the host twin is a full check), bilinearity and the infinity mask through
`pairing_product_staged`.

The JAX package's own `final_exp` and `pairing_product_staged` take
minutes to compile on the CPU; the tests that call them are marked
slow, as the reference's pairing tests are."""

import random

import numpy as np
import pytest
import torch

from fabric_token_sdk_tpu.crypto import hostmath as ref_hm
from fabric_token_sdk_tpu.ops import pairing as ref_pr
from fabric_token_sdk_tpu_torch.crypto import hostmath as hm
from fabric_token_sdk_tpu_torch.ops import limbs as lb, pairing as pr, stages as st, tower as tw

# The plain versions are many small tensor ops: one intra-op thread runs
# them faster than several and leaves the other test workers their cores.
torch.set_num_threads(1)


def _ref(arr):
    return lb.to_reference_limbs(arr)


def _from_ref(limbs):
    return lb.from_reference_limbs(np.asarray(limbs), hm.P)


def _legs(seed):
    rng = random.Random(seed)
    a, b = rng.randrange(1, hm.R), rng.randrange(1, hm.R)
    return [hm.g1_mul(hm.G1_GEN, a), None], [hm.g2_mul(hm.G2_GEN, b), hm.g2_mul(hm.G2_GEN, a)]


def test_miller_matches_reference_with_a_zero_leg():
    Ps, Qs = _legs(600)  # the second leg's P is infinity: the affine (0, 0)
    P = torch.from_numpy(pr.encode_g1(Ps))
    Q = torch.from_numpy(pr.encode_g2(Qs))
    got = st.miller_rows(P, Q)
    want = ref_pr.miller_loop(_ref(P), _ref(Q))
    assert torch.equal(got, _from_ref(want))
    # the (0, 0) leg is not masked away, but its lines lie in Fp4
    # (l0 = l1 = 0), which the final exponentiation sends to GT one
    assert tw.decode_fp12(got)[1] != hm.FP12_ONE
    assert pr.gt_is_one_host(st.final_exp_rows(got[1:])).tolist() == [True]


def test_product_and_final_exp_match_hostmath():
    rng = random.Random(601)
    Ps = [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(4)]
    Qs = [hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(4)]
    f = st.miller_rows(torch.from_numpy(pr.encode_g1(Ps)), torch.from_numpy(pr.encode_g2(Qs)))
    g = st.gt_product_rows(f.reshape(2, 2, 6, 2, lb.NWORDS))
    vals = tw.decode_fp12(f)
    assert tw.decode_fp12(g) == [hm.fp12_mul(vals[0], vals[1]), hm.fp12_mul(vals[2], vals[3])]
    e = st.final_exp_rows(g)
    assert tw.decode_fp12(e) == [ref_hm.final_exp(v) for v in tw.decode_fp12(g)]
    assert tw.decode_fp12(e) == [
        ref_hm.pairing_product([(Ps[0], Qs[0]), (Ps[1], Qs[1])]),
        ref_hm.pairing_product([(Ps[2], Qs[2]), (Ps[3], Qs[3])]),
    ]


def test_bilinearity_and_mask_through_the_staged_product():
    """Row 0: e(aP, Q) e(-P, aQ) = 1. Row 1: e(P, bQ) with a masked
    second leg, which becomes GT one before the product."""
    rng = random.Random(602)
    a, b = rng.randrange(2, hm.R), rng.randrange(2, hm.R)
    P, Q = hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)), hm.G2_GEN
    Ps = [[hm.g1_mul(P, a), hm.g1_neg(P)], [P, hm.G1_GEN]]
    Qs = [[Q, hm.g2_mul(Q, a)], [hm.g2_mul(Q, b), Q]]
    Pw = torch.from_numpy(np.stack([pr.encode_g1(r) for r in Ps]))
    Qw = torch.from_numpy(np.stack([pr.encode_g2(r) for r in Qs]))
    gt = pr.pairing_product_staged(Pw, Qw, inf_mask=[[False, False], [False, True]])
    assert pr.gt_is_one_host(gt).tolist() == [True, False]
    assert pr.decode_gt(gt)[1] == hm.pairing(P, hm.g2_mul(Q, b))
    assert pr.pairing_product_staged(Pw[:0], Qw[:0]).shape == (0, 6, 2, lb.NWORDS)


def test_constants_match_reference():
    assert np.array_equal(pr._ATE_BITS, ref_pr._ATE_BITS)
    assert np.array_equal(pr._U_BITS, ref_pr._U_BITS)
    assert np.array_equal(pr._HP_BITS, ref_pr._HP_BITS)
    assert np.array_equal(pr._HP_SIGN, ref_pr._HP_SIGN)
    assert np.array_equal(lb.to_reference_limbs(pr._twist_frob_consts()), ref_pr._twist_frob_consts())
    pts = [hm.G1_GEN, None]
    assert np.array_equal(lb.to_reference_limbs(pr.encode_g1(pts)), ref_pr.encode_g1(pts))
    assert np.array_equal(lb.to_reference_limbs(pr.encode_g2([hm.G2_GEN])), ref_pr.encode_g2([hm.G2_GEN]))


@pytest.mark.slow
def test_final_exp_matches_reference():
    Ps, Qs = _legs(603)
    f = st.miller_rows(torch.from_numpy(pr.encode_g1(Ps)), torch.from_numpy(pr.encode_g2(Qs)))
    assert torch.equal(st.final_exp_rows(f), _from_ref(ref_pr.final_exp(_ref(f))))


@pytest.mark.slow
def test_pairing_product_staged_matches_reference():
    rng = random.Random(604)
    Ps = [[hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(2)] for _ in range(2)]
    Qs = [[hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(2)] for _ in range(2)]
    Pw = np.stack([pr.encode_g1(r) for r in Ps])
    Qw = np.stack([pr.encode_g2(r) for r in Qs])
    mask = [[False, True], [False, False]]
    got = pr.pairing_product_staged(torch.from_numpy(Pw), torch.from_numpy(Qw), inf_mask=mask)
    want = ref_pr.pairing_product_staged(_ref(Pw), _ref(Qw), inf_mask=np.array(mask))
    assert torch.equal(got, _from_ref(want))
