"""PyTorch port, the prove plane with range proofs: 2-in/2-out transfers
through `TransferProver.batch` on the CPU (device="cpu": the plain torch
versions of the kernels), the JAX bench's shape and values
([100, 55] -> [120, 35], `setup(base=16, exponent=2)`).

Every proof must be accepted by the port's host `TransferVerifier`, the
JAX package's, and the port's `BatchedTransferVerifier`, and a tampered
membership response rejected by all three. The stages the prove calls
are counted: one call a stage, as the launches on the card. The JAX
package's batched prover compiles its pairing programs for minutes on
the CPU, so byte identity against it is marked slow."""

import random

import pytest
import torch

from fabric_token_sdk_tpu.crypto import batch_prove as ref_bp, setup as ref_setup
from fabric_token_sdk_tpu.crypto import token as ref_tok, transfer as ref_tr
from fabric_token_sdk_tpu_torch.crypto import batch, hostmath as hm, setup, token as tok
from fabric_token_sdk_tpu_torch.crypto import transfer as tr
from fabric_token_sdk_tpu_torch.crypto.rangeproof import RangeProof
from fabric_token_sdk_tpu_torch.ops import stages as st

# The plain versions are many small tensor ops: one intra-op thread runs
# them faster than several and leaves the other test workers their cores.
torch.set_num_threads(1)

SEED = 0x2E2E
STAGES = ("g1_msm_rows", "g1_msm_select_rows", "g1_mul_rows", "g1_add_rows", "g1_sub_rows",
          "g1_to_affine_rows", "g2_mul_rows", "g2_add_rows", "g2_to_affine_rows",
          "miller_rows", "gt_product_rows", "final_exp_rows")


def make_reqs(tok_mod, pp, seed, count):
    rng = random.Random(seed)
    out = []
    for _ in range(count):
        ins, inw = tok_mod.tokens_with_witness([100, 55], "USD", pp.ped_params, rng)
        outs, outw = tok_mod.tokens_with_witness([120, 35], "USD", pp.ped_params, rng)
        out.append((inw, outw, ins, outs))
    return out


@pytest.fixture(scope="module")
def proved():
    """Two 2-in/2-out transfers proved by the batched prover, with the
    calls of each stage (and the K of each GT product) recorded."""
    pp = setup.setup(base=16, exponent=2, rng=random.Random(SEED))
    reqs = make_reqs(tok, pp, SEED + 1, 2)
    calls = {name: [] for name in STAGES}
    with pytest.MonkeyPatch.context() as mp:
        for name in STAGES:
            fn = getattr(st, name)

            def counting(*a, _fn=fn, _name=name):
                calls[_name].append(tuple(a[-1].shape))
                return _fn(*a)

            mp.setattr(st, name, counting)
        proofs = tr.TransferProver.batch(reqs, pp, rng=random.Random(SEED + 2), min_batch=1,
                                         device="cpu")
    return pp, reqs, proofs, calls


def test_2in2out_stage_calls_match_the_launch_plan(proved):
    """One call a stage over all rows: 4 select multiexps (WF ped3, ped2,
    equality ped3, P), the signature ladder, the obfuscating add, the G2
    ladder, add and to-affine, and the K = 2 pairing product; never the
    gather multiexp, the subtraction or the G1 to-affine."""
    _, _, _, calls = proved
    B, n_out, exponent = 2, 2, 2
    M = B * n_out * exponent
    assert {k: len(v) for k, v in calls.items() if v} == {
        "g1_msm_select_rows": 4, "g1_mul_rows": 1, "g1_add_rows": 1, "g2_mul_rows": 1,
        "g2_add_rows": 1, "g2_to_affine_rows": 1, "miller_rows": 1, "gt_product_rows": 1,
        "final_exp_rows": 1,
    }
    assert sorted(c[0] for c in calls["g1_msm_select_rows"]) == sorted(
        [B * 6, 2 * M + B * n_out, B * n_out, 2 * M])
    assert calls["gt_product_rows"] == [(M, 2, 6, 2, 8)]  # K = 2
    assert calls["miller_rows"] == [(2 * M, 2, 2, 8)]
    assert calls["g1_mul_rows"] == [(2 * M, 8)]
    assert calls["g1_add_rows"] == [(M, 3, 8)]


def test_2in2out_proofs_accepted_tamper_rejected(proved):
    pp, reqs, proofs, _ = proved
    ref_pp = ref_setup.PublicParams.deserialize(pp.serialize())
    for (_, _, ins, outs), raw in zip(reqs, proofs):
        tr.TransferVerifier(ins, outs, pp).verify(raw)
        ref_tr.TransferVerifier(ins, outs, ref_pp).verify(raw)
    p = tr.TransferProof.from_bytes(proofs[1])
    rpf = RangeProof.from_bytes(p.range_correctness)
    m = rpf.membership_proofs[0][0]
    m.value_resp = (m.value_resp + 1) % hm.R
    bad = tr.TransferProof(p.wf, rpf.to_bytes()).to_bytes()
    ins, outs = reqs[1][2], reqs[1][3]
    with pytest.raises(ValueError):
        tr.TransferVerifier(ins, outs, pp).verify(bad)
    with pytest.raises(ValueError):
        ref_tr.TransferVerifier(ins, outs, ref_pp).verify(bad)
    got = batch.BatchedTransferVerifier(pp, device="cpu").verify(
        [(ins, outs, bad)] + [(r[2], r[3], raw) for r, raw in zip(reqs, proofs)])
    assert got.tolist() == [False, True, True]


@pytest.mark.slow
def test_2in2out_batched_proofs_byte_identical_to_reference(proved):
    pp, reqs, proofs, _ = proved
    ref_pp = ref_setup.setup(base=16, exponent=2, rng=random.Random(SEED))
    assert ref_pp.serialize() == pp.serialize()
    ref_reqs = make_reqs(ref_tok, ref_pp, SEED + 1, 2)
    assert [r[2:] for r in ref_reqs] == [r[2:] for r in reqs]
    want = ref_bp.BatchedTransferProver(ref_pp).prove(ref_reqs, random.Random(SEED + 2))
    assert proofs == want
