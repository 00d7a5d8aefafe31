"""PyTorch port, the range-proof path: a 1-in/2-out block through
`BatchedTransferVerifier` with the planted faults of a range proof, and
`BatchedMembershipVerifier` on its own, against the host verifiers of
both packages. Runs on the CPU (device="cpu": the plain torch versions
of the kernels)."""

import random

import pytest
import torch

from fabric_token_sdk_tpu.crypto import setup as ref_setup, sigproof as ref_sigproof
from fabric_token_sdk_tpu.crypto import transfer as ref_tr
from fabric_token_sdk_tpu_torch.crypto import batch, hostmath as hm, pssign, schnorr, setup, sigproof
from fabric_token_sdk_tpu_torch.crypto import transfer as tr
from fabric_token_sdk_tpu_torch.crypto.rangeproof import RangeProof
from torch_transfer_cases import PLANTS, host_verdicts, plant_range_rows, prove_txs

# The plain versions are many small tensor ops: one intra-op thread runs
# them faster than several and leaves the other test workers their cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pp():
    return setup.setup(base=16, exponent=2, rng=random.Random(0xA4A6))


def test_one_in_two_out_block_matches_both_hosts(pp):
    txs, bad = plant_range_rows(prove_txs(pp, 6, random.Random(81), shape=(1, 2)), start=0)
    got = batch.BatchedTransferVerifier(pp, device="cpu").verify(txs)
    assert got.tolist() == [i not in bad for i in range(len(txs))]
    assert got.tolist() == host_verdicts(txs, tr.TransferVerifier, pp)
    ref_pp = ref_setup.PublicParams.deserialize(pp.serialize())
    assert got.tolist() == host_verdicts(txs, ref_tr.TransferVerifier, ref_pp)
    assert len(bad) == len(PLANTS)


def test_membership_verifier_matches_host(pp):
    """The membership proofs of one 2-in/1-out range proof, one with a
    bumped hash response, one paired with another digit's commitment."""
    (ins, outs, raw), = prove_txs(pp, 1, random.Random(82), shape=(2, 1))
    rpf = RangeProof.from_bytes(tr.TransferProof.from_bytes(raw).range_correctness)
    proofs = [m for row in rpf.membership_proofs for m in row]
    coms = [c for row in rpf.digit_commitments for c in row]
    bumped = sigproof.MembershipProof.from_bytes(proofs[0].to_bytes())
    bumped.hash_resp = (bumped.hash_resp + 1) % hm.R
    proofs = proofs + [bumped, proofs[1]]
    coms = coms + [coms[0], coms[0]]
    got = batch.BatchedMembershipVerifier(pp, device="cpu").verify(proofs, coms)
    assert got.tolist() == [True, True, False, False]
    rp = pp.range_params
    for mod in (sigproof, ref_sigproof):
        host = []
        for p, com in zip(proofs, coms):
            try:
                mod.MembershipVerifier(com, pp.ped_gen, rp.Q, rp.sign_pk, pp.ped_params[:2]).verify(
                    mod.MembershipProof.from_bytes(p.to_bytes()))
                host.append(True)
            except Exception:
                host.append(False)
        assert host == got.tolist()
    assert batch.BatchedMembershipVerifier(pp, device="cpu").verify([], []).shape == (0,)


def test_identity_signature_membership_verdicts_match_reference(pp):
    """A membership proof for the digit 17 (outside the signed set 0..15)
    with an identity PS signature (R = S = None) and a zero signature
    blinding: the host verifiers of both packages accept it, and so does
    the batched verifier, whose legs at infinity enter the Miller loop
    as (0, 0) and come out of the final exponentiation as GT one. The
    port keeps the reference's verdict; ROADMAP.md section C records the
    fault."""
    rng = random.Random(83)
    rp = pp.range_params
    value, bf = 17, hm.rand_zr(rng)
    com = hm.g1_multiexp(pp.ped_params[:2], [value, bf])
    mv = sigproof.MembershipVerifier(com, pp.ped_gen, rp.Q, rp.sign_pk, pp.ped_params[:2])
    sig = pssign.Signature(None, None)
    rho_v, rho_cb, rho_h, rho_bf = (hm.rand_zr(rng) for _ in range(4))
    com_gt = hm.pairing_product([(hm.g1_mul(pp.ped_gen, rho_bf), rp.Q)])
    chal = mv._challenge(com_gt, hm.g1_multiexp(pp.ped_params[:2], [rho_v, rho_cb]), sig)
    z = schnorr.respond([value, bf, 0, 0], [rho_v, rho_cb, rho_h, rho_bf], chal)
    proof = sigproof.MembershipProof(chal, sig, z[0], z[1], z[3], z[2], com)
    ref_pp = ref_setup.PublicParams.deserialize(pp.serialize())
    ref_rp = ref_pp.range_params
    ref_mv = ref_sigproof.MembershipVerifier(com, ref_pp.ped_gen, ref_rp.Q, ref_rp.sign_pk,
                                             ref_pp.ped_params[:2])
    mv.verify(proof)  # raises if rejected
    ref_mv.verify(ref_sigproof.MembershipProof.from_bytes(proof.to_bytes()))
    assert batch.BatchedMembershipVerifier(pp, device="cpu").verify([proof], [com]).tolist() == [True]
