"""PyTorch port, the mesh binding on the range-proof path: a 2-in/2-out
block (the JAX bench's shape) with the planted range faults of
`torch_transfer_cases`, through `BatchedTransferVerifier` unbound and
bound to the logical (2, 1) and (2, 2) meshes of CPU devices. The bound
verdicts, and those of its membership part (`BatchedMembershipVerifier`,
the pairing plane), equal the unbound ones bit for bit and the host
verifiers of both packages; every stage call of the verify runs over the
mesh's 2 row groups and the pairing product through the staged branch
of `sharded_pairing_product`.

The unbound run also pins the span names (ROADMAP C1): the membership
check's leaves are `batch.membership.*`, the range leaves count only
the equality proofs, and the leaves add up to `batch.transfer.verify`.
Each stage call is a whole plain call a row group here, so a bound
verify costs about two unbound ones (~75 s)."""

import random

import pytest
import torch

from fabric_token_sdk_tpu.crypto import setup as ref_setup, sigproof as ref_sigproof
from fabric_token_sdk_tpu.crypto import transfer as ref_tr
from fabric_token_sdk_tpu_torch.crypto import batch, setup, sigproof
from fabric_token_sdk_tpu_torch.crypto import transfer as tr
from fabric_token_sdk_tpu_torch.utils import metrics as mx
from torch_mesh_cases import MESH_SHAPES, ShardCounts, cpu_mesh
from torch_transfer_cases import host_verdicts, plant_range_rows, prove_txs

torch.set_num_threads(1)

LEAVES = ("parse", "encode", "device", "decode", "challenge")


def _spy_membership(v):
    """Record the proofs, commitments and verdicts of `v`'s membership
    part on every call."""
    seen = []
    real = v.membership.verify

    def spy(proofs, coms):
        out = real(proofs, coms)
        seen.append((list(proofs), list(coms), out.tolist()))
        return out

    v.membership.verify = spy
    return seen


def _span_totals():
    return {k: (v["count"], v["total_s"]) for k, v in mx.REGISTRY.span_summary().items()}


@pytest.fixture(scope="module")
def block():
    """Seven 2-in/2-out transfers (ragged over dp = 2) with the five range
    faults planted at rows 1-5; the unbound verdicts, membership calls
    and span totals of one verify with spans on."""
    pp = setup.setup(base=16, exponent=2, rng=random.Random(0x3E5C))
    txs, bad = plant_range_rows(prove_txs(pp, 7, random.Random(0x3E5D), shape=(2, 2)), start=1)
    v = batch.BatchedTransferVerifier(pp, device="cpu")
    seen = _spy_membership(v)
    was = mx.enabled()
    mx.enable(True)
    before = _span_totals()
    try:
        got = v.verify(txs)
    finally:
        after = _span_totals()
        mx.enable(was)
    spans = {k: (c - before.get(k, (0, 0.0))[0], t - before.get(k, (0, 0.0))[1])
             for k, (c, t) in after.items() if k.startswith("batch.")}
    return pp, txs, bad, got, seen, spans


def test_membership_spans_are_their_own_and_leaves_add_up(block):
    """C1: the membership check opens `batch.membership.{parse,device,
    decode,challenge}`; the `batch.range.*` leaves are the equality
    proofs' alone (two parse spans, one of each other); the leaves add
    up to within 3% of `batch.transfer.verify`, and no leaf total holds
    `batch.membership.verify` a second time."""
    spans = block[5]
    count = {k: c for k, (c, _) in spans.items()}
    total = {k: t for k, (_, t) in spans.items()}
    for leaf in ("parse", "device", "decode", "challenge"):
        assert count[f"batch.membership.{leaf}"] == 1
    assert count["batch.range.parse"] == 2
    assert all(count[f"batch.range.{leaf}"] == 1 for leaf in ("device", "decode", "challenge"))
    leaves = [f"batch.{p}.{leaf}" for p in ("wf", "membership", "range") for leaf in LEAVES]
    leaf_sum = sum(total.get(k, 0.0) for k in leaves)
    whole = total["batch.transfer.verify"]
    assert abs(leaf_sum - whole) <= 0.03 * whole
    ranges = sum(total.get(f"batch.range.{leaf}", 0.0) for leaf in LEAVES)
    assert total["batch.wf.verify"] + total["batch.membership.verify"] + ranges <= 1.03 * whole


@pytest.mark.parametrize("mesh_name", list(MESH_SHAPES))
def test_bound_2in2out_verify_equals_unbound_and_both_hosts(block, mesh_name):
    pp, txs, bad, unbound, seen_unbound, _ = block
    want = [i not in bad for i in range(len(txs))]
    assert unbound.tolist() == want
    v = batch.BatchedTransferVerifier(pp, device="cpu", mesh=cpu_mesh(mesh_name))
    seen = _spy_membership(v)
    with ShardCounts() as c:
        got = v.verify(txs)
    assert got.tolist() == want
    # WF 3, the membership check 9 (G2 ladder, add and to-affine, the G1
    # ladder, the P multiexp, to-affine, the commitment's multiexp, ladder
    # and sub), the equality proofs 6; one staged pairing product
    assert c.delta == {"stages.sharded_calls": 18, "stages.shards": 36,
                       "pairing.staged.sharded_calls": 1, "pairing.staged.shards": 2}
    # the membership part: the same rows and verdicts as unbound
    assert len(seen) == len(seen_unbound) == 1
    (proofs, coms, mem), (_, _, mem_unbound) = seen[0], seen_unbound[0]
    assert mem == mem_unbound
    assert not all(mem)  # the bumped value response
    if mesh_name == "(2, 2)":
        ref_pp = ref_setup.PublicParams.deserialize(pp.serialize())
        assert got.tolist() == host_verdicts(txs, tr.TransferVerifier, pp)
        assert got.tolist() == host_verdicts(txs, ref_tr.TransferVerifier, ref_pp)
        rp = pp.range_params
        for mod in (sigproof, ref_sigproof):
            host = []
            for p, com in zip(proofs, coms):
                try:
                    mod.MembershipVerifier(com, pp.ped_gen, rp.Q, rp.sign_pk,
                                           pp.ped_params[:2]).verify(
                        mod.MembershipProof.from_bytes(p.to_bytes()))
                    host.append(True)
                except Exception:
                    host.append(False)
            assert host == mem
