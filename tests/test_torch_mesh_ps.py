"""PyTorch port, `BatchedPSVerifier` bound to a mesh: nine
Pointcheval-Sanders rows (ragged over dp = 2; tampered and malformed
rows planted) on the logical (2, 1) and (2, 2) meshes of CPU devices,
against the unbound verifier bit for bit and the host verification of
both packages. The G2 stages (the ladder, the host-folded tree of adds,
the add of PK0, to-affine) run over the mesh's row groups, and the K = 2
products through the staged branch of `sharded_pairing_product`."""

import random

import pytest
import torch

from fabric_token_sdk_tpu.crypto import pssign as ref_ps
from fabric_token_sdk_tpu_torch.crypto import batch, pssign, setup
from torch_mesh_cases import MESH_SHAPES, ShardCounts, cpu_mesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rows():
    """(pp, messages, signatures, unbound verdicts): valid signatures on
    digits (two randomised), a wrong message, R and S swapped, a
    signature of another digit, a wrong message count, no signature."""
    pp = setup.setup(base=16, exponent=2, rng=random.Random(0x5153))
    rp = pp.range_params
    sv = pssign.SignVerifier(rp.sign_pk, rp.Q)
    rng = random.Random(0x5154)
    sigs = rp.signed_values
    msgs = [[3], [7], [15], [0], [4], [5], [6], [8, 9], [2]]
    signatures = [sigs[3], sv.randomize(sigs[7], rng), sv.randomize(sigs[15], rng), sigs[0],
                  sigs[5], pssign.Signature(sigs[5].S, sigs[5].R), sigs[9], sigs[8], None]
    unbound = batch.BatchedPSVerifier(rp.sign_pk, rp.Q, device="cpu").verify(msgs, signatures)
    return pp, msgs, signatures, unbound


def _host(verifier, msgs, sigs):
    out = []
    for m, s in zip(msgs, sigs):
        try:
            verifier.verify(m, s)
            out.append(True)
        except Exception:
            out.append(False)
    return out


@pytest.mark.parametrize("mesh_name", list(MESH_SHAPES))
def test_bound_ps_equals_unbound_and_both_hosts(rows, mesh_name):
    pp, msgs, sigs, unbound = rows
    rp = pp.range_params
    want = [True, True, True, True, False, False, False, False, False]
    assert unbound.tolist() == want
    v = batch.BatchedPSVerifier(rp.sign_pk, rp.Q, device="cpu", mesh=cpu_mesh(mesh_name))
    with ShardCounts() as c:
        got = v.verify(msgs, sigs)
    assert got.dtype == bool and got.tolist() == want
    assert c.delta == {"stages.sharded_calls": 4, "stages.shards": 8,
                       "pairing.staged.sharded_calls": 1, "pairing.staged.shards": 2}
    assert got.tolist() == _host(pssign.SignVerifier(rp.sign_pk, rp.Q), msgs, sigs)
    ref_sigs = [None if s is None else ref_ps.Signature(s.R, s.S) for s in sigs]
    assert got.tolist() == _host(ref_ps.SignVerifier(rp.sign_pk, rp.Q), msgs, ref_sigs)
