"""PyTorch port, `BatchedTransferProver` bound to a mesh: three
2-in/2-out requests (the JAX bench's shape and values; ragged over
dp = 2) through `TransferProver.batch` with the prover of
`prover_for(pp, "cpu", mesh)` on the logical (2, 1) and (2, 2) meshes of
CPU devices. The proof bytes equal the unbound prover's for one seed,
and both packages' host verifiers accept them; every commit stage (the
four select multiexps of the committers, the signature ladder and add,
the G2 ladder, add and to-affine) runs over the mesh's row groups and
the K = 2 product through the staged branch of
`sharded_pairing_product`. (The JAX package's batched prover, whose
bytes equal the unbound prover's, compiles its pairing programs for
minutes on the CPU: `tests/test_torch_prove_range.py` holds that in a
slow test, and `tests/test_torch_mesh_planes.py` holds a bound 1-in/1-out
prover to its bytes.)"""

import random

import pytest
import torch

from fabric_token_sdk_tpu.crypto import setup as ref_setup, transfer as ref_tr
from fabric_token_sdk_tpu_torch.crypto import batch_prove as bp, setup, token as tok
from fabric_token_sdk_tpu_torch.crypto import transfer as tr
from torch_mesh_cases import MESH_SHAPES, ShardCounts, cpu_mesh

torch.set_num_threads(1)

SEED = 0x3E5E


def _reqs(pp, count):
    rng = random.Random(SEED + 1)
    out = []
    for _ in range(count):
        ins, inw = tok.tokens_with_witness([100, 55], "USD", pp.ped_params, rng)
        outs, outw = tok.tokens_with_witness([120, 35], "USD", pp.ped_params, rng)
        out.append((inw, outw, ins, outs))
    return out


@pytest.fixture(scope="module")
def unbound():
    pp = setup.setup(base=16, exponent=2, rng=random.Random(SEED))
    reqs = _reqs(pp, 3)
    proofs = tr.TransferProver.batch(reqs, pp, rng=random.Random(SEED + 2), min_batch=1,
                                     device="cpu")
    return pp, reqs, proofs


@pytest.mark.parametrize("mesh_name", list(MESH_SHAPES))
def test_bound_2in2out_prove_bytes_equal_unbound(unbound, mesh_name):
    pp, reqs, want = unbound
    prover = bp.prover_for(pp, "cpu", mesh=cpu_mesh(mesh_name))
    try:
        with ShardCounts() as c:
            got = tr.TransferProver.batch(reqs, pp, rng=random.Random(SEED + 2), min_batch=1,
                                          prover=prover)
    finally:
        prover.set_mesh(None)
    assert got == want
    # WF: the 3-base commitments; range: the 2- and 3-base commitments,
    # the ladder, the P commitments, the add, the G2 ladder, add and
    # to-affine; one staged K = 2 product
    assert c.delta == {"stages.sharded_calls": 9, "stages.shards": 18,
                       "pairing.staged.sharded_calls": 1, "pairing.staged.shards": 2}
    if mesh_name == "(2, 2)":
        ref_pp = ref_setup.PublicParams.deserialize(pp.serialize())
        for (_, _, ins, outs), raw in zip(reqs, got):
            tr.TransferVerifier(ins, outs, pp).verify(raw)
            ref_tr.TransferVerifier(ins, outs, ref_pp).verify(raw)
