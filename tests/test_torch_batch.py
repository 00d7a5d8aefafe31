"""PyTorch port, the slice as a whole: `BatchedTransferVerifier` on
1-in/1-out and 2-in/2-out zkatdlog transfers, against the JAX package's
batched verifier and the host verifiers of both packages.

Proofs are made once with the port's host prover from a seeded
`random.Random`; public parameters cross over as bytes. The port runs
on the CPU here (device="cpu": the plain torch versions of its
kernels); verdict arrays must be equal. The JAX package's batched
verifier of a range-proof block compiles its pairing programs for
minutes on the CPU, so that comparison is marked slow."""

import random

import numpy as np
import pytest
import torch

from fabric_token_sdk_tpu.crypto import batch as ref_batch, setup as ref_setup
from fabric_token_sdk_tpu.crypto import transfer as ref_tr
from fabric_token_sdk_tpu_torch.crypto import batch, hostmath as hm, setup
from fabric_token_sdk_tpu_torch.crypto import transfer as tr, wellformedness as wf
from torch_transfer_cases import PLANTS, host_verdicts, plant_range_rows, prove_txs

# The plain versions are many small tensor ops: one intra-op thread runs
# them faster than several and leaves the other test workers their cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pp():
    return setup.setup(base=16, exponent=2, rng=random.Random(0xB10C))


def _plant(txs):
    """A bumped sum_resp (row 2), a swapped output commitment (row 3) and
    truncated proof bytes (row 4)."""
    txs = list(txs)
    p = tr.TransferProof.from_bytes(txs[2][2])
    w = wf.TransferWF.from_bytes(p.wf)
    w.sum_resp = (w.sum_resp + 1) % hm.R
    txs[2] = (txs[2][0], txs[2][1], tr.TransferProof(w.to_bytes(), None).to_bytes())
    txs[3] = (txs[3][0], txs[5][1], txs[3][2])
    txs[4] = (txs[4][0], txs[4][1], txs[4][2][:-5])
    return txs


def test_verdicts_match_reference_batched_and_host(pp):
    txs = _plant(prove_txs(pp, 6, random.Random(71)))
    got = batch.BatchedTransferVerifier(pp, device="cpu").verify(txs)
    assert got.dtype == bool and got.tolist() == [True, True, False, False, False, True]

    ref_pp = ref_setup.PublicParams.deserialize(pp.serialize())
    want = ref_batch.BatchedTransferVerifier(ref_pp).verify(txs)
    assert np.array_equal(got, want)
    assert got.tolist() == host_verdicts(txs, tr.TransferVerifier, pp)
    assert got.tolist() == host_verdicts(txs, ref_tr.TransferVerifier, ref_pp)


def test_empty_batch_and_table_placement(pp):
    v = batch.BatchedTransferVerifier(pp, device="cpu")
    assert v.verify([]).shape == (0,)
    assert v.wf.verify([]).shape == (0,)
    assert v.table3.table.device.type == "cpu" and v.table3.nbases == 3


def test_mixed_shapes_raise_not_implemented(pp):
    txs = prove_txs(pp, 1, random.Random(73), shape=(2, 2)) + prove_txs(pp, 1, random.Random(74))
    v = batch.BatchedTransferVerifier(pp, device="cpu")
    with pytest.raises(NotImplementedError, match="mixed transfer shapes"):
        v.verify(txs)


@pytest.fixture(scope="module")
def range_block(pp):
    """Seven 2-in/2-out transfers: rows 1-5 carry the planted faults of
    PLANTS (a bumped membership value_resp, swapped digit commitments, a
    bumped range challenge, truncated range bytes, no range proof)."""
    txs, bad = plant_range_rows(prove_txs(pp, 7, random.Random(75), shape=(2, 2)), start=1)
    return txs, bad


def test_range_block_verdicts_match_both_hosts(pp, range_block):
    txs, bad = range_block
    assert len(bad) == len(PLANTS)
    got = batch.BatchedTransferVerifier(pp, device="cpu").verify(txs)
    assert got.tolist() == [i not in bad for i in range(len(txs))]
    assert got.tolist() == host_verdicts(txs, tr.TransferVerifier, pp)
    ref_pp = ref_setup.PublicParams.deserialize(pp.serialize())
    assert got.tolist() == host_verdicts(txs, ref_tr.TransferVerifier, ref_pp)


@pytest.mark.slow
def test_range_block_matches_reference_batched_verifier(pp, range_block):
    txs, _ = range_block
    ref_pp = ref_setup.PublicParams.deserialize(pp.serialize())
    want = ref_batch.BatchedTransferVerifier(ref_pp).verify(txs)
    assert np.array_equal(batch.BatchedTransferVerifier(pp, device="cpu").verify(txs), want)


def test_default_device_is_the_card(pp, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch.BatchedTransferVerifier(pp)
    with pytest.raises(RuntimeError):
        batch.resolve_device("cuda")
    assert batch.resolve_device("cpu").type == "cpu"
