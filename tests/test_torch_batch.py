"""PyTorch port, the slice as a whole: `BatchedTransferVerifier` on
1-in/1-out zkatdlog transfers, against the JAX package's batched
verifier and the host verifiers of both packages.

Proofs are made once with the port's host prover from a seeded
`random.Random`; public parameters cross over as bytes. The port runs
on the CPU here (device="cpu": the plain torch versions of its
kernels); verdict arrays must be equal."""

import random

import numpy as np
import pytest
import torch

from fabric_token_sdk_tpu.crypto import batch as ref_batch, setup as ref_setup
from fabric_token_sdk_tpu.crypto import transfer as ref_tr
from fabric_token_sdk_tpu_torch.crypto import batch, hostmath as hm, setup, token as tok
from fabric_token_sdk_tpu_torch.crypto import transfer as tr, wellformedness as wf


@pytest.fixture(scope="module")
def pp():
    return setup.setup(base=16, exponent=2, rng=random.Random(0xB10C))


def _txs(pp, count, rng, shape=(1, 1)):
    out = []
    for _ in range(count):
        vals = [rng.randrange(1, 50) for _ in range(shape[0])]
        ins, inw = tok.tokens_with_witness(vals, "USD", pp.ped_params, rng)
        outs_v = vals if shape[1] == shape[0] else [sum(vals)] + [0] * (shape[1] - 1)
        outs, outw = tok.tokens_with_witness(outs_v, "USD", pp.ped_params, rng)
        out.append((ins, outs, tr.TransferProver(inw, outw, ins, outs, pp, rng).prove()))
    return out


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


def _host(txs, verifier_cls, pp):
    out = []
    for ins, outs, raw in txs:
        try:
            verifier_cls(ins, outs, pp).verify(raw)
            out.append(True)
        except Exception:
            out.append(False)
    return out


def test_verdicts_match_reference_batched_and_host(pp):
    txs = _plant(_txs(pp, 6, random.Random(71)))
    got = batch.BatchedTransferVerifier(pp, device="cpu").verify(txs)
    assert got.dtype == bool and got.tolist() == [True, True, False, False, False, True]

    ref_pp = ref_setup.PublicParams.deserialize(pp.serialize())
    want = ref_batch.BatchedTransferVerifier(ref_pp).verify(txs)
    assert np.array_equal(got, want)
    assert got.tolist() == _host(txs, tr.TransferVerifier, pp)
    assert got.tolist() == _host(txs, ref_tr.TransferVerifier, ref_pp)


def test_empty_batch_and_table_placement(pp):
    v = batch.BatchedTransferVerifier(pp, device="cpu")
    assert v.verify([]).shape == (0,)
    assert v.wf.verify([]).shape == (0,)
    assert v.table3.table.device.type == "cpu" and v.table3.nbases == 3


def test_other_shapes_raise_not_implemented(pp):
    txs = _txs(pp, 1, random.Random(73), shape=(2, 2))
    v = batch.BatchedTransferVerifier(pp, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        v.verify(txs)


def test_default_device_is_the_card(pp, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch.BatchedTransferVerifier(pp)
    with pytest.raises(RuntimeError):
        batch.resolve_device("cuda")
    assert batch.resolve_device("cpu").type == "cpu"
