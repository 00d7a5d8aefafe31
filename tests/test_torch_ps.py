"""PyTorch port, `BatchedPSVerifier`: Pointcheval-Sanders signatures
verified as K = 2 pairing products, against the host verification of
both packages (`pssign.SignVerifier`) and, marked slow because the JAX
package compiles its pairing programs for minutes on the CPU, the JAX
package's `BatchedPSVerifier`.

The signatures are the range-proof parameters' signed set (`setup`
signs the digits 0..base-1 under `sign_pk`), some randomised, with
tampered and malformed rows. The port runs on the CPU (device="cpu")."""

import random

import numpy as np
import pytest
import torch

from fabric_token_sdk_tpu.crypto import batch as ref_batch, pssign as ref_ps
from fabric_token_sdk_tpu_torch.crypto import batch, pssign, setup
from fabric_token_sdk_tpu_torch.utils import metrics as mx

# The plain versions are many small tensor ops: one intra-op thread runs
# them faster than several and leaves the other test workers their cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rows():
    """(pp, messages, signatures, expected verdicts): valid signatures on
    digits (two randomised), a wrong message, R and S swapped, a
    signature from another digit, a wrong message count and no
    signature at all."""
    pp = setup.setup(base=16, exponent=2, rng=random.Random(0x5151))
    rp = pp.range_params
    sv = pssign.SignVerifier(rp.sign_pk, rp.Q)
    rng = random.Random(0x5152)
    sigs = rp.signed_values
    msgs = [[3], [7], [15], [0], [4], [5], [6], [8, 9], [2]]
    signatures = [sigs[3], sv.randomize(sigs[7], rng), sv.randomize(sigs[15], rng), sigs[0],
                  sigs[5], pssign.Signature(sigs[5].S, sigs[5].R), sigs[9], sigs[8], None]
    want = [True, True, True, True, False, False, False, False, False]
    return pp, msgs, signatures, want


def _host(verifier, msgs, sigs):
    out = []
    for m, s in zip(msgs, sigs):
        try:
            verifier.verify(m, s)
            out.append(True)
        except Exception:
            out.append(False)
    return out


def test_ps_verdicts_match_both_hosts(rows):
    pp, msgs, sigs, want = rows
    rp = pp.range_params
    before = mx.REGISTRY.counter("batch.ps.sigs").value
    got = batch.BatchedPSVerifier(rp.sign_pk, rp.Q, device="cpu").verify(msgs, sigs)
    assert mx.REGISTRY.counter("batch.ps.sigs").value - before == len(sigs)
    assert got.dtype == bool and got.tolist() == want
    assert got.tolist() == _host(pssign.SignVerifier(rp.sign_pk, rp.Q), msgs, sigs)
    ref_sigs = [None if s is None else ref_ps.Signature(s.R, s.S) for s in sigs]
    assert got.tolist() == _host(ref_ps.SignVerifier(rp.sign_pk, rp.Q), msgs, ref_sigs)


def test_ps_empty_and_default_device(rows, monkeypatch):
    pp = rows[0]
    rp = pp.range_params
    v = batch.BatchedPSVerifier(rp.sign_pk, rp.Q, device="cpu")
    assert v.verify([], []).shape == (0,)
    assert tuple(v.pk.shape) == (3, 3, 2, 8) and v.pk.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch.BatchedPSVerifier(rp.sign_pk, rp.Q)


@pytest.mark.slow
def test_ps_verdicts_match_reference_batched_verifier(rows):
    pp, msgs, sigs, _ = rows
    rp = pp.range_params
    ref_sigs = [None if s is None else ref_ps.Signature(s.R, s.S) for s in sigs]
    want = ref_batch.BatchedPSVerifier(rp.sign_pk, rp.Q).verify(msgs, ref_sigs)
    got = batch.BatchedPSVerifier(rp.sign_pk, rp.Q, device="cpu").verify(msgs, sigs)
    assert np.array_equal(got, want)
