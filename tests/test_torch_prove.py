"""PyTorch port, the prove plane: the select-based fixed-base multiexp,
`BatchedPedersen`, and `BatchedTransferProver` / `TransferProver.batch`
on 1-in/1-out transfers, against hostmath and the JAX package.

The same inputs go to both packages: public parameters from
`setup(base=16, exponent=2, rng=random.Random(seed))` in each, witness
sets from `tokens_with_witness` on one seed, the prover's rng from
another. The port runs on the CPU (device="cpu": the plain torch
versions of its kernels); the JAX package runs as its own tests run it.
Everything is exact: canonical integers, verdicts and proof bytes. The
2-in/2-out prove runs in `tests/test_torch_prove_range.py`."""

import random

import numpy as np
import pytest
import torch

from fabric_token_sdk_tpu.crypto import batch_prove as ref_bp
from fabric_token_sdk_tpu.crypto import pedersen as ref_ped, setup as ref_setup
from fabric_token_sdk_tpu.crypto import token as ref_tok, transfer as ref_tr
from fabric_token_sdk_tpu.ops import curve as ref_cv, stages as ref_st
from fabric_token_sdk_tpu_torch.crypto import batch, batch_prove as bp, hostmath as hm
from fabric_token_sdk_tpu_torch.crypto import pedersen, setup, token as tok, transfer as tr
from fabric_token_sdk_tpu_torch.crypto import wellformedness as wf
from fabric_token_sdk_tpu_torch.ops import curve as cv, limbs as lb, stages as st
from fabric_token_sdk_tpu_torch.utils import metrics as mx

# The plain versions are many small tensor ops: one intra-op thread runs
# them faster than several and leaves the other test workers their cores.
torch.set_num_threads(1)

SEED = 0x9E0F


@pytest.fixture(scope="module")
def params():
    ref_pp = ref_setup.setup(base=16, exponent=2, rng=random.Random(SEED))
    pp = setup.setup(base=16, exponent=2, rng=random.Random(SEED))
    return ref_pp, pp


def make_reqs(tok_mod, pp, seed, in_vals, out_vals, count):
    """Prove requests (in_witnesses, out_witnesses, inputs, outputs)."""
    rng = random.Random(seed)
    out = []
    for _ in range(count):
        ins, inw = tok_mod.tokens_with_witness(in_vals, "USD", pp.ped_params, rng)
        outs, outw = tok_mod.tokens_with_witness(out_vals, "USD", pp.ped_params, rng)
        out.append((inw, outw, ins, outs))
    return out


def host_accepts(verifier_cls, pp, req, proof) -> bool:
    try:
        verifier_cls(req[2], req[3], pp).verify(proof)
        return True
    except Exception:
        return False


# ------------------------------------------------------------------ multiexp

def _bases(seed, n):
    rng = random.Random(seed)
    return [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(n)]


# scalar edges: 0, 1, r-1, every digit 15 (2^256 - 1, not reduced: the
# kernels read the words as given), one non-zero window, random
_EDGES = [0, 1, hm.R - 1, (1 << 256) - 1, 7 << (4 * 37)]


@pytest.mark.parametrize("nbases", [1, 2, 3])
def test_msm_select_plain_equals_gather_reference_and_hostmath(nbases):
    rng = random.Random(400 + nbases)
    bases = _bases(410 + nbases, nbases)
    rows = [[k] * nbases for k in _EDGES] + [
        [rng.randrange(hm.R) for _ in range(nbases)] for _ in range(3)]
    rows[-1][0] = 0  # a row mixing a zero scalar with random ones
    words = lb.ints_to_words([s for r in rows for s in r]).reshape(len(rows), nbases, 8)
    sc = torch.from_numpy(words)
    table = cv.FixedBaseTable(bases)
    got = st.g1_msm_select_rows(table.table, sc)
    assert got.dtype == torch.int32 and got.shape == (len(rows), 3, 8)
    assert torch.equal(got, st.g1_msm_select_plain(table.table, sc))
    assert torch.equal(got, st.g1_msm_plain(table.table, sc))
    assert cv.decode_points(got) == [hm.g1_multiexp(bases, [s % hm.R for s in r]) for r in rows]
    ref_out = ref_st.g1_msm_rows(np.asarray(ref_cv.FixedBaseTable(bases).flat),
                                 lb.to_reference_limbs(words))
    assert torch.equal(got, lb.from_reference_limbs(ref_out, hm.P))


def test_msm_select_rows_rejects_bad_input():
    table = cv.FixedBaseTable(_bases(420, 2))
    with pytest.raises(ValueError, match="g1_msm_select"):
        st.g1_msm_select_rows(table.table, torch.zeros((2, 3, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        st.g1_msm_select_rows(table.table, torch.zeros((0, 2, 8), dtype=torch.int32))


# ------------------------------------------------------------------ Pedersen

@pytest.mark.parametrize("nbases", [2, 3])
def test_batched_pedersen_matches_hostmath_and_reference(nbases):
    rng = random.Random(430 + nbases)
    bases = _bases(440 + nbases, nbases)
    rows = [[0] * nbases, [hm.R - 1] * nbases] + [
        [rng.randrange(hm.R) for _ in range(nbases)] for _ in range(3)]
    ped = pedersen.BatchedPedersen(bases).to("cpu")
    pts, jac = ped.commit_ints(rows)
    want = [hm.g1_multiexp(bases, r) for r in rows]
    assert pts == want
    assert pts == ref_ped.BatchedPedersen(bases).commit_ints(rows)[0]
    assert pts == [pedersen.commit(r, bases) for r in rows]
    assert ped.commit_batch(rows) == want
    assert jac.shape == (len(rows), 3, 8) and jac.device.type == "cpu"
    # the fused entry point: any leading shape, one launch
    sc = torch.from_numpy(cv.encode_scalars([s for r in rows[:4] for s in r])
                          .reshape(2, 2, nbases, 8))
    dev = ped.commit_device(sc)
    assert dev.shape == (2, 2, 3, 8)
    assert torch.equal(dev.reshape(4, 3, 8), jac[:4])
    assert "table.table" in dict(ped.named_buffers())


def test_prover_never_reaches_the_gather(params, monkeypatch):
    """Every fixed-base multiexp of the prover takes the select form:
    with the gather wrapper and its plain version disabled, a batched
    prove still runs, and the select wrapper ran."""
    _, pp = params

    def forbidden(*a, **k):
        raise AssertionError("the prover reached the gather multiexp")

    calls = []
    select = st.g1_msm_select_rows

    def counting(*a):
        calls.append(a[1].shape[0])
        return select(*a)

    monkeypatch.setattr(st, "g1_msm_rows", forbidden)
    monkeypatch.setattr(st, "g1_msm_plain", forbidden)
    monkeypatch.setattr(st, "g1_msm_select_rows", counting)
    prover = bp.BatchedTransferProver(pp, device="cpu")
    reqs = make_reqs(tok, pp, 450, [6], [6], 2)
    proofs = prover.prove(reqs, random.Random(451))
    assert calls == [2 * 4]  # one ped3 launch over 2 txs x 4 WF rows
    assert all(host_accepts(tr.TransferVerifier, pp, r, p) for r, p in zip(reqs, proofs))


# ------------------------------------------------------------------ 1-in/1-out

def test_1in1out_batched_proofs_byte_identical_to_reference(params):
    ref_pp, pp = params
    reqs = make_reqs(tok, pp, 460, [7], [7], 3)
    ref_reqs = make_reqs(ref_tok, ref_pp, 460, [7], [7], 3)
    assert [r[2:] for r in reqs] == [r[2:] for r in ref_reqs]
    prover = bp.BatchedTransferProver(pp, device="cpu")
    txs_before = mx.REGISTRY.counter("batch.prove.txs").value
    got = prover.prove(reqs, random.Random(461))
    assert mx.REGISTRY.counter("batch.prove.txs").value - txs_before == 3
    want = ref_bp.BatchedTransferProver(ref_pp).prove(ref_reqs, random.Random(461))
    assert got == want
    for req, proof in zip(reqs, got):
        assert host_accepts(tr.TransferVerifier, pp, req, proof)
        assert host_accepts(ref_tr.TransferVerifier, ref_pp, req, proof)
    verdicts = batch.BatchedTransferVerifier(pp, device="cpu").verify(
        [(r[2], r[3], p) for r, p in zip(reqs, got)])
    assert verdicts.tolist() == [True] * 3


def test_1in1out_tampered_response_rejected(params):
    _, pp = params
    reqs = make_reqs(tok, pp, 470, [9], [9], 2)
    proofs = tr.TransferProver.batch(reqs, pp, rng=random.Random(471), min_batch=1,
                                     device="cpu")
    p = tr.TransferProof.from_bytes(proofs[0])
    w = wf.TransferWF.from_bytes(p.wf)
    w.sum_resp = (w.sum_resp + 1) % hm.R
    bad = tr.TransferProof(w.to_bytes(), None).to_bytes()
    assert not host_accepts(tr.TransferVerifier, pp, reqs[0], bad)
    got = batch.BatchedTransferVerifier(pp, device="cpu").verify(
        [(reqs[0][2], reqs[0][3], bad), (reqs[1][2], reqs[1][3], proofs[1])])
    assert got.tolist() == [False, True]


# ------------------------------------------------------------------ TransferProver.batch

class _Boom:
    def prove(self, reqs, rng=None):
        raise MemoryError("injected device fault")


def test_batch_of_nothing(params):
    _, pp = params
    assert tr.TransferProver.batch([], pp) == []
    assert bp.BatchedTransferProver(pp, device="cpu").prove([]) == []


def test_batch_mixed_shapes_in_request_order_equal_reference(params):
    """Groups by shape, results in request order: the 1-in/1-out pair
    takes the batched prover, the 2-in/2-out singleton (below min_batch)
    the host prover; the bytes equal the JAX package's for one seed."""
    ref_pp, pp = params
    dev = make_reqs(tok, pp, 480, [4], [4], 2)
    odd = make_reqs(tok, pp, 481, [5, 10], [7, 8], 1)
    reqs = [dev[0], odd[0], dev[1]]
    ref_dev = make_reqs(ref_tok, ref_pp, 480, [4], [4], 2)
    ref_odd = make_reqs(ref_tok, ref_pp, 481, [5, 10], [7, 8], 1)
    host_before = mx.REGISTRY.counter("batch.prove.host").value
    txs_before = mx.REGISTRY.counter("batch.prove.txs").value
    got = tr.TransferProver.batch(reqs, pp, rng=random.Random(482), min_batch=2, device="cpu")
    assert mx.REGISTRY.counter("batch.prove.host").value - host_before == 1
    assert mx.REGISTRY.counter("batch.prove.txs").value - txs_before == 2
    want = ref_tr.TransferProver.batch([ref_dev[0], ref_odd[0], ref_dev[1]], ref_pp,
                                       rng=random.Random(482), min_batch=2)
    assert got == want
    for req, proof in zip(reqs, got):
        assert host_accepts(tr.TransferVerifier, pp, req, proof)


def test_batch_below_min_batch_routes_host(params, monkeypatch):
    _, pp = params
    monkeypatch.setattr(bp, "prover_for", lambda *a, **k: _Boom())
    reqs = make_reqs(tok, pp, 490, [5], [5], 2)
    host_before = mx.REGISTRY.counter("batch.prove.host").value
    txs_before = mx.REGISTRY.counter("batch.prove.txs").value
    proofs = tr.TransferProver.batch(reqs, pp, rng=random.Random(491), min_batch=5)
    assert mx.REGISTRY.counter("batch.prove.host").value - host_before == 2
    assert mx.REGISTRY.counter("batch.prove.txs").value == txs_before
    assert all(host_accepts(tr.TransferVerifier, pp, r, p) for r, p in zip(reqs, proofs))


def test_min_batch_from_environment(monkeypatch):
    monkeypatch.delenv("FTS_PROVE_MIN_BATCH", raising=False)
    assert tr._prove_min_batch() == 2
    monkeypatch.setenv("FTS_PROVE_MIN_BATCH", "7")
    assert tr._prove_min_batch() == 7
    monkeypatch.setenv("FTS_PROVE_MIN_BATCH", "0")
    assert tr._prove_min_batch() == 1
    monkeypatch.setenv("FTS_PROVE_MIN_BATCH", "x")
    assert tr._prove_min_batch() == 2


def test_device_error_propagates_no_host_fallback(params, monkeypatch):
    """The port's counterpart of the reference's
    `test_device_error_falls_back_to_host`, inverted on purpose: a device
    failure raises and nothing is proved on the host in its place."""
    _, pp = params
    reqs = make_reqs(tok, pp, 500, [3], [3], 2)
    host_before = mx.REGISTRY.counter("batch.prove.host").value
    with pytest.raises(MemoryError, match="injected device fault"):
        tr.TransferProver.batch(reqs, pp, rng=random.Random(501), min_batch=1, prover=_Boom())
    monkeypatch.setattr(bp, "prover_for", lambda *a, **k: _Boom())
    with pytest.raises(MemoryError):
        tr.TransferProver.batch(reqs, pp, rng=random.Random(501), min_batch=1)
    assert mx.REGISTRY.counter("batch.prove.host").value == host_before


def test_default_device_is_the_card(params, monkeypatch):
    _, pp = params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bp.BatchedTransferProver(pp)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bp.prover_for(pp)
    reqs = make_reqs(tok, pp, 510, [2], [2], 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.TransferProver.batch(reqs, pp, rng=random.Random(511), min_batch=1)


def test_uniform_shape_required_and_prover_cache(params):
    _, pp = params
    prover = bp.prover_for(pp, device="cpu")
    assert bp.prover_for(pp, device="cpu") is prover
    assert prover.device.type == "cpu"
    reqs = make_reqs(tok, pp, 520, [4], [4], 1) + make_reqs(tok, pp, 521, [5, 5], [6, 4], 1)
    with pytest.raises(ValueError, match="uniform"):
        prover.prove(reqs)


def test_prover_state_buffers(params):
    _, pp = params
    prover = bp.BatchedTransferProver(pp, device="cpu")
    state = prover.state_dict()
    assert sorted(state) == ["Q", "ped2.table.table", "ped3.table.table", "pedP.table.table",
                             "pk", "sig_R", "sig_S"]
    assert tuple(state["pk"].shape) == (3, 3, 2, 8)
    assert tuple(state["Q"].shape) == (2, 2, 8)
    assert tuple(state["sig_R"].shape) == (16, 3, 8) == tuple(state["sig_S"].shape)
    assert tuple(state["ped3.table.table"].shape) == (192, 16, 3, 8)
    assert cv.decode_points(state["sig_R"]) == [s.R for s in pp.range_params.signed_values]
    assert all(t.device.type == "cpu" for t in state.values())
