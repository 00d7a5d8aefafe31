"""PyTorch port: a batched plane that fails on the card fails its block.

On a CUDA device the port never re-verifies on the host what a kernel
failed to verify: a failed kernel build, verifier construction, launch
or deadline, or an open breaker, raises `DevicePlaneError` out of the
block, on both engines, and nothing of the block commits. Here, without
a card, the pipeline's device is made to read CUDA while its verifiers
stay the driver's CPU ones, so the card's failure rule runs through the
kernels' plain versions. Once the plane serves again the same requests
commit with the JAX ledger's verdicts. The CPU's rule (the reference's
host re-verification, counted and flight-recorded) is pinned in
`tests/test_torch_{pipeline,recovery,resilience}.py`."""

import time

import pytest
import torch

from torch_network_cases import (
    PORT, REF, assert_same_ledger, build_both, counter, module, network, networks, policy,
    setup_both, submit_both, submit_many_both,
)

torch.set_num_threads(1)

resilience = PORT.utils_resilience
services_network = PORT.services_network
faults = PORT.utils_faults
mx = PORT.utils_metrics
VALID = "Valid"


@pytest.fixture(scope="module")
def zk_pps():
    return setup_both()


@pytest.fixture(autouse=True)
def _isolated():
    resilience.reset()
    yield
    faults.clear()
    resilience.reset()


def _ctr(name):
    return counter(PORT, name)


def _wait_stragglers(s0):
    deadline = time.monotonic() + 60
    while _ctr("resilience.bounded.stragglers") == s0 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert resilience.drain_stragglers(60.0)


def _on_the_card(monkeypatch, net, load=None):
    """Make `net`'s planes take the card's failure rule here on the CPU:
    the pipeline's device reads CUDA (so do the deadline, sign auto and
    `_plane_failed`) while its verifiers stay the driver's CPU ones, and
    loading the kernels is `load` (default: nothing to load)."""
    pipe = net._pipeline
    monkeypatch.setattr(pipe, "device", torch.device("cuda"))
    monkeypatch.setattr(pipe, "_load_kernels", load or (lambda: None))
    return pipe


def _failed_build():
    raise RuntimeError("the kernels' build failed")


def _events_since(n0):
    return [(e["kind"], e.get("reason")) for e in mx.FLIGHT.tail(len(mx.FLIGHT) - n0)]


@pytest.mark.parametrize("fault,pipeline", [
    ("error", True), ("timeout", False), ("construct", True), ("breaker_open", False)])
def test_proof_plane_failure_on_the_card_fails_the_block(zk_pps, fault, pipeline, monkeypatch):
    """On a CUDA device a proof plane that cannot serve a block (a launch
    error, a deadline timeout, a failed kernel build, an open breaker)
    fails the block on both engines: `DevicePlaneError` reaches the
    submitter, nothing of the block commits, and no row is re-verified
    on the host (no host row, no `host_fallback` event; a
    `verify.device_error` event). Once the plane serves again the same
    requests commit with the JAX ledger's verdicts."""
    tag = f"card-{fault}-{int(pipeline)}"
    envs, raws = build_both("zkatdlog", lambda e: [e.issue(f"{tag}-seed", [5, 5])] + [
        e.transfer(f"{tag}-{i}", [(f"{tag}-seed", i)], [5]) for i in range(2)], zk_pps)
    nets = networks(envs, max_block_txs=8, min_batch=2, pipeline=pipeline)
    submit_both(nets, raws[0])
    net = nets[PORT.root]
    pipe = _on_the_card(monkeypatch, net, _failed_build if fault == "construct" else None)
    if fault == "error":
        faults.arm("batch.verify", "error", count=1)
    elif fault == "timeout":
        monkeypatch.setenv("FTS_DEVICE_DEADLINE_VERIFY_S", "0.3")
        faults.arm("batch.verify", "hang", count=1, delay_s=60)
    elif fault == "breaker_open":
        resilience.breaker("verify").record_failure(trip_now=True)
    host0, be0, s0 = (_ctr(k) for k in ("ledger.validate.host", "ledger.block.batch_errors",
                                        "resilience.bounded.stragglers"))
    n0 = len(mx.FLIGHT)
    try:
        with pytest.raises(services_network.DevicePlaneError):
            net.submit_many(raws[1:])
    finally:
        faults.disarm("batch.verify")
    if fault == "timeout":
        _wait_stragglers(s0)
    assert net.height() == 1
    assert [net.status(f"{tag}-{i}") for i in range(2)] == [None, None]
    assert _ctr("ledger.validate.host") == host0
    assert _ctr("ledger.block.batch_errors") - be0 == (0 if fault == "breaker_open" else 1)
    seen = _events_since(n0)
    assert ("verify.device_error", fault) in seen
    assert not [k for k, _ in seen if k.endswith("host_fallback")]
    # the plane serves again: the same requests commit, batched
    resilience.reset()
    monkeypatch.delenv("FTS_DEVICE_DEADLINE_VERIFY_S", raising=False)
    monkeypatch.setattr(pipe, "_load_kernels", lambda: None)
    batched0 = _ctr("ledger.validate.batched")
    assert [s for _, s, _ in submit_many_both(nets, raws[1:])] == [VALID, VALID]
    assert _ctr("ledger.validate.batched") - batched0 == 2
    assert_same_ledger(nets)


@pytest.mark.parametrize("fault", ["error", "construct"])
def test_sign_plane_failure_on_the_card_fails_the_block(fault, monkeypatch):
    """On a CUDA device (sign auto: on) a sign plane whose launch raises
    or whose kernels fail to build fails the block: `DevicePlaneError`,
    nothing committed, no `batch.sign.host_fallbacks`, a
    `sign.device_error` event. Then the same requests commit with the
    JAX ledger's statuses and state."""
    def chain(e):
        return [e.issue("seed", [9])] + [
            e.transfer(f"t{k}", [("seed" if k == 0 else f"t{k - 1}", 0)], [9], to="alice")
            for k in range(2)]

    envs, raws = build_both("fabtoken", chain)
    net = network(PORT, envs[PORT.root], policy=policy(PORT, max_block_txs=16, sign_min_batch=2))
    ref = network(REF, envs[REF.root], policy=policy(REF, max_block_txs=16))
    assert net.submit(raws[0]).status.value == VALID  # on the CPU: sign auto is off
    pipe = _on_the_card(monkeypatch, net, _failed_build if fault == "construct" else None)
    assert pipe.sign_enabled()
    pipe._sign_verifier = (module(PORT, "crypto.batch_sign").BatchedSchnorrVerifier(device="cpu")
                           if fault == "error" else None)
    if fault == "error":
        faults.arm("batch.sign", "error", count=1)
    fb0, rows0 = _ctr("batch.sign.host_fallbacks"), _ctr("batch.sign.rows")
    n0 = len(mx.FLIGHT)
    with pytest.raises(services_network.DevicePlaneError):
        net.submit_many(raws[1:])
    assert net.height() == 1 and net.status("t0") is None and net.status("t1") is None
    assert _ctr("batch.sign.host_fallbacks") == fb0 and _ctr("batch.sign.rows") == rows0
    seen = _events_since(n0)
    assert ("sign.device_error", fault) in seen
    assert not [k for k, _ in seen if k.endswith("host_fallback")]
    resilience.reset()
    monkeypatch.setattr(pipe, "_load_kernels", lambda: None)
    pipe._sign_verifier = module(PORT, "crypto.batch_sign").BatchedSchnorrVerifier(device="cpu")
    assert [e.status.value for e in net.submit_many(raws[1:])] == [VALID, VALID]
    assert _ctr("batch.sign.rows") - rows0 == 2
    ref.submit(raws[0])
    ref.submit_many(raws[1:])
    ref_snap = REF.crypto_serialization.loads(ref.snapshot())
    port_snap = PORT.crypto_serialization.loads(net.snapshot())
    assert (port_snap["state"], port_snap["status"]) == (ref_snap["state"], ref_snap["status"])
