"""PyTorch port, the resilience layer: bounded device dispatch and
per-plane circuit breakers, against the JAX package.

Port mirrors of the `bounded_call`, breaker and hang-fault cases of
`tests/test_resilience.py` (`:84-420`), and of its block-level cases:
a `hang` at `batch.verify` commits via host fallback with the JAX
ledger's verdicts on both engines, an abandoned worker that completes
later applies nothing, a transient sign-plane construction failure
heals through the half-open probe, and `Network.health` serves the
breaker states. Also pinned: the commit-path deadline follows the
plane's device (bounded on a CUDA device, unbounded on the CPU), and
what "abandoned" means for work queued on a CUDA stream, modelled by a
FIFO worker standing for the stream (the card itself is not needed)."""

import concurrent.futures
import threading
import time

import pytest
import torch

from torch_network_cases import (
    PORT, REF, build_both, counter, module, network, networks, policy, setup_both,
    submit_both, submit_many_both,
)

torch.set_num_threads(1)

resilience = PORT.utils_resilience
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


# ------------------------------------------------------------------ the breaker

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _breaker(**kw):
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("timeout_threshold", 2)
    kw.setdefault("cooldown_s", 10.0)
    kw.setdefault("clock", _Clock())
    return resilience.CircuitBreaker("unit", **kw)


def test_breaker_opens_on_consecutive_failures():
    b = _breaker()
    assert b.state == "closed" and b.allow()
    b.record_failure()
    b.record_failure()
    assert b.state == "closed"
    b.record_failure()
    assert b.state == "open" and not b.allow() and b.rejecting()


def test_breaker_success_resets_failure_streak():
    b = _breaker()
    b.record_failure()
    b.record_failure()
    b.record_success()
    b.record_failure()
    b.record_failure()
    assert b.state == "closed"


def test_breaker_consecutive_timeouts_trip_faster():
    b = _breaker()
    b.record_failure(timeout=True)
    assert b.state == "closed"
    b.record_failure(timeout=True)
    assert b.state == "open"
    b2 = _breaker()
    b2.record_failure(timeout=True)
    b2.record_failure()  # breaks the timeout streak only
    b2.record_failure(timeout=True)
    assert b2.state == "open"  # by the failure threshold


def test_breaker_half_open_single_probe_then_close():
    clk = _Clock()
    b = _breaker(clock=clk)
    for _ in range(3):
        b.record_failure()
    assert not b.allow()
    clk.t += 9.9
    assert not b.allow()
    clk.t += 0.2
    assert b.state == "half-open" and not b.rejecting()
    assert b.allow()  # the single probe
    assert not b.allow()
    b.record_success()
    assert b.state == "closed" and b.allow()


def test_breaker_failed_probe_reopens_and_restarts_cooldown():
    clk = _Clock()
    b = _breaker(clock=clk)
    for _ in range(3):
        b.record_failure()
    clk.t += 10.1
    assert b.allow()
    b.record_failure()
    assert b.state == "open"
    clk.t += 5.0
    assert not b.allow()
    clk.t += 5.2
    assert b.allow()
    b.record_success()
    assert b.state == "closed"


def test_breaker_trip_now_opens_on_first_failure():
    clk = _Clock()
    b = _breaker(clock=clk)
    b.record_failure(trip_now=True)
    assert b.state == "open"
    clk.t += 10.1
    assert b.allow()
    b.record_success()
    assert b.state == "closed"


def test_breaker_env_config(monkeypatch):
    monkeypatch.setenv("FTS_BREAKER_FAILURES", "7")
    monkeypatch.setenv("FTS_BREAKER_TIMEOUTS", "4")
    monkeypatch.setenv("FTS_BREAKER_COOLDOWN_S", "1.5")
    resilience.reset()
    b = resilience.breaker("envtest")
    assert (b.failure_threshold, b.timeout_threshold, b.cooldown_s) == (7, 4, 1.5)


def test_breaker_transition_counters_and_state_gauge():
    o0, c0, p0, r0 = (_ctr(f"resilience.breaker.{k}") for k in ("open", "close", "probe",
                                                                 "rejected"))
    b = resilience.breaker("gaugetest")
    b.failure_threshold, b.timeout_threshold, b.cooldown_s = 1, 1, 0.05
    b.record_failure()
    assert _ctr("resilience.breaker.open") - o0 == 1
    assert mx.REGISTRY.gauge("resilience.breaker.state.gaugetest").value == 2
    assert not b.allow()
    assert _ctr("resilience.breaker.rejected") - r0 == 1
    time.sleep(0.06)
    assert b.allow()
    assert _ctr("resilience.breaker.probe") - p0 == 1
    b.record_success()
    assert _ctr("resilience.breaker.close") - c0 == 1
    assert mx.REGISTRY.gauge("resilience.breaker.state.gaugetest").value == 0
    assert resilience.breaker_states()["gaugetest"] == "closed"


def test_breaker_thread_safety():
    b = _breaker(failure_threshold=2, cooldown_s=0.001)

    def churn():
        for _ in range(200):
            if b.allow():
                b.record_failure()
            b.record_success()
            b.state

    threads = [threading.Thread(target=churn) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert b.state in ("closed", "open", "half-open")


def test_cancel_probe_releases_the_half_open_slot():
    clk = _Clock()
    b = _breaker(clock=clk)
    for _ in range(3):
        b.record_failure()
    clk.t += 10.1
    assert b.allow()
    b.cancel_probe()
    assert b.state == "half-open" and b.allow()
    b.record_success()
    assert b.state == "closed"


# ------------------------------------------------------------------ bounded_call

def test_bounded_call_unbounded_runs_inline():
    caller = threading.current_thread()
    seen = []
    assert resilience.bounded_call(lambda: seen.append(threading.current_thread()) or 7,
                                   0, plane="t") == 7
    assert seen == [caller]
    assert resilience.bounded_call(lambda: 8, None, plane="t") == 8


def test_bounded_call_result_and_exception_passthrough():
    assert resilience.bounded_call(lambda: [1, 2], 5.0, plane="t") == [1, 2]
    with pytest.raises(ValueError, match="boom"):
        resilience.bounded_call(lambda: (_ for _ in ()).throw(ValueError("boom")), 5.0,
                                plane="t")


def test_bounded_call_timeout_and_straggler_discard():
    t0, s0 = _ctr("resilience.bounded.timeouts"), _ctr("resilience.bounded.stragglers")
    release = threading.Event()
    start = time.monotonic()
    with pytest.raises(resilience.DeviceTimeout):
        resilience.bounded_call(lambda: release.wait(10) and "late", 0.1, plane="t")
    assert time.monotonic() - start < 5
    assert _ctr("resilience.bounded.timeouts") - t0 == 1
    release.set()
    deadline = time.monotonic() + 10
    while _ctr("resilience.bounded.stragglers") == s0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _ctr("resilience.bounded.stragglers") - s0 == 1


def test_straggler_drain_joins_abandoned_workers():
    release = threading.Event()
    with pytest.raises(resilience.DeviceTimeout):
        resilience.bounded_call(lambda: release.wait(30), 0.05, plane="t")
    assert not resilience.drain_stragglers(0.05)
    release.set()
    assert resilience.drain_stragglers(10.0)


def test_abandoned_stream_work_runs_on_and_the_next_dispatch_queues_behind():
    """What abandoning means for work on a CUDA stream, with a FIFO worker
    standing for the stream: the timed-out dispatch's work is not
    cancelled and finishes on the stream, its result is discarded (the
    caller saw DeviceTimeout and applies only what `bounded_call`
    returns; a straggler is counted), the next dispatch on the same
    stream completes only after it, and the teardown guard
    (`drain_stragglers`) joins the abandoned worker."""
    stream = concurrent.futures.ThreadPoolExecutor(max_workers=1)  # one FIFO queue
    gate = threading.Event()
    order, applied = [], []

    def launch(tag, hold=None):
        def kernel():
            if hold is not None:
                hold.wait(30)
            order.append(tag)
            return tag
        return stream.submit(kernel)

    def dispatch(tag, hold=None):
        return launch(tag, hold).result()  # the copy back waits for the stream

    s0 = _ctr("resilience.bounded.stragglers")
    with pytest.raises(resilience.DeviceTimeout):
        applied.append(resilience.bounded_call(dispatch, 0.1, "abandoned", gate, plane="t"))
    nxt = threading.Thread(target=lambda: applied.append(
        resilience.bounded_call(dispatch, 30.0, "next", plane="t")))
    nxt.start()
    time.sleep(0.1)
    assert order == []  # queued behind the abandoned launch
    gate.set()
    nxt.join(10)
    assert order == ["abandoned", "next"]
    assert resilience.drain_stragglers(10.0)
    assert _ctr("resilience.bounded.stragglers") - s0 == 1
    assert applied == ["next"]  # the late result was never applied
    stream.shutdown()


def test_device_deadline_follows_the_plane_device(monkeypatch):
    monkeypatch.delenv("FTS_DEVICE_DEADLINE_S", raising=False)
    monkeypatch.delenv("FTS_DEVICE_DEADLINE_VERIFY_S", raising=False)
    monkeypatch.delenv("FTS_DEVICE_DEADLINE_SIGN_S", raising=False)
    # the CPU (the plain versions) and no device: unbounded
    for dev in (None, "cpu", torch.device("cpu")):
        assert resilience.device_deadline_s("verify", dev) == 0.0
    # a CUDA device: the commit-path planes are bounded, others not
    for dev in ("cuda", "cuda:0", torch.device("cuda", 0)):
        assert resilience.device_deadline_s("verify", dev) == resilience.ACCEL_DEADLINE_S
        assert resilience.device_deadline_s("sign", dev) == resilience.ACCEL_DEADLINE_S
        assert resilience.device_deadline_s("prove", dev) == 0.0
    monkeypatch.setenv("FTS_DEVICE_DEADLINE_S", "3.5")
    assert resilience.device_deadline_s("verify", "cuda") == 3.5
    assert resilience.device_deadline_s("sign", "cpu") == 3.5
    monkeypatch.setenv("FTS_DEVICE_DEADLINE_VERIFY_S", "1.25")
    assert resilience.device_deadline_s("verify", "cpu") == 1.25  # per-plane wins
    monkeypatch.setenv("FTS_DEVICE_DEADLINE_VERIFY_S", "0")
    assert resilience.device_deadline_s("verify", "cuda") == 0.0  # 0 = unbounded


# ------------------------------------------------------------------ the hang fault kind

def test_hang_fault_blocks_until_disarm():
    faults.arm("unit.hang", "hang", count=1, delay_s=30)
    fired = threading.Event()
    f0 = _ctr("faults.injected.unit.hang")
    t = threading.Thread(target=lambda: (faults.fire("unit.hang"), fired.set()), daemon=True)
    t0 = time.monotonic()
    t.start()
    time.sleep(0.05)
    assert not fired.is_set()
    faults.disarm("unit.hang")
    assert fired.wait(5) and time.monotonic() - t0 < 5
    assert _ctr("faults.injected.unit.hang") - f0 == 1


def test_hang_fault_cap_releases_without_disarm():
    faults.arm("unit.cap", "hang", count=1, delay_s=0.1)
    t0 = time.monotonic()
    faults.fire("unit.cap")
    assert 0.05 < time.monotonic() - t0 < 5


def test_hang_fault_env_parse_and_default_cap():
    assert faults.load_env("a.site:hang:1.0:2:0.25,b.site:hang") == 2
    assert faults.armed() == {"a.site": "hang", "b.site": "hang"}
    with faults._lock:
        assert faults._armed["a.site"].delay_s == 0.25
        assert faults._armed["b.site"].delay_s == faults.HANG_CAP_S
        assert faults._armed["a.site"].release is not None


def test_clear_releases_all_hangers():
    faults.arm("u.one", "hang", delay_s=30)
    faults.arm("u.two", "hang", delay_s=30)
    done = []
    ts = [threading.Thread(target=lambda s=s: (faults.fire(s), done.append(s)), daemon=True)
          for s in ("u.one", "u.two")]
    for t in ts:
        t.start()
    time.sleep(0.05)
    faults.clear()
    for t in ts:
        t.join(5)
    assert sorted(done) == ["u.one", "u.two"]


# ------------------------------------------------------------------ a hung device plane

def _zk_block(zk_pps, pipeline, tag):
    """One zk block of two same-shape transfers on both ledgers; returns
    the port ledger and the statuses, asserted equal to the JAX ledger's."""
    envs, raws = build_both("zkatdlog", lambda e: [e.issue(f"{tag}-seed", [5, 5])] + [
        e.transfer(f"{tag}-{i}", [(f"{tag}-seed", i)], [5]) for i in range(2)], zk_pps)
    nets = networks(envs, max_block_txs=8, min_batch=2, pipeline=pipeline)
    submit_both(nets, raws[0])
    got = submit_many_both(nets, raws[1:])
    return nets[PORT.root], [s for _, s, _ in got]


def _wait_stragglers(s0):
    deadline = time.monotonic() + 60
    while _ctr("resilience.bounded.stragglers") == s0 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert resilience.drain_stragglers(60.0)


@pytest.mark.parametrize("pipeline", [True, False])
def test_hang_fault_commits_via_host_fallback_same_verdicts(zk_pps, pipeline, monkeypatch):
    """With `hang` injected at `batch.verify` the block commits via host
    fallback within the deadline plus slack, with the JAX ledger's
    verdicts, on both engines; the timeout is counted, flight-recorded
    and served by `health()`."""
    monkeypatch.setenv("FTS_DEVICE_DEADLINE_VERIFY_S", "0.5")
    to0, be0, host0 = (_ctr(k) for k in ("resilience.bounded.timeouts",
                                         "ledger.block.batch_errors", "ledger.validate.host"))
    s0 = _ctr("resilience.bounded.stragglers")
    faults.arm("batch.verify", "hang", count=1, delay_s=60)
    t0 = time.monotonic()
    try:
        net, statuses = _zk_block(zk_pps, pipeline, f"hang{int(pipeline)}")
    finally:
        faults.disarm("batch.verify")  # release the abandoned worker
    assert time.monotonic() - t0 < 30
    assert statuses == [VALID, VALID]
    assert _ctr("resilience.bounded.timeouts") - to0 == 1
    assert _ctr("ledger.block.batch_errors") - be0 == 1
    assert _ctr("ledger.validate.host") - host0 == 2
    assert any(e["kind"] == "verify.host_fallback" and e.get("reason") == "timeout"
               for e in mx.FLIGHT.tail(50))
    assert net.health()["breakers"] == {"verify": "closed"}  # one timeout of two
    _wait_stragglers(s0)  # the released worker runs its discarded verify


@pytest.mark.parametrize("pipeline", [True, False])
def test_straggler_worker_does_not_double_apply(zk_pps, pipeline, monkeypatch):
    """An abandoned verify worker that completes AFTER host fallback
    resolved the block applies nothing: tx and block counters unchanged,
    and the ledger never counts its rows as batched. The verifier's own
    completion counter (`batch.transfer.txs`) does count the finished,
    discarded call: the verifier knows nothing of the deadline."""
    monkeypatch.setenv("FTS_DEVICE_DEADLINE_VERIFY_S", "0.15")
    s0, valid0, batched0, blocks0, devtxs0 = (_ctr(k) for k in (
        "resilience.bounded.stragglers", "network.tx.valid", "ledger.validate.batched",
        "ledger.blocks.committed", "batch.transfer.txs"))
    # the worker outlives the deadline, then runs the real verify
    faults.arm("batch.verify", "hang", count=1, delay_s=0.5)
    try:
        _, statuses = _zk_block(zk_pps, pipeline, f"strag{int(pipeline)}")
    finally:
        faults.disarm("batch.verify")
    assert statuses == [VALID, VALID]
    valid_after = _ctr("network.tx.valid") - valid0
    blocks_after = _ctr("ledger.blocks.committed") - blocks0
    _wait_stragglers(s0)
    assert _ctr("resilience.bounded.stragglers") - s0 == 1
    assert _ctr("network.tx.valid") - valid0 == valid_after
    assert _ctr("ledger.blocks.committed") - blocks0 == blocks_after
    assert _ctr("ledger.validate.batched") - batched0 == 0
    assert _ctr("batch.transfer.txs") - devtxs0 == 2


def test_sign_plane_transient_construction_failure_heals(monkeypatch):
    """A transient verifier construction failure opens the `sign`
    breaker (host fallback, counted, collection skipped while open), and
    after the cooldown the half-open probe rebuilds the verifier and the
    rows ride the plane again."""
    bs_module = module(PORT, "crypto.batch_sign")

    def chain(e):
        reqs = [e.issue("seed", [9])]
        for k in range(6):
            reqs.append(e.transfer(f"t{k}", [("seed" if k == 0 else f"t{k - 1}", 0)], [9],
                                   to="alice"))
        return reqs

    envs, reqs = build_both("fabtoken", chain)
    chunks = [reqs[0:3], reqs[3:5], reqs[5:7]]  # >= 2 pk obligations each
    net = network(PORT, envs[PORT.root], policy=policy(
        PORT, max_block_txs=16, sign_batched=True, sign_min_batch=2))
    ref = network(REF, envs[REF.root], policy=policy(REF, max_block_txs=16))
    brk = resilience.breaker("sign")
    brk.failure_threshold = 1
    brk.cooldown_s = 1.5
    fb0, rows0 = _ctr("batch.sign.host_fallbacks"), _ctr("batch.sign.rows")
    real = bs_module.BatchedSchnorrVerifier

    class _Boom:
        def __init__(self, *a, **k):
            raise MemoryError("transient construction OOM")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bs_module, "BatchedSchnorrVerifier", _Boom)
        assert all(e.status.value == VALID for e in net.submit_many(chunks[0]))
        assert _ctr("batch.sign.host_fallbacks") - fb0 == 3
        assert brk.state == "open"
        assert any(e["kind"] == "sign.host_fallback" and e.get("reason") == "construct"
                   for e in mx.FLIGHT.tail(50))
        assert all(e.status.value == VALID for e in net.submit_many(chunks[1]))
        assert _ctr("batch.sign.host_fallbacks") - fb0 == 3  # collection skipped
        assert _ctr("batch.sign.rows") == rows0
    assert bs_module.BatchedSchnorrVerifier is real
    time.sleep(1.6)  # the cooldown expires: the half-open probe is due
    assert all(e.status.value == VALID for e in net.submit_many(chunks[2]))
    assert _ctr("batch.sign.rows") - rows0 == 2
    assert brk.state == "closed"
    for chunk in chunks:
        ref.submit_many(chunk)
    ref_snap = REF.crypto_serialization.loads(ref.snapshot())
    port_snap = PORT.crypto_serialization.loads(net.snapshot())
    assert (port_snap["state"], port_snap["status"]) == (ref_snap["state"], ref_snap["status"])


def test_health_serves_breaker_states(zk_pps):
    resilience.breaker("verify").record_failure()
    envs, _ = build_both("zkatdlog", lambda e: [], zk_pps)
    h = network(PORT, envs[PORT.root], policy=policy(PORT)).health()
    assert h["breakers"] == {"verify": "closed"}
    assert h["repl"] is None and h["device"]["name"] == "cpu"
    assert set(h) >= {"height", "txs_final", "queue_depth", "inflight", "wal", "last_block",
                      "slo", "caches"}


def test_slo_engine_matches_reference():
    """The SLO engine (a copy) over the port's histograms: the same
    observations give the reference's windowed burn, budget and
    good fractions, and `fraction_le` interpolates as the reference's."""
    values = [0.002, 0.04, 0.3, 0.7, 0.9, 1.2, 3.0, 0.05]
    got = {}
    for P in (REF, PORT):
        h = P.utils_metrics.Histogram("unit.slo")
        for v in values:
            h.observe(v)
        counts, n, _ = h.state()
        assert n == len(values)
        fracs = [P.utils_metrics.Histogram.fraction_le(h.buckets, counts, t)
                 for t in (0.001, 0.2, 1.0, 1.7, 1000.0)]
        engine = P.utils_slo.SLOEngine(window_s=60.0, finality_p99_s=0.5, commit_p99_s=1.0)
        for v in values:
            P.utils_metrics.histogram("ledger.block.commit.seconds").observe(v)
            P.utils_metrics.histogram("network.submit_to_finality.seconds").observe(v / 2)
        P.utils_metrics.counter("ledger.ordering.enqueued").inc(len(values))
        P.utils_metrics.counter("orderer.backpressure.rejects").inc(1)
        got[P.root] = (fracs, engine.evaluate()["slos"])
    assert got[PORT.root] == got[REF.root]
    assert not got[PORT.root][1]["commit_p99"]["ok"]  # 2 of 8 commits over 1 s
