"""PyTorch port, the live ops plane and the remote trace plane, against the
JAX package.

Port mirrors of `tests/test_ops_plane.py:50-80` (histogram quantiles,
their snapshot equal to the JAX package's for the same observations) and
`:97-346` (host and card memory telemetry, where sampling on the CPU
reports no device and leaves CUDA uninitialized; the orderer's queue and
in-flight gauges; `ops.health`/`ops.metrics` answering during slow
commits; the flight tail and the registry snapshot over the wire; ops
RPCs on the idempotent retry path; a stopping node's typed answer). In
place of `:346` (no XLA cache miss after warmup) the kernel extensions
build once: a second warmup, or a fresh process, builds nothing. Also
the remote cases of `tests/test_pipeline.py:412` (backpressure over the
wire, exactly once) and `tests/test_tracing.py:110`, `:178`, `:196`,
`:229` and `:275` (the trace context's wire format, the flight dump and
sidecars read by the JAX package's `ftstrace`, a trace stitched across
a real socket with a retry, and an 8-tx zkatdlog block over the wire).
Its zkatdlog block goes through the JAX ledger with host-served planes
(`torch_network_cases`), the client and its parties being the port's.
"""

import json
import os
import random
import subprocess
import sys
import threading
import time

import pytest
import torch

from torch_network_cases import HostTransferVerifier
from torch_remote_cases import PORT, REF, counter

torch.set_num_threads(1)

from fabric_token_sdk_tpu_torch.api.request import TokenRequest  # noqa: E402
from fabric_token_sdk_tpu_torch.api.validator import RequestValidator  # noqa: E402
from fabric_token_sdk_tpu_torch.drivers.fabtoken import (  # noqa: E402
    FabTokenDriver, FabTokenPublicParams,
)
from fabric_token_sdk_tpu_torch.ops import _build, warmup as wu  # noqa: E402
from fabric_token_sdk_tpu_torch.services.network import (  # noqa: E402
    BlockPolicy, LedgerServer, Network, RemoteError, RemoteNetwork,
)
from fabric_token_sdk_tpu_torch.services.network.ledger import FinalityEvent, TxStatus  # noqa: E402
from fabric_token_sdk_tpu_torch.services.network.orderer import Orderer  # noqa: E402
from fabric_token_sdk_tpu_torch.services.ttx import Party, Transaction  # noqa: E402
from fabric_token_sdk_tpu_torch.utils import faults, sysmon  # noqa: E402
from fabric_token_sdk_tpu_torch.utils import metrics as mx  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ref_mx = REF.utils_metrics


def _ref_cmd(name):
    sys.path.insert(0, os.path.join(ROOT, "cmd"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    faults.clear()


@pytest.fixture
def spans_on():
    was = mx.enabled()
    mx.enable(True)
    try:
        yield
    finally:
        mx.enable(was)


# ------------------------------------------------------------ quantiles


def _both_histograms(name, buckets, values):
    hs = (mx.Histogram(name, buckets=buckets), ref_mx.Histogram(name, buckets=buckets))
    for h in hs:
        for v in values:
            h.observe(v)
    return hs


def test_histogram_quantiles_interpolate_within_buckets():
    h, ref = _both_histograms("q.test", (1.0, 2.0, 4.0, 8.0),
                              [0.5] * 50 + [3.0] * 40 + [7.0] * 10)
    assert 0.5 <= h.quantile(0.5) <= 1.0
    assert 4.0 < h.quantile(0.95) <= 7.0
    assert h.quantile(0.99) <= 7.0
    snap = h.snapshot()
    assert snap["p50"] == pytest.approx(h.quantile(0.5))
    assert snap["p95"] == pytest.approx(h.quantile(0.95))
    assert snap["p99"] == pytest.approx(h.quantile(0.99))
    assert snap == ref.snapshot() and h.sum == ref.sum


def test_histogram_quantile_single_value_is_exact():
    h, ref = _both_histograms("q.single", (1.0, 4.0), [3.0])
    assert h.quantile(0.5) == 3.0 and h.quantile(0.99) == 3.0
    assert h.snapshot() == ref.snapshot()


def test_histogram_quantile_empty_and_inf_bucket():
    h = mx.Histogram("q.empty", buckets=(1.0,))
    assert h.quantile(0.5) is None
    assert "p50" not in h.snapshot()
    h.observe(5.0)
    h.observe(50.0)
    assert h.quantile(0.95) == 50.0
    ref = ref_mx.Histogram("q.empty", buckets=(1.0,))
    ref.observe(5.0)
    ref.observe(50.0)
    assert h.snapshot() == ref.snapshot()


def test_gauge_inc_dec_and_span_dict():
    g = mx.Gauge("g.test")
    g.inc()
    g.inc(2.5)
    g.dec()
    assert g.value == 2.5
    s = mx.Span("s", 1.0, end=2.5, attrs={"k": object()}, start_unix=3.0, trace_id="t",
                span_id="a", parent_span_id="p")
    ref = ref_mx.Span("s", 1.0, end=2.5, attrs={"k": 1}, start_unix=3.0, trace_id="t",
                      span_id="a", parent_span_id="p")
    d, rd = s.to_dict(), ref.to_dict()
    assert isinstance(d["attrs"]["k"], str)
    d["attrs"] = rd["attrs"]
    assert d == rd


# ------------------------------------------------------------ memory telemetry


def test_sysmon_host_rss_and_gauges():
    assert sysmon.host_rss_bytes() > 1024 * 1024
    s = sysmon.sample()
    assert s["rss_bytes"] > 0
    assert mx.gauge("proc.rss.bytes").value > 0
    assert mx.gauge("proc.rss.peak.bytes").value >= mx.gauge("proc.rss.bytes").value * 0


def test_sysmon_device_none_without_touching_cuda():
    """On a machine without a card, or in a process that never used it,
    sampling reports no device bytes and leaves CUDA uninitialized; the
    stage hook is throttled and keeps the host high-water gauge."""
    code = r"""
import sys, torch
from fabric_token_sdk_tpu_torch.utils import sysmon, metrics as mx
s = sysmon.sample()
assert s["device_bytes"] is None and sysmon.device_memory_bytes() is None, s
assert "device.mem.bytes" not in mx.REGISTRY.snapshot()["gauges"]
sysmon._last_stage_sample = 0.0
assert sysmon.sample_stages() is not None
assert sysmon.sample_stages() is None  # throttled inside MIN_SAMPLE_INTERVAL_S
assert mx.gauge("stages.mem.rss_high_water.bytes").value > 0
assert "stages.mem.high_water.bytes" not in mx.REGISTRY.snapshot()["gauges"]
assert not torch.cuda.is_initialized()
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr
    # without torch imported there is nothing to ask
    saved = sys.modules.pop("torch")
    try:
        assert sysmon.device_memory_bytes() is None
    finally:
        sys.modules["torch"] = saved


def test_sysmon_device_reads_every_card_when_initialized(monkeypatch):
    """With CUDA initialized the device reading is the caching
    allocator's allocated bytes summed over every visible card, and it
    feeds the device and stage high-water gauges."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: (i + 1) * 1000)
    assert sysmon.device_memory_bytes() == 3000
    monkeypatch.setattr(sysmon, "_last_stage_sample", 0.0)
    s = sysmon.sample_stages()
    assert s["device_bytes"] == 3000
    assert mx.gauge("device.mem.bytes").value == 3000
    assert mx.gauge("stages.mem.high_water.bytes").value >= 3000


def test_stage_runner_samples_memory(monkeypatch):
    """Every kernel wrapper routes through the throttled stage hook."""
    calls = []
    monkeypatch.setattr(sysmon, "sample_stages", lambda: calls.append(1))
    from fabric_token_sdk_tpu_torch.ops import stages as st

    a = torch.zeros((1, 3, 8), dtype=torch.int32)
    st.g1_add_rows(a, a)
    assert calls == [1]


# ------------------------------------------------------------ orderer gauges


def test_queue_depth_and_inflight_gauges_track_lifecycle():
    seen = {}

    def commit(batch):
        seen["depth_mid"] = mx.gauge("orderer.queue.depth").value
        seen["inflight_mid"] = ordr.inflight()
        for s in batch:
            s._resolve(FinalityEvent(s.request.anchor, TxStatus.VALID))

    ordr = Orderer(commit, BlockPolicy(max_block_txs=8))
    subs = [ordr.enqueue(TokenRequest(anchor=f"t{i}")) for i in range(3)]
    assert mx.gauge("orderer.queue.depth").value == 3
    assert ordr.inflight() == 3
    ordr.flush()
    assert seen["depth_mid"] == 0 and seen["inflight_mid"] == 3
    assert ordr.pending() == 0 and ordr.inflight() == 0
    assert mx.gauge("ledger.inflight").value == 0
    assert mx.REGISTRY.histogram("network.submit_to_finality.seconds").count >= 3
    assert all(s.done() for s in subs)
    subs[0]._resolve(FinalityEvent("t0", TxStatus.INVALID))
    assert ordr.inflight() == 0


# ------------------------------------------------------------ live node


def _node(tmp_path=None, max_block_txs=4, **client_kw):
    pp = FabTokenPublicParams()
    wal = str(tmp_path / "ledger.wal") if tmp_path is not None else None
    net = Network(RequestValidator(FabTokenDriver(pp)),
                  policy=BlockPolicy(max_block_txs=max_block_txs, min_batch=1), wal_path=wal,
                  device="cpu")
    server = LedgerServer(network=net).start()
    client = RemoteNetwork(server.address, **client_kw)
    rng = random.Random(5)
    issuer_p = Party("issuer", FabTokenDriver(pp), client, rng=rng)
    alice_p = Party("alice", FabTokenDriver(pp), client, rng=rng)
    iw = issuer_p.new_issuer_wallet("issuer")
    pp.add_issuer(iw.identity)
    alice = alice_p.new_owner_wallet("alice", anonymous=False)
    return server, client, issuer_p, alice


def _issue_requests(issuer_p, alice, n, tag="ops"):
    reqs = []
    for i in range(n):
        tx = Transaction(issuer_p, f"{tag}-{i}")
        tx.issue("issuer", "USD", [1 + i], [alice.recipient_identity()], anonymous=False)
        tx.collect_endorsements(None)
        reqs.append(tx.request.to_bytes())
    return reqs


def test_ops_rpcs_answer_live_during_slow_commits(tmp_path):
    server, client, issuer_p, alice = _node(tmp_path)
    probe = RemoteNetwork(server.address)
    delay_s, n_txs = 0.3, 8
    try:
        reqs = _issue_requests(issuer_p, alice, n_txs)
        faults.arm("ledger.commit_block", "delay", delay_s=delay_s)
        errors = []

        def submitter(chunk):
            try:
                for rb in chunk:
                    ev = client.submit(rb)
                    assert ev.status == TxStatus.VALID, ev.message
            except Exception as e:  # pragma: no cover
                errors.append(e)

        commit_h = mx.REGISTRY.histogram("ledger.block.commit.seconds")
        pre_sum, pre_count = commit_h.sum, commit_h.count
        threads = [threading.Thread(target=submitter, args=(reqs[i::2],)) for i in range(2)]
        for t in threads:
            t.start()
        probes, peak_inflight, mid_hist = [], 0, None
        while any(t.is_alive() for t in threads):
            t0 = time.monotonic()
            h = probe.ops_health()
            probes.append(time.monotonic() - t0)
            peak_inflight = max(peak_inflight, h["inflight"])
            if mid_hist is None and h["height"] >= 2:
                mid_hist = probe.ops_metrics()["histograms"].get(
                    "ledger.block.commit.seconds", {})
            time.sleep(0.02)
        for t in threads:
            t.join()
        assert not errors, errors
    finally:
        faults.clear()
        server.stop()
    assert len(probes) >= 5
    assert max(probes) < delay_s, f"health probe blocked behind a commit: {max(probes):.3f}s"
    assert peak_inflight >= 1
    assert mid_hist is not None and mid_hist.get("p95") is not None
    assert mid_hist.get("count", 0) > pre_count
    assert mid_hist.get("sum", 0.0) - pre_sum >= delay_s * 0.9
    health = server.network.health()
    assert health["txs_final"] == n_txs and health["queue_depth"] == 0
    assert health["inflight"] == 0
    assert health["wal"] is not None and health["wal"]["bytes"] > 0
    assert not health["wal"]["poisoned"]
    lb = health["last_block"]
    assert lb is not None and lb["commit_s"] >= delay_s * 0.9
    assert set(lb["breakdown"]) - {"overlap_s"} == {
        "queue_wait_max_s", "grouping_s", "device_verify_s", "sign_verify_s",
        "host_validate_s", "host_unmarshal_s", "host_fiat_shamir_s", "host_sig_verify_s",
        "host_conservation_s", "host_input_match_s", "wal_s", "merge_s",
        "host_sign_batch_s", "host_proof_batch_s", "host_conservation_batch_s",
    }


def test_ops_flight_tail_and_metrics_snapshot_over_wire(tmp_path):
    server, client, issuer_p, alice = _node(tmp_path)
    try:
        for rb in _issue_requests(issuer_p, alice, 2, tag="fl"):
            assert client.submit(rb).status == TxStatus.VALID
        kinds = {e["kind"] for e in client.ops_flight(16)}
        assert "block.commit" in kinds and "finality" in kinds
        snap = client.ops_metrics()
        assert snap["counters"]["ledger.blocks.committed"] >= 2
        h = snap["histograms"]["network.submit_to_finality.seconds"]
        assert h["count"] >= 2 and h["p95"] > 0
        assert set(snap) == set(ref_mx.REGISTRY.snapshot())  # the reference's format
        health = client.ops_health()
        assert health["uptime_s"] >= 0 and health["height"] == client.height()
        assert snap["gauges"].get("proc.rss.bytes", 0) > 0
        # a JAX client reads the port node's ops plane
        ref_client = REF.services_network_remote.RemoteNetwork(server.address)
        assert ref_client.ops_health()["height"] == 2
        assert ref_client.ops_metrics()["counters"]["ledger.blocks.committed"] >= 2
        ref_client.close()
    finally:
        server.stop()


def test_ops_metrics_serves_kernel_launch_counts(monkeypatch):
    """`ops.metrics` reads each kernel's `Kernel.launches`, the one launch
    count there is, as `kernel.launches.<name>`; a kernel never launched
    has no counter."""
    server, client, issuer_p, alice = _node()
    try:
        for k in _build.ALL_KERNELS:
            monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(_build.MILLER, "launches", 3)
        monkeypatch.setattr(_build.G1_MSM, "launches", 1)
        counters = client.ops_metrics()["counters"]
        assert {k: v for k, v in counters.items() if k.startswith("kernel.launches.")} == {
            "kernel.launches.miller": 3, "kernel.launches.g1_msm": 1}
        assert mx.REGISTRY.snapshot()["counters"].get("kernel.launches.miller") is None
    finally:
        server.stop()


def test_ops_calls_ride_idempotent_retry_path():
    server, client, issuer_p, alice = _node(retries=2, backoff_s=0.001)
    try:
        before = mx.REGISTRY.counter("remote.retry.ops.health").value
        faults.arm("remote.send", "drop", count=1)
        assert client.ops_health()["height"] == 0
        assert mx.REGISTRY.counter("remote.retry.ops.health").value == before + 1
    finally:
        faults.clear()
        server.stop()


def test_stopping_server_answers_probes_typed():
    server, client, issuer_p, alice = _node(retries=0)
    try:
        assert client.ops_health()["height"] == 0
        server._stopping.set()
        with pytest.raises(RemoteError) as ei:
            client.ops_health()
        assert ei.value.error_class == "NodeStopped"
        assert mx.REGISTRY.counter("remote.dispatch.stopped").value >= 1
    finally:
        server.stop()


# ------------------------------------------------------------ the build-once contract


def test_extensions_build_once(tmp_path, monkeypatch):
    """In place of the reference's zero-cache-miss check: warmup's build
    step compiles each kernel source at most once. A fake `nvcc` (a
    stub library copied to its `-o`) logs each compile: the first warmup
    builds all sources, a second builds none, and a fresh process
    (nothing loaded) loads every library from `_build/` and builds none."""
    stub_c = tmp_path / "stub.c"
    stub_c.write_text("int fts_stub(void) { return 0; }\n")
    stub = tmp_path / "stub.so"
    subprocess.run(["cc", "-shared", "-fPIC", "-o", str(stub), str(stub_c)], check=True)
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"""#!{sys.executable}
import shutil, sys
args = sys.argv[1:]
with open({str(log)!r}, "a") as fh:
    fh.write(args[-1] + "\\n")
shutil.copy({str(stub)!r}, args[args.index("-o") + 1])
""")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    first = wu.build_extensions()
    assert first["built"] == sorted(_build.SOURCES) == first["loaded"]
    assert len(log.read_text().splitlines()) == len(_build.SOURCES)
    assert wu.build_extensions() == {"built": [], "loaded": sorted(_build.SOURCES)}
    monkeypatch.setattr(_build, "_libs", {})  # a fresh process
    assert wu.build_extensions() == {"built": [], "loaded": sorted(_build.SOURCES)}
    assert len(log.read_text().splitlines()) == len(_build.SOURCES)


# ------------------------------------------------------------ tests/test_pipeline.py:412


def test_remote_backpressure_exactly_once_with_backoff():
    from torch_network_cases import build_both, network, policy
    from torch_network_cases import PORT as NPORT

    envs, raws = build_both("fabtoken", lambda e: [e.issue("seed", [2, 5])] + [
        e.transfer("rbp-blocker", [("seed", 0)], [2]), e.transfer("rbp-pay", [("seed", 1)], [5])])
    net = network(NPORT, envs[NPORT.root], policy=policy(NPORT, max_block_txs=8, queue_max=1))
    assert net.submit(raws[0]).status.value == "Valid"
    server = LedgerServer(network=net).start()
    client = RemoteNetwork(server.address, retries=8, backoff_s=0.05)
    try:
        blocked = net.submit_async(raws[1])
        retry_before = counter(PORT, "remote.retry.backpressure")
        valid_before = counter(PORT, "network.tx.valid")
        resub_before = counter(PORT, "network.submit.resubmissions")

        def drain_later():
            time.sleep(0.25)
            net.flush()

        t = threading.Thread(target=drain_later)
        t.start()
        event = client.submit(raws[2])
        t.join()
        assert blocked.result(timeout=10).status == TxStatus.VALID
    finally:
        client.close()
        server.stop()
    assert event.status == TxStatus.VALID
    assert counter(PORT, "remote.retry.backpressure") - retry_before >= 1
    assert counter(PORT, "network.tx.valid") - valid_before == 2
    assert counter(PORT, "network.submit.resubmissions") == resub_before
    assert net.status("rbp-pay").status == TxStatus.VALID


# ------------------------------------------------------------ tests/test_tracing.py


def test_trace_context_wire_round_trip():
    ctx = mx.new_trace()
    assert mx.TraceContext.from_wire(ctx.to_wire()) == ctx
    assert mx.TraceContext.from_wire(None) is None
    assert mx.TraceContext.from_wire([]) is None
    assert mx.TraceContext.from_wire(["t-only"]) == mx.TraceContext("t-only", "")
    # the JAX package's wire format, both ways
    assert ref_mx.TraceContext.from_wire(ctx.to_wire()).to_wire() == ctx.to_wire()


def test_flight_dump_and_ftstrace_tail(tmp_path, capsys):
    fr = mx.FlightRecorder(capacity=16)
    for i in range(5):
        fr.record("dump.check", i=i)
    path = str(tmp_path / "t.flight.json")
    assert fr.dump(path) == path
    doc = json.loads(open(path).read())
    assert doc["capacity"] == 16 and doc["pid"] == os.getpid()
    assert [e["i"] for e in doc["events"]] == list(range(5))
    ftstrace = _ref_cmd("ftstrace")
    assert ftstrace.tail(path, n=3) == 0
    out = capsys.readouterr().out
    assert "dump.check" in out and "i=4" in out and "i=0" not in out
    fr.clear()
    assert len(fr) == 0


def test_flush_sidecar_also_dumps_flight(tmp_path):
    mx.flight("sidecar.check")
    p = str(tmp_path / "x.metrics.json")
    assert mx.flush_sidecar(p) == p
    assert mx.flight_sidecar_path(p) == str(tmp_path / "x.flight.json")
    doc = json.loads(open(str(tmp_path / "x.flight.json")).read())
    assert any(e["kind"] == "sidecar.check" for e in doc["events"])
    snap = json.loads(open(p).read())
    assert set(snap) == set(ref_mx.REGISTRY.snapshot())


def _trace_spans(trace_id):
    out = []

    def walk(d):
        if d.get("trace_id") == trace_id:
            out.append(d)
        for c in d.get("children", ()):
            walk(c)

    for root in mx.REGISTRY.snapshot()["spans"]:
        walk(root)
    return out


def test_remote_trace_propagation_with_retry_after_drop(spans_on):
    server, client, issuer_p, alice = _node(max_block_txs=16, retries=3, backoff_s=0.001)
    try:
        tx = Transaction(issuer_p, "tr-mint")
        tx.issue("issuer", "USD", [9], [alice.recipient_identity()], anonymous=False)
        tx.collect_endorsements(None)
        faults.arm("remote.recv", "drop", count=1)
        event = tx.submit()
    finally:
        faults.clear()
        server.stop()
    assert event.status == TxStatus.VALID
    assert event.trace_id == tx.trace.trace_id
    names = [s["name"] for s in _trace_spans(tx.trace.trace_id)]
    for needle in ("remote.submit", "remote.server.dispatch", "network.validate",
                   "orderer.queue"):
        assert needle in names, names
    assert len([s for s in names if s in ("remote.submit.attempt",
                                          "remote.submit.recover")]) >= 2, names
    fault_evts = [e for e in mx.FLIGHT.tail()
                  if e["kind"] == "fault" and e.get("site") == "remote.recv"]
    assert fault_evts and fault_evts[-1]["trace_id"] == tx.trace.trace_id


def test_8tx_zk_block_stitched_traces_over_remote(tmp_path, capsys, spans_on):
    """8 same-shape zkatdlog transfers of the port's parties through the
    port's `RemoteNetwork.submit_many` into a JAX node (its proof plane
    host-served): one block, one batched verify, and `ftstrace` stitches
    each tx's trace from the two packages' sidecars: the port client's
    leg, the JAX node's orderer, validation, WAL and finality."""
    from fabric_token_sdk_tpu.crypto.setup import setup as ref_setup
    from fabric_token_sdk_tpu_torch.crypto.setup import setup
    from fabric_token_sdk_tpu_torch.drivers.zkatdlog import ZKATDLogDriver

    pp = setup(base=4, exponent=2, rng=random.Random(0xF75))
    ref_pp = ref_setup(base=4, exponent=2, rng=random.Random(0xF75))
    ref_zk = __import__("fabric_token_sdk_tpu.drivers.zkatdlog", fromlist=["x"])
    vdriver = ref_zk.ZKATDLogDriver(ref_pp)
    plane = HostTransferVerifier(ref_pp)
    vdriver.batch_verifier = lambda mesh=None: plane
    ref_net = REF.services_network_ledger.Network(
        REF.api_validator.RequestValidator(vdriver),
        policy=REF.services_network.BlockPolicy(max_block_txs=16, min_batch=2),
        wal_path=str(tmp_path / "zk-ledger.wal"))
    ref_was = ref_mx.enabled()
    ref_mx.enable(True)
    server = REF.services_network_remote.LedgerServer(network=ref_net).start()
    client = RemoteNetwork(server.address, timeout=600)
    rng = random.Random(9)
    issuer_p, alice_p, bob_p = (Party(n, ZKATDLogDriver(pp, device="cpu"), client, rng=rng)
                                for n in ("issuer", "alice", "bob"))
    iw = issuer_p.new_issuer_wallet("issuer")
    pp.add_issuer(iw.identity)
    ref_pp.add_issuer(iw.identity)
    alice = alice_p.new_owner_wallet("alice", anonymous=False)
    bob = bob_p.new_owner_wallet("bob", anonymous=False)
    try:
        seed = Transaction(issuer_p, "zk-seed")
        seed.issue("issuer", "USD", [5] * 8, [alice.recipient_identity()] * 8, anonymous=False)
        seed.collect_endorsements(None)
        assert seed.submit().status == TxStatus.VALID
        reqs = []
        for i in range(8):
            t = Transaction(alice_p, f"zk-pay-{i}")
            t.transfer("alice", "USD", [5], [bob.recipient_identity()])
            t.collect_endorsements(None)
            reqs.append(t.request.to_bytes())
        batched_before = ref_mx.REGISTRY.counter("ledger.validate.batched").value
        h0 = ref_net.height()
        events = client.submit_many(reqs)
    finally:
        server.stop()
        ref_mx.enable(ref_was)
    assert [e.status for e in events] == [TxStatus.VALID] * 8
    assert ref_net.height() == h0 + 1
    assert ref_mx.REGISTRY.counter("ledger.validate.batched").value - batched_before == 8
    trace_ids = [e.trace_id for e in events]
    assert all(trace_ids) and len(set(trace_ids)) == 8
    for event in events:  # the client leg in the port's registry
        assert "remote.submit" in {s["name"] for s in _trace_spans(event.trace_id)}
    commits = [e for e in ref_mx.FLIGHT.tail() if e["kind"] == "block.commit"
               and set(trace_ids) <= set(e.get("traces", ()))]
    assert len(commits) == 1 and commits[0]["txs"] == [f"zk-pay-{i}" for i in range(8)]
    assert commits[0]["device_verify_s"] > 0 and commits[0]["wal_s"] > 0
    # one stitched timeline from both sidecars (client: the port; node: JAX)
    client_side = mx.flush_sidecar(str(tmp_path / "client.metrics.json"))
    node_side = ref_mx.flush_sidecar(str(tmp_path / "node.metrics.json"))
    paths = [client_side, node_side, str(tmp_path / "client.flight.json"),
             str(tmp_path / "node.flight.json")]
    ftstrace = _ref_cmd("ftstrace")
    assert ftstrace.timeline("zk-pay-3", paths) == 0
    out = capsys.readouterr().out
    for needle in ("remote.submit", "orderer.queue", "network.validate", "critical path",
                   "device_verify", "wal", "finality"):
        assert needle in out, f"timeline missing {needle}:\n{out}"
