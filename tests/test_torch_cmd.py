"""PyTorch port, the operator tools (`fabric_token_sdk_tpu_torch/cmd/`
`ftsmetrics`, `ftstop`, `ftstrace`, `tokengen`) and the metrics core's
Prometheus export, against the JAX package's.

Mirrors of `tests/test_metrics.py:162` (`ftsmetrics` show and diff, the
phase timeline), `tests/test_ops_plane.py:83` (the quantile series),
`:428-491` (the three `ftstop compare` tests), `:500` (the ops summary
line), `:529` (`ftstop top` against a live node) and
`tests/test_extras.py:137` (`tokengen`). Also: `to_prometheus` text
byte-identical across packages for the same registry operations;
`ftstop top` and `devices` against a live port node and a JAX one; the
two packages' `format_devices` on one port health dict; `ftstrace`
`timeline`, `export`, `tail`, `flame` and `devices` over port sidecars;
`tokengen` artifacts byte-identical across packages for one seed;
`Heartbeat` phases in the snapshot.
"""

import io
import json
import os
import random
import sys

import pytest
import torch

from torch_remote_cases import PORT, REF

torch.set_num_threads(1)

from fabric_token_sdk_tpu_torch.cmd import ftsmetrics, ftstop, ftstrace, tokengen  # noqa: E402
from fabric_token_sdk_tpu_torch.drivers.fabtoken import (  # noqa: E402
    FabTokenDriver, FabTokenPublicParams,
)
from fabric_token_sdk_tpu_torch.services.network import RemoteNetwork  # noqa: E402
from fabric_token_sdk_tpu_torch.services.network.ledger import TxStatus  # noqa: E402
from fabric_token_sdk_tpu_torch.services.ttx import Party, Transaction  # noqa: E402
from fabric_token_sdk_tpu_torch.utils import devobs  # noqa: E402
from fabric_token_sdk_tpu_torch.utils import metrics as mx  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ref_mx = REF.utils_metrics


def _ref_cmd(name):
    sys.path.insert(0, os.path.join(ROOT, "cmd"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


@pytest.fixture
def spans_on():
    was = mx.enabled()
    mx.enable(True)
    try:
        yield
    finally:
        mx.enable(was)


def _node(P=PORT, tmp_path=None, sign_plane=False):
    """Package P's fabtoken node (the port's on the CPU) and a port
    client with an issuer party; `sign_plane` sends a block's issuer
    signatures through the sign plane (the port's plain versions)."""
    pp = P.drivers_fabtoken.FabTokenPublicParams()
    wal = str(tmp_path / "ledger.wal") if tmp_path is not None else None
    kw = {"device": "cpu"} if P is PORT else {}
    policy = P.services_network.BlockPolicy(
        max_block_txs=4, min_batch=1,
        **({"sign_batched": True, "sign_min_batch": 2} if sign_plane else {}))
    net = P.services_network_ledger.Network(
        P.api_validator.RequestValidator(P.drivers_fabtoken.FabTokenDriver(pp)),
        policy=policy, wal_path=wal, **kw)
    server = P.services_network_remote.LedgerServer(network=net).start()
    client = RemoteNetwork(server.address)
    rng = random.Random(5)
    port_pp = FabTokenPublicParams()
    issuer_p = Party("issuer", FabTokenDriver(port_pp), client, rng=rng)
    alice_p = Party("alice", FabTokenDriver(port_pp), client, rng=rng)
    iw = issuer_p.new_issuer_wallet("issuer")
    pp.add_issuer(iw.identity)
    port_pp.add_issuer(iw.identity)
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


def _addr(server):
    host, port = server.address
    return f"{host}:{port}"


# ------------------------------------------------------------ Prometheus export


def _registry_ops(R):
    R.counter("jax.cache.load_failures").inc(3)
    R.counter("ledger.blocks.committed").inc(7)
    R.gauge("vault.tokens.held").set(12)
    R.gauge("proc.rss.bytes").set(1.5e8)
    R.gauge("0weird-name").set(0.25)
    h = R.histogram("verify.seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 50.0):
        h.observe(v)
    q = R.histogram("ops.check.seconds")
    q.observe(0.2)
    q.observe(0.4)
    R.histogram("empty.seconds")


def test_prometheus_text_byte_identical_across_packages():
    """The same registry operations give the same exposition text in both
    packages: counters, gauges, cumulative buckets, sums, counts and the
    p50/p95/p99 series."""
    port, ref = mx.Registry(), ref_mx.Registry()
    _registry_ops(port)
    _registry_ops(ref)
    text = port.to_prometheus()
    assert text == ref.to_prometheus()
    assert "# TYPE fts_jax_cache_load_failures counter" in text
    assert "fts_vault_tokens_held 12" in text
    assert "fts__0weird_name 0.25" in text
    assert 'fts_verify_seconds_bucket{le="0.1"} 1' in text
    assert 'fts_verify_seconds_bucket{le="1"} 2' in text
    assert 'fts_verify_seconds_bucket{le="+Inf"} 3' in text
    assert "fts_verify_seconds_count 3" in text
    for q in ("p50", "p95", "p99"):  # tests/test_ops_plane.py:83
        assert f"fts_ops_check_seconds_{q} " in text
    assert "fts_empty_seconds_count 0" in text and "fts_empty_seconds_p50" not in text
    assert mx._prom_name("a.b-c") == ref_mx._prom_name("a.b-c") == "fts_a_b_c"
    assert mx._prom_num(2.0) == "2" and mx._prom_num(0.5) == "0.5"


# ------------------------------------------------------------ ftsmetrics


def test_ftsmetrics_cli_show_and_diff(tmp_path, capsys):
    reg = mx.Registry()
    reg.counter("network.tx.valid").inc(7)
    reg.record_phase("setup", 0.0, 1.25)
    h = reg.histogram("compile.seconds", buckets=(1.0, 10.0))
    h.observe(0.5)
    h.observe(30.0)
    a = tmp_path / "a.metrics.json"
    a.write_text(reg.to_json())
    reg.counter("network.tx.valid").inc(3)
    b = tmp_path / "b.metrics.json"
    b.write_text(reg.to_json())

    assert ftsmetrics.main(["show", str(a)]) == 0
    out = capsys.readouterr().out
    assert "network.tx.valid" in out and "setup" in out and "1.2s" in out
    ftsmetrics.diff(str(a), str(b))
    out = capsys.readouterr().out
    assert "7 -> 10" in out and "phases[old]: setup=1.2s" in out
    ftsmetrics.show(str(a), prometheus=True)
    out = capsys.readouterr().out
    assert 'fts_compile_seconds_bucket{le="1"} 1' in out
    assert 'fts_compile_seconds_bucket{le="+Inf"} 2' in out
    assert "fts_compile_seconds_count 2" in out
    # the JAX package's tool prints the same for the same sidecars
    ref_tool = _ref_cmd("ftsmetrics")
    for call in (lambda t: t.show(str(a)), lambda t: t.show(str(a), prometheus=True),
                 lambda t: t.diff(str(a), str(b))):
        call(ftsmetrics)
        mine = capsys.readouterr().out
        call(ref_tool)
        assert capsys.readouterr().out == mine


def test_ftsmetrics_show_prints_ops_summary(tmp_path, capsys):
    reg = mx.Registry()
    reg.gauge("orderer.queue.depth").set(3)
    reg.gauge("ledger.inflight").set(5)
    reg.gauge("proc.rss.peak.bytes").set(123e6)
    reg.gauge("stages.mem.high_water.bytes").set(45e6)
    h = reg.histogram("ledger.block.commit.seconds")
    h.observe(0.3)
    h.observe(0.5)
    reg.histogram("network.submit_to_finality.seconds").observe(0.31)
    path = tmp_path / "ops.metrics.json"
    path.write_text(reg.to_json())
    ftsmetrics.show(str(path))
    out = capsys.readouterr().out
    assert "ops summary:" in out
    assert "queue_depth=3" in out and "inflight=5" in out
    assert "rss_peak=123.0MB" in out and "dev_mem_hw=45.0MB" in out
    assert "block_commit[p50/p95/p99]=" in out
    assert "finality[p50/p95/p99]=310.0ms/310.0ms/310.0ms" in out


def test_heartbeat_records_phases(spans_on):
    """`Heartbeat` stamps each completed phase into the snapshot's
    timeline (with the RSS it ended at) and prints phase lines."""
    stream = io.StringIO()
    n0 = len(mx.REGISTRY.snapshot()["phases"])
    hb = mx.Heartbeat(tag="fts-test", interval_s=3600.0, stream=stream).start()
    hb.set_phase("warmup", programs=15)
    hb.set_phase("serve")
    hb.stop()
    phases = mx.REGISTRY.snapshot()["phases"][n0:]
    assert [p["name"] for p in phases] == ["init", "warmup", "serve"]
    assert phases[1]["attrs"]["programs"] == 15 and phases[1]["attrs"]["rss_mb"] > 0
    assert all(p["elapsed_s"] >= 0 for p in phases)
    assert "[fts-test] phase=warmup programs=15 elapsed=" in stream.getvalue()
    assert mx.REGISTRY.meta()["progress.phase"] == "serve"
    assert any(e["kind"] == "phase" and e["phase"] == "serve" for e in mx.FLIGHT.tail(20))


# ------------------------------------------------------------ ftstop top / devices


@pytest.mark.parametrize("P", [PORT, REF], ids=["port-node", "jax-node"])
def test_ftstop_top_renders_live_rows(P, tmp_path, capsys):
    server, client, issuer_p, alice = _node(P, tmp_path)
    try:
        for rb in _issue_requests(issuer_p, alice, 2, tag="top"):
            assert client.submit(rb).status == TxStatus.VALID
        rc = ftstop.top(_addr(server), interval=0.05, count=2)
        assert ftstop.main(["top", _addr(server), "--once"]) == 0
    finally:
        client.close()
        server.stop()
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line.strip()]
    assert rc == 0 and len(lines) == 3
    assert "height=2" in lines[0]
    assert "p95.commit=" in lines[0]
    assert "tx/s=" in lines[1] and "wal=" in lines[0]
    row = ftstop.format_row({"uptime_s": 1.0, "height": 3}, {}, None, None)
    assert "height=3" in row


@pytest.mark.parametrize("P", [PORT, REF], ids=["port-node", "jax-node"])
def test_ftstop_devices_renders_live_table(P, capsys):
    """Against a port node whose block's two issuer signatures took the
    sign plane's plain versions: one row a program, its dispatches and
    times; against a JAX node (no dispatch): the header alone."""
    devobs.reset()
    server, client, issuer_p, alice = _node(P, sign_plane=(P is PORT))
    try:
        events = client.submit_many(_issue_requests(issuer_p, alice, 2, tag="dev"))
        assert [e.status for e in events] == [TxStatus.VALID] * 2
        assert ftstop.main(["devices", _addr(server), "--once"]) == 0
        health = client.ops_health()
    finally:
        client.close()
        server.stop()
        devobs.reset()
    out = capsys.readouterr().out
    if P is REF:
        assert out.strip().startswith("planes:")
        return
    lines = out.strip().splitlines()
    assert lines[0].startswith("planes: sign[n=3 occ=100.0% waste=0.0%]")
    assert lines[1].split()[:3] == ["plane", "program", "disp"]
    rows = {line.split()[1]: line.split() for line in lines[2:]}
    assert set(rows) == {"g1_msm", "g1_mul", "g1_addsub"}
    assert all(r[0] == "sign" and r[2] == "1" for r in rows.values())
    assert health["device"]["name"] == "cpu"
    # the JAX package's renderer gives the same text for the port's dict
    assert _ref_cmd("ftstop").format_devices(health) == ftstop.format_devices(health)
    assert ftstop.format_devices({}) == "devices: node predates the dispatch ledger"


# ------------------------------------------------------------ ftstop compare


def _full_record(**over):
    import bench

    r = bench.headline_result(
        rate=100.0, platform="cpu", batch=8, runs=1, warm_s=1.0,
        provegen_s=2.0, provegen_host_s=0.5, prove_txs=4, prove_rate=2.0,
        host_rate=1.0, prove_degraded=False, setup_s=0.1, stage_warmup_s=5.0,
    )
    r.update({"block_txs_per_s": 50.0, "block_vs_baseline": 0.376,
              "block_txs": 8, "block_batched_frac": 1.0,
              "block_provegen_s": 1.0, "wal_overhead_frac": 0.01})
    r.update(over)
    return r


def test_ftstop_compare_flags_injected_regression(tmp_path, capsys):
    old = _full_record()
    new = _full_record(value=55.0, block_txs_per_s=55.0)
    a, b = tmp_path / "old.json", tmp_path / "new.json"
    a.write_text(json.dumps(old))
    b.write_text(json.dumps(new))
    rc = ftstop.main(["compare", str(a), str(b), "--threshold", "0.1"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "REGRESSION" in out and "value" in out
    vmap = {v["metric"]: v["verdict"] for v in ftstop.compare_records(old, new, 0.1)}
    assert vmap["value"] == "regression"
    assert vmap["wal_overhead_frac"] == "ok"
    vmap = {v["metric"]: v["verdict"] for v in ftstop.compare_records(
        old, _full_record(value=150.0, stage_warmup_s=50.0), 0.1)}
    assert vmap["value"] == "improvement"
    assert vmap["stage_warmup_s"] == "regression"
    c = tmp_path / "same.json"
    c.write_text(json.dumps(_full_record(value=99.0)))
    assert ftstop.main(["compare", str(a), str(c)]) == 0


def test_ftstop_compare_history_median_baseline(tmp_path, capsys):
    import bench

    hist = tmp_path / "BENCH_history.jsonl"
    for _ in range(2):
        bench.append_history(bench.degraded_result("cpu", 2000.0, {}), path=str(hist))
    for v in (100.0, 110.0, 90.0):
        bench.append_history(_full_record(value=v), path=str(hist))
    bench.append_history(_full_record(value=40.0), path=str(hist))
    hist.write_text(hist.read_text() + "{torn\n")
    rc = ftstop.main(["compare", "--history", str(hist)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "median(3 prior full rounds)" in out
    assert "REGRESSION" in out
    assert ftstop.main(["compare", "--history", str(hist), "--no-fail"]) == 0
    capsys.readouterr()
    short = tmp_path / "short.jsonl"
    bench.append_history(bench.degraded_result("cpu", 8.0, {}), path=str(short))
    bench.append_history(_full_record(), path=str(short))
    assert ftstop.main(["compare", "--history", str(short)]) == 2


def test_ftstop_compare_rejects_schema_invalid_records(tmp_path):
    a = tmp_path / "bad.json"
    a.write_text(json.dumps({"metric": "wrong_name", "value": "NaN"}))
    b = tmp_path / "good.json"
    b.write_text(json.dumps(_full_record()))
    assert ftstop.main(["compare", str(a), str(b)]) == 2


def test_ftstop_compare_device_slo_and_soak_gates(tmp_path, capsys):
    """The history modes the bench-schema mirror does not cover: the
    device gate on the ledger's own `section()`, the absolute SLO
    verdict and the soak gate, each as the JAX package's tool decides."""
    import bench

    devobs.reset()
    with devobs.plane("verify"):
        with devobs.dispatch("g1_msm", rows=6, padded_rows=2):
            pass
    good = devobs.section()
    devobs.reset()
    worse = dict(good, occupancy=0.3, waste_frac=0.7)
    slo_ok = {"window_s": 60.0, "slos": {"finality_p99": {
        "ok": True, "objective": 0.99, "burn": 0.1, "budget_remaining": 0.9, "total": 10}}}
    slo_bad = {"window_s": 60.0, "slos": {"finality_p99": {
        "ok": False, "objective": 0.99, "burn": 3.0, "budget_remaining": -2.0, "total": 10}}}
    soak = {"steady_txs_per_s": 10.0, "p99_finality_s": 0.5, "queue_depth_max": 3,
            "backpressure_rejects": 0}
    hist = tmp_path / "h.jsonl"
    for extra in ({"device": good, "slo": slo_ok, "soak": soak},
                  {"device": good, "slo": slo_ok, "soak": soak},
                  {"device": worse, "slo": slo_bad,
                   "soak": dict(soak, steady_txs_per_s=5.0)}):
        bench.append_history(_full_record(**extra), path=str(hist))
    ref_tool = _ref_cmd("ftstop")
    for mode, rc in (("--device", 1), ("--slo", 1), ("--soak", 1), ("--host", 2),
                     ("--failover", 2), ("--state", 2), ("--scaling", 2)):
        assert ftstop.main(["compare", "--history", str(hist), mode]) == rc, mode
        mine = capsys.readouterr()
        assert ref_tool.main(["compare", "--history", str(hist), mode]) == rc, mode
        assert capsys.readouterr() == mine, mode


# ------------------------------------------------------------ ftstrace over port sidecars


def test_ftstrace_over_port_sidecars(tmp_path, capsys, spans_on):
    """A port node and a port client (one process, one registry): the
    sidecar the process flushes stitches the tx's timeline (client
    submit, orderer queue, validation, the block's critical path, WAL,
    finality); `export` writes Chrome trace events, `tail` reads the
    flight ring, `devices` renders a recorded device section (from a
    result JSON and a history file), `flame` a recorded profile; every
    one as the JAX package's tool prints it."""
    import bench

    server, client, issuer_p, alice = _node(PORT, tmp_path)
    try:
        tx = Transaction(issuer_p, "trace-me")
        tx.issue("issuer", "USD", [9], [alice.recipient_identity()], anonymous=False)
        tx.collect_endorsements(None)
        assert tx.submit().status == TxStatus.VALID
    finally:
        client.close()
        server.stop()
    side = mx.flush_sidecar(str(tmp_path / "node.metrics.json"))
    flight = str(tmp_path / "node.flight.json")
    ref_tool = _ref_cmd("ftstrace")
    assert ftstrace.main(["timeline", "trace-me", side, flight]) == 0
    out = capsys.readouterr().out
    for needle in ("remote.submit", "orderer.queue", "network.validate", "critical path",
                   "wal", "finality"):
        assert needle in out, f"timeline missing {needle}:\n{out}"
    assert ref_tool.timeline("trace-me", [side, flight]) == 0
    assert capsys.readouterr().out == out
    assert ftstrace.main(["timeline", "no-such-tx", side]) == 1
    capsys.readouterr()

    chrome = tmp_path / "trace.json"
    assert ftstrace.main(["export", "-o", str(chrome), side, flight]) == 0
    doc = json.loads(chrome.read_text())
    assert any(e["ph"] == "X" for e in doc["traceEvents"])
    assert any(e["ph"] == "M" for e in doc["traceEvents"])
    capsys.readouterr()
    assert ftstrace.main(["tail", "-n", "3", flight]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"== {flight}:") and len(out.strip().splitlines()) == 4

    devobs.reset()
    with devobs.plane("verify"):
        with devobs.dispatch("miller", rows=4):
            pass
    with devobs.plane("sign"):
        with devobs.dispatch("g1_mul", rows=2):
            pass
    result = _full_record(device=devobs.section(),
                          profile={"hz": 100, "samples": 4, "host_legs": {},
                                   "stacks": {"commit-worker;a:f;b:g": 3, "client;c:h": 1}})
    devobs.reset()
    res = tmp_path / "result.json"
    res.write_text(json.dumps(result))
    hist = tmp_path / "h.jsonl"
    bench.append_history(result, path=str(hist))
    for args, rc in ((["devices", str(res)], 0), (["devices", str(hist)], 0),
                     (["devices", "--plane", "sign", str(res)], 0),
                     (["devices", "--plane", "nope", str(res)], 1),
                     (["flame", str(res)], 0), (["flame", "--role", "client", str(hist)], 0),
                     (["flame", "--role", "nope", str(res)], 1)):
        assert ftstrace.main(args) == rc, args
        mine = capsys.readouterr()
        assert ref_tool.main(args) == rc, args
        assert capsys.readouterr() == mine, args
    ftstrace.main(["devices", "--plane", "sign", str(res)])
    out = capsys.readouterr().out
    assert "g1_mul" in out and "miller" not in out


# ------------------------------------------------------------ tokengen


def test_tokengen_cli(tmp_path):
    out = str(tmp_path / "arts")
    tokengen.main(["gen", "fabtoken", "--output", out, "--issuers", "2", "--auditor",
                   "--seed", "7"])
    raw = open(f"{out}/fabtoken_pp.json", "rb").read()
    pp = FabTokenPublicParams.deserialize(raw)
    assert len(pp.issuers) == 2 and pp.auditor
    out2 = str(tmp_path / "arts2")
    tokengen.main(["gen", "dlog", "--output", out2, "--base", "2", "--exponent", "1",
                   "--seed", "7"])
    from fabric_token_sdk_tpu_torch.crypto.setup import PublicParams

    pp2 = PublicParams.deserialize(open(f"{out2}/zkatdlog_pp.json", "rb").read())
    pp2.validate()


@pytest.mark.parametrize("driver", ["fabtoken", "dlog"])
def test_tokengen_artifacts_byte_identical_across_packages(driver, tmp_path, capsys):
    """For one `--seed` the port's tool writes the JAX package's bytes,
    file for file, and prints the same lines."""
    ref_tool = _ref_cmd("tokengen")
    outs = {}
    for name, tool in (("port", tokengen), ("ref", ref_tool)):
        d = tmp_path / name
        args = ["gen", driver, "--output", str(d), "--issuers", "2", "--owners", "2",
                "--auditor", "--seed", "11"]
        if driver == "dlog":
            args += ["--base", "4", "--exponent", "2"]
        tool.main(args)
        printed = capsys.readouterr().out.replace(str(d), "DIR")
        files = {os.path.relpath(os.path.join(r, f), d): open(os.path.join(r, f), "rb").read()
                 for r, _, fs in os.walk(d) for f in fs}
        outs[name] = (printed, files)
    assert outs["port"] == outs["ref"]
    assert len(outs["port"][1]) == 6
