"""PyTorch port, the bench-result schema (`utils/benchschema.py`, a
verbatim copy) and the port's `ftstop compare` gates.

Port mirror of the 11 tests of `tests/test_bench_schema.py`: the
recorded rounds (`BENCH_r*.json`, `BENCH_history.jsonl`) and freshly
built results (the JAX package's `bench.py` builds them, full and
degraded) validate against the port's copy, which gives the JAX
package's verdicts; the scaling, state and failover gates of the port's
`ftstop` decide as the reference's.
"""

import glob
import json
import os

import bench
from fabric_token_sdk_tpu.utils import benchschema as ref_benchschema
from fabric_token_sdk_tpu_torch.cmd import ftstop
from fabric_token_sdk_tpu_torch.utils import benchschema

REPO = os.path.join(os.path.dirname(__file__), "..")


def test_recorded_bench_rounds_validate():
    """Every committed round with a parsed result (main run AND the
    default_run rider) passes the schema."""
    rounds = sorted(glob.glob(os.path.join(REPO, "BENCH_r*.json")))
    assert rounds, "no recorded bench rounds found"
    checked = 0
    for path in rounds:
        with open(path) as fh:
            doc = json.load(fh)
        for sub in (doc, doc.get("default_run") or {}):
            result = benchschema.extract_result(sub)
            if result is None:
                continue  # parsed: null rounds predate the schema
            problems = benchschema.validate_result(result)
            assert not problems, f"{path}: {problems}"
            checked += 1
    assert checked >= 2, "BENCH_r09.json should contribute two results"
    # the recorded history: every row the port's copy reads, with the
    # reference copy's verdict on each
    rows = benchschema.load_history(os.path.join(REPO, "BENCH_history.jsonl"))
    assert rows and rows == ref_benchschema.load_history(
        os.path.join(REPO, "BENCH_history.jsonl"))
    for row in rows:
        result = benchschema.extract_result(row)
        assert benchschema.validate_result(result) == ref_benchschema.validate_result(result)


def test_fresh_full_result_validates():
    r = bench.headline_result(
        rate=12.5, platform="cpu", batch=8, runs=2, warm_s=3.0,
        provegen_s=10.0, provegen_host_s=0.4, prove_txs=4, prove_rate=0.4,
        host_rate=5.0, prove_degraded=False, setup_s=0.1, stage_warmup_s=60.0,
    )
    assert benchschema.validate_result(r) == []
    assert not benchschema.is_degraded(r)
    # the enriched block-phase superset still validates
    r.update({"block_txs_per_s": 0.05, "block_vs_baseline": 0.0,
              "block_txs": 8, "block_batched_frac": 1.0,
              "block_provegen_s": 2.0, "wal_overhead_frac": 0.001})
    assert benchschema.validate_result(r) == []
    # host_rate == 0 makes prove_vs_host null — still schema-valid
    r2 = bench.headline_result(
        rate=1.0, platform="cpu", batch=1, runs=1, warm_s=0.0,
        provegen_s=0.0, provegen_host_s=0.0, prove_txs=1, prove_rate=0.0,
        host_rate=0.0, prove_degraded=True, setup_s=0.0, stage_warmup_s=0.0,
    )
    assert r2["prove_vs_host"] is None
    assert benchschema.validate_result(r2) == []


def test_fresh_degraded_result_validates():
    snap = {
        "gauges": {"bench.throughput_tx_per_s": 0.0,
                   "bench.stage_warmup_s": 291.7,
                   "bench.prove_txs_per_s": 0.013},
        "meta": {"progress.phase": "warmup_compile"},
    }
    r = bench.degraded_result("cpu", 2000.0, snap)
    assert benchschema.is_degraded(r)
    assert benchschema.validate_result(r) == []
    assert r["phase"] == "warmup_compile"
    assert r["prove_txs_per_s"] == 0.013
    # empty registry (deadline fired before any gauge existed)
    r0 = bench.degraded_result("cpu", 8.0, {})
    assert benchschema.validate_result(r0) == []
    assert r0["prove_txs_per_s"] is None  # nullable, still valid


def test_schema_rejects_malformed_results():
    assert benchschema.validate_result(None)
    assert benchschema.validate_result([1, 2])
    r = bench.degraded_result("cpu", 8.0, {})
    for key, bad in (("metric", "other"), ("unit", "s"), ("value", "fast"),
                     ("value", -1.0), ("phase", None)):
        broken = dict(r)
        broken[key] = bad
        assert benchschema.validate_result(broken), (key, bad)
    # a full result missing its required numerics is caught
    full = {k: v for k, v in _full().items() if k != "batch"}
    assert any("batch" in p for p in benchschema.validate_result(full))
    # bool where a number is expected is caught (bool IS an int subclass)
    wrong = dict(_full())
    wrong["value"] = True
    assert benchschema.validate_result(wrong)


def _full():
    return bench.headline_result(
        rate=1.0, platform="cpu", batch=1, runs=1, warm_s=0.0,
        provegen_s=0.0, provegen_host_s=0.0, prove_txs=1, prove_rate=1.0,
        host_rate=1.0, prove_degraded=False, setup_s=0.0, stage_warmup_s=0.0,
    )


def _curve(effs):
    devs = [1, 2, 4, 8][: len(effs)]
    return [
        {"n_devices": d,
         "block_txs_per_s": round(0.1 * d * effs[i], 3),
         "efficiency": effs[i]}
        for i, d in enumerate(devs)
    ]


def test_scaling_curve_schema():
    """The throughput-vs-devices curve is schema-checked per row: a
    result carrying a valid curve passes, malformed curves are named."""
    r = _full()
    r["scaling"] = _curve([1.0, 0.9, 0.8, 0.7])
    assert benchschema.validate_result(r) == []
    assert benchschema.validate_scaling(r["scaling"]) == []
    # malformed shapes are caught
    assert benchschema.validate_scaling("not-a-list")
    assert benchschema.validate_scaling([])
    assert benchschema.validate_scaling([{"n_devices": 1}])  # missing fields
    dup = _curve([1.0, 0.9])
    dup[1]["n_devices"] = 1  # not strictly increasing
    assert benchschema.validate_scaling(dup)
    bad = _curve([1.0, 0.9])
    bad[0]["efficiency"] = "fast"
    assert benchschema.validate_scaling(bad)
    # a result with a broken curve fails result validation too
    r["scaling"] = bad
    assert benchschema.validate_result(r)


def _history_with_curves(tmp_path, eff_rows):
    path = str(tmp_path / "BENCH_history.jsonl")
    for effs in eff_rows:
        r = _full()
        if effs is not None:
            r["scaling"] = _curve(effs)
        bench.append_history(r, path=path)
    return path


def test_ftstop_scaling_gate(tmp_path, capsys):
    """`ftstop compare --scaling` reads multi-device rounds from the
    history, reports per-device efficiency, and exits 1 only when
    efficiency at the max device count regresses beyond the threshold."""
    # steady efficiency -> ok (rc 0); rounds without a curve are skipped
    path = _history_with_curves(
        tmp_path, [[1.0, 0.9, 0.85, 0.8], None, [1.0, 0.9, 0.84, 0.79]]
    )
    assert ftstop.main(["compare", "--history", path, "--scaling"]) == 0
    out = capsys.readouterr().out
    assert "n_devices=8" in out and "efficiency=" in out and "OK" in out

    # >10% efficiency drop at max devices -> regression, rc 1
    os.makedirs(tmp_path / "r", exist_ok=True)
    path = _history_with_curves(
        tmp_path / "r", [[1.0, 0.9, 0.85, 0.8], [1.0, 0.88, 0.8, 0.6]]
    )
    assert ftstop.main(["compare", "--history", path, "--scaling"]) == 1
    assert "REGRESSION" in capsys.readouterr().out
    # --no-fail downgrades the exit code, not the verdict
    assert ftstop.main(
        ["compare", "--history", path, "--scaling", "--no-fail"]
    ) == 0

    # fewer than two curve-carrying rounds -> rc 2
    os.makedirs(tmp_path / "s", exist_ok=True)
    path = _history_with_curves(tmp_path / "s", [None, [1.0, 0.9]])
    assert ftstop.main(["compare", "--history", path, "--scaling"]) == 2


def _state(p99=0.002, pop=50000.0, rec=40000.0):
    return {
        "tokens": 1000000,
        "populate_s": 20.0,
        "populate_tokens_per_s": pop,
        "recover_s": 25.0,
        "recover_tokens_per_s": rec,
        "selector_p99_s": p99,
        "rss_high_water_mb": 900.0,
        "selects": 400,
        "spends": 1800,
        "threads": 4,
        "small_tokens": 10000,
        "selector_p99_small_s": 0.001,
        "sublinear_ratio": 2.0,
    }


def test_state_section_schema():
    """The state-plane scale section is field-checked like soak/scaling:
    a result carrying a valid section passes, malformed ones are named."""
    r = _full()
    r["state"] = _state()
    assert benchschema.validate_result(r) == []
    assert benchschema.validate_state(r["state"]) == []
    assert benchschema.validate_state("nope")
    assert benchschema.validate_state({})  # all required fields missing
    broken = _state()
    broken["selector_p99_s"] = "slow"
    assert benchschema.validate_state(broken)
    broken = _state()
    broken["tokens"] = -5
    assert any("negative" in p for p in benchschema.validate_state(broken))
    # nullable calibration fields stay valid as null
    ok = _state()
    ok["sublinear_ratio"] = None
    ok["selector_p99_small_s"] = None
    assert benchschema.validate_state(ok) == []
    # a result with a broken section fails result validation too
    r["state"] = broken
    assert benchschema.validate_result(r)


def _history_with_states(tmp_path, states):
    path = str(tmp_path / "BENCH_history.jsonl")
    for s in states:
        r = _full()
        if s is not None:
            r["state"] = s
        bench.append_history(r, path=path)
    return path


def test_ftstop_state_gate(tmp_path, capsys):
    """`ftstop compare --state` gates selector p99 (growth) and
    populate/recover throughput (drop) against the median of prior
    state-carrying rounds: rc 0 steady, rc 1 on regression, rc 2 when
    fewer than two rounds carry the section."""
    # steady numbers -> ok; state-less rounds are skipped
    path = _history_with_states(
        tmp_path, [_state(), None, _state(p99=0.0021)]
    )
    assert ftstop.main(["compare", "--history", path, "--state"]) == 0
    out = capsys.readouterr().out
    assert "state plane" in out and "selector_p99" in out and "OK" in out

    # p99 grows >10% -> regression rc 1 (direction-aware: growth is bad)
    os.makedirs(tmp_path / "p", exist_ok=True)
    path = _history_with_states(tmp_path / "p", [_state(), _state(p99=0.01)])
    assert ftstop.main(["compare", "--history", path, "--state"]) == 1
    assert "REGRESSION" in capsys.readouterr().out
    assert ftstop.main(
        ["compare", "--history", path, "--state", "--no-fail"]
    ) == 0

    # recover throughput drops >10% -> regression too
    os.makedirs(tmp_path / "r", exist_ok=True)
    path = _history_with_states(tmp_path / "r", [_state(), _state(rec=1000.0)])
    assert ftstop.main(["compare", "--history", path, "--state"]) == 1

    # improvements never fail the gate
    os.makedirs(tmp_path / "i", exist_ok=True)
    path = _history_with_states(
        tmp_path / "i", [_state(), _state(p99=0.0001, pop=99999.0)]
    )
    assert ftstop.main(["compare", "--history", path, "--state"]) == 0

    # fewer than two state-carrying rounds -> rc 2
    os.makedirs(tmp_path / "s", exist_ok=True)
    path = _history_with_states(tmp_path / "s", [None, _state()])
    assert ftstop.main(["compare", "--history", path, "--state"]) == 2


def test_history_roundtrip_with_torn_tail(tmp_path):
    path = str(tmp_path / "BENCH_history.jsonl")
    assert bench.append_history(_full(), path=path) == path
    assert bench.append_history(
        bench.degraded_result("cpu", 8.0, {}), path=path
    ) == path
    with open(path, "a") as fh:
        fh.write('{"torn": ')  # crash mid-append
    rows = benchschema.load_history(path)
    assert len(rows) == 2  # torn tail skipped, like the WAL
    for row in rows:
        assert "ts" in row
        assert benchschema.validate_result(row) == []
    assert benchschema.is_degraded(rows[1]) and not benchschema.is_degraded(rows[0])

def _failover(loss=0, dups=0, p99=0.4, lag=3):
    return {
        "acked_tx_loss": loss,
        "duplicate_commits": dups,
        "failover_p99_s": p99,
        "follower_lag_max": lag,
        "acked_txs": 40,
        "killed_at_s": 6.0,
        "promoted_epoch": 1,
        "promotion": "auto",
        "failover_switches": 1,
        "stale_rejected": 2,
    }


def test_failover_section_schema():
    """The kill-the-leader soak section is field-checked like state/
    scaling: valid sections pass, malformed ones are named, and the
    contract fields reject negatives and bool-as-int."""
    r = _full()
    r["failover"] = _failover()
    assert benchschema.validate_result(r) == []
    assert benchschema.validate_failover(r["failover"]) == []
    assert benchschema.validate_failover("nope")
    assert benchschema.validate_failover({})  # required fields missing
    # p99 is nullable (no post-kill acks recorded -> null, still valid)
    ok = _failover()
    ok["failover_p99_s"] = None
    assert benchschema.validate_failover(ok) == []
    broken = _failover()
    broken["acked_tx_loss"] = -1
    assert any("negative" in p
               for p in benchschema.validate_failover(broken))
    broken = _failover()
    broken["duplicate_commits"] = True  # bool IS an int subclass
    assert benchschema.validate_failover(broken)
    broken = _failover()
    broken["follower_lag_max"] = "high"
    assert benchschema.validate_failover(broken)
    # a result with a broken section fails result validation too
    r["failover"] = broken
    assert benchschema.validate_result(r)


def _history_with_failovers(tmp_path, sections):
    path = str(tmp_path / "BENCH_history.jsonl")
    for s in sections:
        r = _full()
        if s is not None:
            r["failover"] = s
        bench.append_history(r, path=path)
    return path


def test_ftstop_failover_gate(tmp_path, capsys):
    """`ftstop compare --failover` layers an ABSOLUTE zero-tolerance
    check over the median gate: any nonzero acked_tx_loss or
    duplicate_commits in the latest round fails, even when every prior
    round was also zero (the rel-to-zero-baseline blind spot)."""
    # clean soaks -> ok; failover-less rounds are skipped
    path = _history_with_failovers(
        tmp_path, [_failover(), None, _failover(p99=0.42)]
    )
    assert ftstop.main(["compare", "--history", path, "--failover"]) == 0
    out = capsys.readouterr().out
    assert "failover" in out and "acked_tx_loss" in out and "OK" in out

    # zero-loss baseline, latest loses one acked tx: the relative gate
    # sees 0 -> 1 as rel 0.0, the absolute layer still fails it
    os.makedirs(tmp_path / "z", exist_ok=True)
    path = _history_with_failovers(
        tmp_path / "z", [_failover(), _failover(loss=1)]
    )
    assert ftstop.main(["compare", "--history", path, "--failover"]) == 1
    assert "absolute" in capsys.readouterr().out
    assert ftstop.main(
        ["compare", "--history", path, "--failover", "--no-fail"]
    ) == 0

    # duplicate commits are equally disqualifying
    os.makedirs(tmp_path / "d", exist_ok=True)
    path = _history_with_failovers(
        tmp_path / "d", [_failover(), _failover(dups=2)]
    )
    assert ftstop.main(["compare", "--history", path, "--failover"]) == 1

    # failover p99 growth beyond the threshold trips the median gate
    os.makedirs(tmp_path / "p", exist_ok=True)
    path = _history_with_failovers(
        tmp_path / "p", [_failover(), _failover(p99=5.0)]
    )
    assert ftstop.main(["compare", "--history", path, "--failover"]) == 1

    # fewer than two failover-carrying rounds -> rc 2
    os.makedirs(tmp_path / "s", exist_ok=True)
    path = _history_with_failovers(tmp_path / "s", [None, _failover()])
    assert ftstop.main(["compare", "--history", path, "--failover"]) == 2
