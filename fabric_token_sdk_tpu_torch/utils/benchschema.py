"""One shared schema for the bench result JSON.

`bench.py` emits a headline result line (optionally superseded by an
enriched block-phase line), or a DEGRADED result when the internal
deadline fires; every outcome is also appended to `BENCH_history.jsonl`.
Three consumers must agree on that shape — the driver's parser, the
perf-regression observatory (`cmd/ftstop.py compare`), and the bench
rounds recorded as `BENCH_r*.json` — so the schema lives HERE, once,
and `tests/test_bench_schema.py` validates both the recorded rounds and
freshly built results against it. A round that fails this schema is a
bug in bench.py, not in the round.
"""

from __future__ import annotations

import json
from typing import List, Optional

METRIC_NAME = "zkatdlog_transfer_verify_throughput"
UNIT = "tx/s"

_NUM = (int, float)

# present in EVERY result (full, enriched, degraded)
HEADLINE_REQUIRED = {
    "metric": str,
    "value": _NUM,
    "unit": str,
    "vs_baseline": _NUM,
    "platform": str,
}

# present only in a full (non-degraded) result
FULL_REQUIRED = {
    "batch": int,
    "runs": int,
    "warmup_s": _NUM,
    "provegen_s": _NUM,
    "provegen_host_s": _NUM,
    "prove_txs": int,
    "prove_txs_per_s": _NUM,
    "prove_degraded": bool,
    "setup_s": _NUM,
    "stage_warmup_s": _NUM,
}

# present only in a degraded (deadline-fired) result
DEGRADED_REQUIRED = {
    "degraded": bool,
    "deadline_s": _NUM,
    "phase": str,
}

# type-checked when present; a tuple including NoneType allows null
_NULLABLE_NUM = _NUM + (type(None),)
OPTIONAL = {
    "prove_vs_host": _NULLABLE_NUM,
    "prove_txs_per_s": _NULLABLE_NUM,  # nullable in the degraded form
    "stage_warmup_s": _NUM,
    "block_txs_per_s": _NUM,
    "block_vs_baseline": _NUM,
    "block_txs": int,
    "block_batched_frac": _NUM,
    "block_provegen_s": _NUM,
    "wal_overhead_frac": _NUM,
    "scaling": list,  # throughput-vs-devices curve (validated per row)
    "soak": dict,  # sustained-load soak section (validated per field)
    "state": dict,  # state-plane scale section (validated per field)
    "profile": dict,  # host-path profiler section (validated per field)
    "slo": dict,  # error-budget section (validated per field)
    "device": dict,  # device-plane dispatch ledger (validated per field)
    "host": dict,  # batch-first host-validation section (per field)
    "failover": dict,  # kill-the-leader chaos-soak section (per field)
    "ts": _NUM,  # history-line stamp added by bench.append_history
}

# the sustained-load soak section (`soak` field): steady-state tx/s of
# the whole streaming engine under N concurrent clients, CLIENT-observed
# p99 finality (null when the run committed nothing), the queue-depth
# high-water (bounded by FTS_BENCH_SOAK_QUEUE_MAX admission control by
# construction), and how many submissions backpressure rejected
SOAK_REQUIRED = {
    "steady_txs_per_s": _NUM,
    "p99_finality_s": _NULLABLE_NUM,
    "queue_depth_max": _NUM,
    "backpressure_rejects": int,
}

# type-checked when present in a soak section (older rounds predate
# them, so they must stay OPTIONAL or the gate would drop its own
# baseline): which driver drove the corpus, what the batched signature
# plane actually DID ("device" = rows rode the device plane,
# "degraded" = enabled but every row fell back to host, "host" = off),
# the host_validate leg's fraction of block commit wall time, the
# batch.sign.* counter deltas, and the identity parse-cache hit rate
# over the soak window
SOAK_OPTIONAL = {
    "driver": str,
    "sign_plane": str,
    "host_validate_frac": _NULLABLE_NUM,
    "sign_rows": int,
    "sign_host": int,
    "sign_fallbacks": int,
    "identity_cache_hit_rate": _NULLABLE_NUM,
    # resilience accounting (rounds predating the chaos-soak mode omit
    # them): how many faults the chaos monkey landed
    # (`FTS_BENCH_SOAK_FAULTS=1`, else 0), how many times a circuit
    # breaker OPENED during the window, and how many device planes saw
    # at least one host fallback — the proof the node degraded AND
    # stayed live rather than stalling
    "faults_injected": int,
    "breaker_trips": int,
    "degraded_planes": int,
}


def validate_soak(soak) -> List[str]:
    """Schema problems of one `soak` section (empty list = valid)."""
    if not isinstance(soak, dict):
        return [f"soak is {type(soak).__name__}, expected object"]
    problems: List[str] = []
    _check(problems, soak, SOAK_REQUIRED, required=True)
    _check(problems, soak, SOAK_OPTIONAL, required=False)
    v = soak.get("steady_txs_per_s")
    if isinstance(v, _NUM) and not isinstance(v, bool) and v < 0:
        problems.append("soak.steady_txs_per_s is negative")
    return problems

# the batch-first host-validation section (`host` field, recorded by
# the soak phase and gated by `ftstop compare --host`): per-leg
# EXCLUSIVE seconds the sub-leg timers collected over the soak window
# (the scalar tail after the block-level batch passes), the host-leg
# fraction of block commit wall, and the batch-pass/cache counters that
# explain where the per-tx work went
HOST_REQUIRED = {
    "unmarshal_s": _NUM,
    "fiat_shamir_s": _NUM,
    "sig_verify_s": _NUM,
    "conservation_s": _NUM,
    "input_match_s": _NUM,
    "host_validate_frac": _NULLABLE_NUM,
}

HOST_OPTIONAL = {
    # per-block p99 of the named host legs over the window (null when
    # no block ran the leg)
    "unmarshal_p99_s": _NULLABLE_NUM,
    "fiat_shamir_p99_s": _NULLABLE_NUM,
    # wall spent inside the block-level batch passes (outside the legs)
    "sign_batch_s": _NUM,
    "proof_batch_s": _NUM,
    "conservation_batch_s": _NUM,
    # rows those passes decided (hostbatch.* counter deltas)
    "sign_batch_rows": int,
    "proof_batch_rows": int,
    "conservation_rows": int,
    # parse-cache effectiveness over the window (null when cold/disabled)
    "request_cache_hit_rate": _NULLABLE_NUM,
    "parse_cache_hit_rate": _NULLABLE_NUM,
    # resolved FTS_COMMIT_WORKERS pool size the window ran with
    "workers": int,
}


def validate_host(host) -> List[str]:
    """Schema problems of one `host` section (empty list = valid)."""
    if not isinstance(host, dict):
        return [f"host is {type(host).__name__}, expected object"]
    problems: List[str] = []
    _check(problems, host, HOST_REQUIRED, required=True)
    _check(problems, host, HOST_OPTIONAL, required=False)
    for key in HOST_REQUIRED:
        v = host.get(key)
        if isinstance(v, _NUM) and not isinstance(v, bool) and v < 0:
            problems.append(f"host.{key} is negative")
    for key in ("request_cache_hit_rate", "parse_cache_hit_rate",
                "host_validate_frac"):
        v = host.get(key)
        if isinstance(v, _NUM) and not isinstance(v, bool) and not (
            0 <= v <= 1
        ):
            problems.append(f"host.{key}={v} outside [0, 1]")
    return problems


# the kill-the-leader chaos-soak section (`failover` field, recorded by
# `FTS_BENCH_SOAK_FAILOVER=1` and gated by `ftstop compare --failover`):
# the replication contract as numbers — how many acknowledged txs the
# promoted node LOST (must be 0), how many tx ids committed twice across
# the switch (must be 0), the p99 client-observed submit stall across
# the failover window (null when no client observed one), and the
# maximum follower lag the window saw before the kill
FAILOVER_REQUIRED = {
    "acked_tx_loss": int,
    "duplicate_commits": int,
    "failover_p99_s": _NULLABLE_NUM,
    "follower_lag_max": _NUM,
}

# type-checked when present: forensics of the window — acked total,
# when the leader was killed (seconds into the window), the promoted
# node's epoch, how the promotion happened, and client failover switches
FAILOVER_OPTIONAL = {
    "acked_txs": int,
    "killed_at_s": _NUM,
    "promoted_epoch": int,
    "promotion": str,  # "auto" (lease watchdog) or "explicit" (RPC)
    "failover_switches": int,
    "stale_rejected": int,
}


def validate_failover(failover) -> List[str]:
    """Schema problems of one `failover` section (empty list = valid)."""
    if not isinstance(failover, dict):
        return [f"failover is {type(failover).__name__}, expected object"]
    problems: List[str] = []
    _check(problems, failover, FAILOVER_REQUIRED, required=True)
    _check(problems, failover, FAILOVER_OPTIONAL, required=False)
    for key in ("acked_tx_loss", "duplicate_commits", "follower_lag_max"):
        v = failover.get(key)
        if isinstance(v, _NUM) and not isinstance(v, bool) and v < 0:
            problems.append(f"failover.{key} is negative")
    return problems


# the state-plane scale section (`state` field, bench `state_scale`
# phase): synthetic token count populated into a persistent vault,
# populate/recover wall time + throughput, p99 selection latency under
# concurrent select+spend threads, and the RSS high-water the phase
# reached (sysmon) — the numbers `ftstop compare --state` gates
STATE_REQUIRED = {
    "tokens": int,
    "populate_s": _NUM,
    "populate_tokens_per_s": _NUM,
    "recover_s": _NUM,
    "recover_tokens_per_s": _NUM,
    "selector_p99_s": _NUM,
    "rss_high_water_mb": _NUM,
}

# type-checked when present in a state section. The calibration pair is
# measured by a PURE single-thread no-spend selection pass at both sizes
# (selection cost, not contention): `sublinear_ratio` =
# p99(pure, full size) / p99(pure, small size) — the recorded witness
# that indexed selection stays sub-linear in vault size, while
# `selector_p99_s` stays the concurrent select+spend headline.
STATE_OPTIONAL = {
    "selects": int,
    "spends": int,
    "threads": int,
    "selector_p99_small_s": _NULLABLE_NUM,  # pure p99 at the small size
    "small_tokens": int,
    "sublinear_ratio": _NULLABLE_NUM,  # pure p99(full) / pure p99(small)
}


def validate_state(state) -> List[str]:
    """Schema problems of one `state` section (empty list = valid)."""
    if not isinstance(state, dict):
        return [f"state is {type(state).__name__}, expected object"]
    problems: List[str] = []
    _check(problems, state, STATE_REQUIRED, required=True)
    _check(problems, state, STATE_OPTIONAL, required=False)
    for key in ("tokens", "selector_p99_s"):
        v = state.get(key)
        if isinstance(v, _NUM) and not isinstance(v, bool) and v < 0:
            problems.append(f"state.{key} is negative")
    return problems


# the host-path profiler section (`profile` field, recorded by the soak
# phase): sampling rate actually used (0 = sampler off), how many
# sampling passes ran, the per-leg seconds the sub-leg timers collected
# over the soak window ({leg: seconds}), what fraction of the host-leg
# wall time those named legs explain (null when no host leg ran), and
# the bounded collapsed-stack table ({"role;frame;frame": samples}) the
# `ftstrace flame` subcommand renders
PROFILE_REQUIRED = {
    "hz": _NUM,
    "samples": int,
    "host_legs": dict,
    "stacks": dict,
}

PROFILE_OPTIONAL = {
    "host_leg_coverage": _NULLABLE_NUM,
    "dropped_stacks": int,
}


def validate_profile(profile) -> List[str]:
    """Schema problems of one `profile` section (empty list = valid)."""
    if not isinstance(profile, dict):
        return [f"profile is {type(profile).__name__}, expected object"]
    problems: List[str] = []
    _check(problems, profile, PROFILE_REQUIRED, required=True)
    _check(problems, profile, PROFILE_OPTIONAL, required=False)
    legs = profile.get("host_legs")
    if isinstance(legs, dict):
        for k, v in legs.items():
            if isinstance(v, bool) or not isinstance(v, _NUM) or v < 0:
                problems.append(f"profile.host_legs[{k!r}] not a number >= 0")
    stacks = profile.get("stacks")
    if isinstance(stacks, dict):
        for k, v in stacks.items():
            if isinstance(v, bool) or not isinstance(v, int) or v <= 0:
                problems.append(f"profile.stacks[{k!r}] not a count > 0")
    cov = profile.get("host_leg_coverage")
    if isinstance(cov, _NUM) and not isinstance(cov, bool) and cov < 0:
        problems.append("profile.host_leg_coverage is negative")
    return problems


# the error-budget section (`slo` field, recorded by the soak phase and
# gated absolutely by `ftstop compare --slo`): the sliding window the
# engine evaluated over, and one row per SLO with its objective, burn
# rate ((1 - good_frac) / (1 - objective); >= 1 means the budget is
# exhausted), remaining budget fraction and verdict
SLO_ROW_REQUIRED = {
    "objective": _NUM,
    "burn": _NUM,
    "budget_remaining": _NUM,
    "total": int,
    "ok": bool,
}


def validate_slo(slo) -> List[str]:
    """Schema problems of one `slo` section (empty list = valid)."""
    if not isinstance(slo, dict):
        return [f"slo is {type(slo).__name__}, expected object"]
    problems: List[str] = []
    _check(problems, slo, {"window_s": _NUM, "slos": dict}, required=True)
    for name, row in (slo.get("slos") or {}).items():
        if not isinstance(row, dict):
            problems.append(f"slo.slos[{name!r}] is {type(row).__name__}")
            continue
        rp: List[str] = []
        _check(rp, row, SLO_ROW_REQUIRED, required=True)
        problems.extend(f"slo.slos[{name!r}]: {p}" for p in rp)
    return problems


# the device-plane dispatch ledger section (`device` field, recorded by
# the headline and soak phases from `utils/devobs.py.section()` and
# gated by `ftstop compare --device`): total dispatches, batch occupancy
# (rows / (rows + padding); null until something dispatched), padding
# waste fraction, dispatch wall-time quantiles, compile/cache forensics,
# and the per-plane / per-program breakdowns `ftstrace devices` renders
DEVICE_REQUIRED = {
    "dispatches": int,
    "occupancy": _NULLABLE_NUM,
    "waste_frac": _NULLABLE_NUM,
    "planes": dict,
    "programs": dict,
}

DEVICE_OPTIONAL = {
    "rows": int,
    "padded_rows": int,
    "dispatch_p50_s": _NULLABLE_NUM,
    "dispatch_p99_s": _NULLABLE_NUM,
    "compiles": int,
    "compile_s": _NUM,
    "cache_hits": int,
    "cache_misses": int,
    "degrades": int,
}

_DEVICE_PLANE_REQUIRED = {
    "dispatches": int,
    "rows": int,
    "padded_rows": int,
    "occupancy": _NULLABLE_NUM,
    "waste_frac": _NULLABLE_NUM,
}


def validate_device(device) -> List[str]:
    """Schema problems of one `device` section (empty list = valid)."""
    if not isinstance(device, dict):
        return [f"device is {type(device).__name__}, expected object"]
    problems: List[str] = []
    _check(problems, device, DEVICE_REQUIRED, required=True)
    _check(problems, device, DEVICE_OPTIONAL, required=False)
    for frac in ("occupancy", "waste_frac"):
        v = device.get(frac)
        if isinstance(v, _NUM) and not isinstance(v, bool) and not (
            0 <= v <= 1
        ):
            problems.append(f"device.{frac}={v} outside [0, 1]")
    for name, row in (device.get("planes") or {}).items():
        if not isinstance(row, dict):
            problems.append(f"device.planes[{name!r}] is {type(row).__name__}")
            continue
        rp: List[str] = []
        _check(rp, row, _DEVICE_PLANE_REQUIRED, required=True)
        problems.extend(f"device.planes[{name!r}]: {p}" for p in rp)
    for name, row in (device.get("programs") or {}).items():
        if not isinstance(row, dict):
            problems.append(
                f"device.programs[{name!r}] is {type(row).__name__}"
            )
    return problems


# one row of the throughput-vs-devices scaling curve (`scaling` field):
# `n_devices` is the dp x mp mesh extent the block phase ran under,
# `block_txs_per_s` its measured rate, `efficiency` the per-device
# speedup relative to the smallest mesh (rate_n * n_min / (n * rate_min))
SCALING_ROW_REQUIRED = {
    "n_devices": int,
    "block_txs_per_s": _NUM,
    "efficiency": _NUM,
}


def validate_scaling(curve) -> List[str]:
    """Schema problems of one `scaling` curve (empty list = valid): a
    non-empty list of rows, each carrying the required fields, with
    strictly increasing positive device counts."""
    if not isinstance(curve, list):
        return [f"scaling is {type(curve).__name__}, expected list"]
    problems: List[str] = []
    if not curve:
        problems.append("scaling curve is empty")
    prev = 0
    for i, row in enumerate(curve):
        if not isinstance(row, dict):
            problems.append(f"scaling[{i}] is {type(row).__name__}")
            continue
        _check(problems, row, SCALING_ROW_REQUIRED, required=True)
        n = row.get("n_devices")
        if isinstance(n, int) and not isinstance(n, bool):
            if n <= prev:
                problems.append(
                    f"scaling[{i}].n_devices={n} not strictly increasing"
                )
            prev = n
    return problems


def is_degraded(result: dict) -> bool:
    return bool(result.get("degraded"))


def _check(problems: List[str], result: dict, spec: dict,
           required: bool) -> None:
    for key, typ in spec.items():
        if key not in result:
            if required:
                problems.append(f"missing required field {key!r}")
            continue
        v = result[key]
        # bool is an int subclass: reject it where a number is expected
        if isinstance(v, bool) and typ is not bool and bool not in (
            typ if isinstance(typ, tuple) else (typ,)
        ):
            problems.append(f"field {key!r} is bool, expected {typ}")
        elif not isinstance(v, typ):
            problems.append(
                f"field {key!r} has type {type(v).__name__}, expected {typ}"
            )


def validate_result(result) -> List[str]:
    """Return every schema problem of one bench result dict (empty list
    = valid). Both the full and the degraded form are accepted; unknown
    extra fields are allowed (forward compatibility)."""
    if not isinstance(result, dict):
        return [f"result is {type(result).__name__}, expected object"]
    problems: List[str] = []
    _check(problems, result, HEADLINE_REQUIRED, required=True)
    if isinstance(result.get("metric"), str) and result["metric"] != METRIC_NAME:
        problems.append(
            f"metric is {result['metric']!r}, expected {METRIC_NAME!r}"
        )
    if isinstance(result.get("unit"), str) and result["unit"] != UNIT:
        problems.append(f"unit is {result['unit']!r}, expected {UNIT!r}")
    if isinstance(result.get("value"), _NUM) and not isinstance(
        result.get("value"), bool
    ) and result["value"] < 0:
        problems.append("value is negative")
    if is_degraded(result):
        _check(problems, result, DEGRADED_REQUIRED, required=True)
    else:
        _check(problems, result, FULL_REQUIRED, required=True)
    _check(problems, result, OPTIONAL, required=False)
    if isinstance(result.get("scaling"), list):
        problems.extend(validate_scaling(result["scaling"]))
    if isinstance(result.get("soak"), dict):
        problems.extend(validate_soak(result["soak"]))
    if isinstance(result.get("state"), dict):
        problems.extend(validate_state(result["state"]))
    if isinstance(result.get("profile"), dict):
        problems.extend(validate_profile(result["profile"]))
    if isinstance(result.get("slo"), dict):
        problems.extend(validate_slo(result["slo"]))
    if isinstance(result.get("device"), dict):
        problems.extend(validate_device(result["device"]))
    if isinstance(result.get("host"), dict):
        problems.extend(validate_host(result["host"]))
    if isinstance(result.get("failover"), dict):
        problems.extend(validate_failover(result["failover"]))
    return problems


def extract_result(doc) -> Optional[dict]:
    """Pull the result dict out of any bench artifact shape: a bare
    result, a history line, or a recorded round file (`BENCH_r*.json`,
    whose result lives under `parsed`). None when the artifact carries
    no parseable result (`parsed: null`)."""
    if not isinstance(doc, dict):
        return None
    if "metric" in doc:
        return doc
    if "parsed" in doc:
        p = doc["parsed"]
        return p if isinstance(p, dict) else None
    return None


def load_result(path: str) -> Optional[dict]:
    with open(path) as fh:
        return extract_result(json.load(fh))


def load_history(path: str) -> List[dict]:
    """Read a `BENCH_history.jsonl` observatory file: one JSON object
    per line, oldest first. Unparseable lines are skipped (a crash can
    tear the final line; history must still load)."""
    out: List[dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue  # torn tail — same tolerance as the WAL
            if isinstance(row, dict):
                out.append(row)
    return out
