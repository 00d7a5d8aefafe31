"""`top` for fts ledger nodes + the perf-regression observatory.

Counterpart of the JAX package's `cmd/ftstop.py`: the same arguments,
output lines and exit codes, over the port's `RemoteNetwork` and
`utils/benchschema.py`. A node of either package answers it. The tool
never initializes CUDA in its own process.

Usage (`ftstop` is `python -m fabric_token_sdk_tpu_torch.cmd.ftstop`):
    ftstop top HOST:PORT [--interval S] [--count N | --once]
    ftstop devices HOST:PORT [--interval S] [--count N | --once]
    ftstop compare OLD.json NEW.json [--threshold F]
    ftstop compare --history BENCH_history.jsonl [--last N]
    ftstop compare --history BENCH_history.jsonl --scaling
    ftstop compare --history BENCH_history.jsonl --soak
    ftstop compare --history BENCH_history.jsonl --state
    ftstop compare --history BENCH_history.jsonl --slo
    ftstop compare --history BENCH_history.jsonl --device
    ftstop compare --history BENCH_history.jsonl --host
    ftstop compare --history BENCH_history.jsonl --failover

`top` polls a live node's ops RPCs (`ops.health` + `ops.metrics`, both
side-effect-free and commit-lock-free server-side) and renders one line
per poll: uptime, height, queue depth with its trend vs the previous
poll, in-flight txs, tx/s (counter delta between polls), backpressure
reject rate (`bp/s`), batched fraction, p95 block-commit and
submit→finality latency (bucket-interpolated quantiles computed
node-side), and process/device memory. Ctrl-C exits cleanly.

`devices` polls the same `ops.health` RPC and renders the device-plane
dispatch ledger (`utils/devobs.py`) as a per-program table: dispatches,
mean occupancy, padding waste %, p50/p99 dispatch time (on a port node
the card's, by CUDA events), dp x mp placement, compiles with their wall
time and cache hits/misses (on a port node the kernel extensions' builds
and loads), and degrade decisions.

`compare` is the observatory: it diffs bench results against each other
or against the history file `bench.py` appends every outcome to
(`BENCH_history.jsonl`), using the shared result schema
(`utils/benchschema.py`). Per-metric verdicts are
threshold-based (default ±10%): throughput metrics regress when they
drop, cost metrics (`stage_warmup_s`, `wal_overhead_frac`) regress when
they grow. In history mode the baseline is the per-metric MEDIAN of the
prior valid rounds — one outlier round cannot poison the baseline. Exit
code 1 on any regression (CI-gateable; `--no-fail` disables).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List, Optional, Tuple

from ..utils import benchschema

# the poll interval (the reference's `FTS_OPS_INTERVAL_S` default)
DEFAULT_INTERVAL_S = 2.0


# ------------------------------------------------------------ top


def parse_address(s: str) -> Tuple[str, int]:
    host, _, port = s.rpartition(":")
    return (host or "127.0.0.1", int(port))


def _mb(v) -> str:
    return "-" if v in (None, 0) else f"{float(v) / 1e6:.1f}MB"


def _s(v) -> str:
    if v is None:
        return "-"
    return f"{v * 1000:.0f}ms" if v < 1 else f"{v:.2f}s"


def format_row(health: dict, snap: dict, prev_snap: Optional[dict],
               dt: Optional[float]) -> str:
    """One live-view line from an `ops.health` dict + `ops.metrics`
    snapshot (pure — unit-testable without a socket)."""
    ctr = snap.get("counters", {})
    gauges = snap.get("gauges", {})
    hists = snap.get("histograms", {})
    rate = None
    if prev_snap is not None and dt and dt > 0:
        prev_valid = prev_snap.get("counters", {}).get("network.tx.valid", 0)
        rate = (ctr.get("network.tx.valid", 0) - prev_valid) / dt
    batched = ctr.get("ledger.validate.batched", 0)
    host_v = ctr.get("ledger.validate.host", 0)
    bfrac = batched / (batched + host_v) if (batched + host_v) else None
    # queue-depth trend (delta vs the previous poll's gauge) and the
    # backpressure reject rate — the two live signals of an admission-
    # controlled node under sustained load
    qd = health.get("queue_depth", 0)
    trend = ""
    if prev_snap is not None:
        prev_q = prev_snap.get("gauges", {}).get("orderer.queue.depth")
        if prev_q is not None:
            delta = qd - prev_q
            trend = f"({delta:+.0f})" if delta else "(=)"
    bp_rate = None
    if prev_snap is not None and dt and dt > 0:
        prev_bp = prev_snap.get("counters", {}).get(
            "orderer.backpressure.rejects", 0
        )
        bp_rate = (
            ctr.get("orderer.backpressure.rejects", 0) - prev_bp
        ) / dt

    def p95(name):
        return hists.get(name, {}).get("p95")

    parts = [
        f"up={health.get('uptime_s', 0):.0f}s",
        f"height={health.get('height', 0)}",
        f"queue={qd}{trend}",
        f"inflight={health.get('inflight', 0)}",
        "tx/s=" + ("-" if rate is None else f"{rate:.2f}"),
        "bp/s=" + ("-" if bp_rate is None else f"{bp_rate:.2f}"),
        "batched=" + ("-" if bfrac is None else f"{bfrac:.0%}"),
        f"p95.commit={_s(p95('ledger.block.commit.seconds'))}",
        f"p95.finality={_s(p95('network.submit_to_finality.seconds'))}",
        f"rss={_mb(gauges.get('proc.rss.bytes'))}",
        f"dev_mem={_mb(gauges.get('device.mem.bytes'))}",
    ]
    # circuit-breaker column (resilience layer): `brk=ok` while every
    # plane that ever dispatched is closed, else the degraded planes and
    # their states — the live "a device plane is riding its host
    # fallback" signal. Absent entirely on nodes predating the field.
    breakers = health.get("breakers")
    if breakers is not None:
        degraded = {p: s for p, s in breakers.items() if s != "closed"}
        parts.append(
            "brk="
            + (",".join(f"{p}:{s}" for p, s in sorted(degraded.items()))
               if degraded else "ok")
        )
    # SLO column: `slo=ok` while every error budget has headroom, else
    # the breaching SLOs with their burn (budget multiples consumed) —
    # the "we are eating tomorrow's reliability" signal. Absent on nodes
    # predating the SLO engine.
    slo_sec = health.get("slo")
    if isinstance(slo_sec, dict):
        rows = slo_sec.get("slos", {})
        breaching = {
            name: r for name, r in rows.items()
            if isinstance(r, dict) and r.get("ok") is False
        }
        parts.append(
            "slo="
            + (",".join(
                f"{name}!{r.get('burn', 0):.1f}x"
                for name, r in sorted(breaching.items())
            ) if breaching else "ok")
        )
    # replication column: the node's place in the replicated plane —
    # `repl=leader@e3 lag=0` (worst follower lag) on a leader,
    # `repl=follower@e3 lag=2` (blocks behind the shipped stream) on a
    # follower. Absent on standalone nodes and nodes predating the
    # replication plane (health carries no `repl` section).
    repl = health.get("repl")
    if isinstance(repl, dict):
        parts.append(
            f"repl={repl.get('role', '?')}@e{repl.get('epoch', '?')} "
            f"lag={repl.get('lag', '-')}"
        )
    wal = health.get("wal")
    if wal:
        parts.append(
            f"wal={_mb(wal.get('bytes'))}"
            + (" POISONED" if wal.get("poisoned") else "")
        )
    lb = health.get("last_block")
    if lb:
        bd = lb.get("breakdown", {})
        parts.append(
            f"last_block=#{lb.get('number')}[{lb.get('txs')}tx "
            f"{_s(lb.get('commit_s'))}"
            f" dev={_s(bd.get('device_verify_s'))}"
            f" sign={_s(bd.get('sign_verify_s'))}"
            f" wal={_s(bd.get('wal_s'))}]"
        )
    return "  ".join(parts)


def top(address, interval: float = None, count: Optional[int] = None,
        out=None) -> int:
    """Poll a node's ops plane and print one line per poll."""
    from ..services.network.remote import RemoteNetwork

    if interval is None:
        interval = DEFAULT_INTERVAL_S
    out = out if out is not None else sys.stdout
    addr = parse_address(address) if isinstance(address, str) else tuple(address)
    net = RemoteNetwork(addr)
    prev_snap, prev_t = None, None
    i = 0
    try:
        while count is None or i < count:
            if i:
                time.sleep(interval)
            health = net.ops_health()
            snap = net.ops_metrics()
            now = time.monotonic()
            dt = (now - prev_t) if prev_t is not None else None
            print(format_row(health, snap, prev_snap, dt), file=out, flush=True)
            prev_snap, prev_t = snap, now
            i += 1
    except KeyboardInterrupt:
        pass
    finally:
        net.close()
    return 0


# ------------------------------------------------------------ devices


def _pct(v) -> str:
    return "-" if v is None else f"{v:.1%}"


def format_devices(health: dict) -> str:
    """The per-program device-plane table from an `ops.health` dict
    (pure — unit-testable without a socket). One header line with the
    per-plane occupancy roll-up, one row per (plane, program)."""
    dev = health.get("device")
    if not isinstance(dev, dict):
        return "devices: node predates the dispatch ledger"
    planes = dev.get("planes") or {}
    programs = dev.get("programs") or {}
    head = "planes: " + (
        "  ".join(
            f"{name}[n={p.get('dispatches', 0)} "
            f"occ={_pct(p.get('occupancy'))} "
            f"waste={_pct(p.get('waste_frac'))}]"
            for name, p in sorted(planes.items())
        ) if planes else "(no dispatches yet)"
    )
    if not programs:
        return head
    lines = [head]
    cols = (
        f"{'plane':<8} {'program':<20} {'disp':>6} {'occ':>7} "
        f"{'waste':>7} {'p50':>9} {'p99':>9} {'dpxmp':>6} "
        f"{'compiles':>8} {'comp_s':>7} {'hit/miss':>9} {'degr':>5}"
    )
    lines.append(cols)
    for _key, r in sorted(programs.items()):
        lines.append(
            f"{r.get('plane', '-'):<8} {r.get('program', '-'):<20} "
            f"{r.get('dispatches', 0):>6} {_pct(r.get('occupancy')):>7} "
            f"{_pct(r.get('waste_frac')):>7} {_s(r.get('p50_s')):>9} "
            f"{_s(r.get('p99_s')):>9} "
            f"{r.get('dp', 1)}x{r.get('mp', 1):<3} "
            f"{r.get('compiles', 0):>8} {r.get('compile_s', 0):>7g} "
            f"{r.get('cache_hits', 0)}/{r.get('cache_misses', 0):<4} "
            f"{r.get('degrades', 0):>5}"
        )
    return "\n".join(lines)


def devices(address, interval: float = None, count: Optional[int] = None,
            out=None) -> int:
    """Poll a node's ops plane and print the device ledger per poll."""
    from ..services.network.remote import RemoteNetwork

    if interval is None:
        interval = DEFAULT_INTERVAL_S
    out = out if out is not None else sys.stdout
    addr = parse_address(address) if isinstance(address, str) else tuple(address)
    net = RemoteNetwork(addr)
    i = 0
    try:
        while count is None or i < count:
            if i:
                time.sleep(interval)
            print(format_devices(net.ops_health()), file=out, flush=True)
            i += 1
    except KeyboardInterrupt:
        pass
    finally:
        net.close()
    return 0


# ------------------------------------------------------------ compare

# (result-JSON field, direction): +1 = higher is better, -1 = lower is
COMPARE_METRICS = (
    ("value", +1),
    ("block_txs_per_s", +1),
    ("prove_txs_per_s", +1),
    ("block_provegen_txs_per_s", +1),
    ("stage_warmup_s", -1),
    ("wal_overhead_frac", -1),
)


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def compare_records(old: dict, new: dict, threshold: float = 0.1) -> List[dict]:
    """Per-metric verdicts between two bench results: `regression` /
    `improvement` when the direction-adjusted relative change exceeds
    `threshold`, else `ok`. Metrics missing from either side are
    skipped — a degraded round simply compares on fewer metrics."""
    degraded = bool(old.get("degraded")) or bool(new.get("degraded"))
    verdicts = []
    for key, direction in COMPARE_METRICS:
        if degraded and direction < 0:
            # a deadline-truncated run's cost metrics are partial by
            # definition (it died mid-phase) — comparing them yields
            # spurious "improvements"; throughput drops are the signal
            continue
        a, b = old.get(key), new.get(key)
        if not _num(a) or not _num(b):
            continue
        if a == 0 and b == 0:
            rel = 0.0
        elif a == 0:
            rel = float("inf") if b > 0 else float("-inf")
        else:
            rel = (b - a) / abs(a)
        score = rel * direction
        verdict = (
            "regression" if score < -threshold
            else "improvement" if score > threshold
            else "ok"
        )
        verdicts.append({
            "metric": key,
            "old": a,
            "new": b,
            "change_frac": rel if abs(rel) != float("inf") else None,
            "verdict": verdict,
        })
    return verdicts


def scaling_curve(result: dict) -> Optional[List[dict]]:
    """The schema-valid throughput-vs-devices curve of one bench result,
    or None (rounds predating the scaling sweep, invalid rows, or a
    degenerate single-point curve — gating at n=1 would always pass,
    since efficiency there is 1.0 by construction)."""
    c = result.get("scaling")
    if (
        isinstance(c, list) and len(c) >= 2
        and not benchschema.validate_scaling(c)
    ):
        return c
    return None


def efficiency_at(curve: List[dict], n_devices: int) -> Optional[float]:
    for row in curve:
        if row.get("n_devices") == n_devices:
            return row.get("efficiency")
    return None


def compare_scaling(args) -> int:
    """The scaling observatory: report the latest round's
    throughput-vs-devices curve and gate on per-device efficiency at the
    MAX device count — the number that says whether adding devices still
    pays. Baseline = median efficiency at the same device count over the
    prior rounds that measured it. Exit 1 when it regresses by more than
    the threshold (CI-gateable; `--no-fail` disables), 2 when fewer than
    two rounds carry a curve."""
    rows = benchschema.load_history(args.history)
    curves = []
    for row in rows:
        result = benchschema.extract_result(row)
        if not result or benchschema.validate_result(result):
            continue
        c = scaling_curve(result)
        if c:
            curves.append(c)
    if args.last:
        curves = curves[-args.last:]
    if len(curves) < 2:
        print(
            "ftstop compare --scaling: need at least 2 history rounds with "
            f"a scaling curve, found {len(curves)}", file=sys.stderr,
        )
        return 2
    latest, prior = curves[-1], curves[:-1]
    max_n = latest[-1]["n_devices"]
    print(f"== scaling curve, latest round (threshold ±{args.threshold:.0%})")
    for row in latest:
        print(
            f"   n_devices={row['n_devices']:<3} "
            f"block_txs_per_s={row['block_txs_per_s']:<10g} "
            f"efficiency={row['efficiency']:.0%}"
        )
    base_vals = [
        e for e in (efficiency_at(c, max_n) for c in prior) if _num(e)
    ]
    if not base_vals:
        print(
            f"ftstop compare --scaling: no prior round measured "
            f"{max_n} devices — nothing to gate against", file=sys.stderr,
        )
        return 2
    base = statistics.median(base_vals)
    new = latest[-1]["efficiency"]
    rel = (new - base) / abs(base) if base else 0.0
    verdict = (
        "regression" if rel < -args.threshold
        else "improvement" if rel > args.threshold
        else "ok"
    )
    print(
        f"{verdict.upper():<12} efficiency@{max_n}dev "
        f"{base:g} -> {new:g}  ({rel:+.1%}, "
        f"median of {len(base_vals)} prior round(s))"
    )
    return 1 if verdict == "regression" and not args.no_fail else 0


def soak_of(result: dict) -> Optional[dict]:
    """The `soak` section of one schema-valid bench result, or None.
    (Callers filter through `validate_result` first, which already
    field-checks any dict-typed soak section — no re-validation here.)"""
    s = result.get("soak")
    return s if isinstance(s, dict) else None


# (soak field, direction): +1 = higher is better, -1 = lower is better
SOAK_METRICS = (
    ("steady_txs_per_s", +1),
    ("p99_finality_s", -1),
)


def _gate_sections(args, section_name, section_of, metrics,
                   header) -> int:
    """Shared engine of the section observatories (`--soak`/`--state`):
    collect the named section from every schema-valid history round,
    gate the latest against the per-metric MEDIAN of the prior
    section-carrying rounds with direction-aware threshold verdicts.
    Exit 1 on regression (CI-gateable; `--no-fail` disables), 2 when
    fewer than two rounds carry the section or nothing compares."""
    rows = benchschema.load_history(args.history)
    sections = []
    for row in rows:
        result = benchschema.extract_result(row)
        if not result or benchschema.validate_result(result):
            continue
        s = section_of(result)
        if s:
            sections.append(s)
    if args.last:
        sections = sections[-args.last:]
    if len(sections) < 2:
        print(
            f"ftstop compare --{section_name}: need at least 2 history "
            f"rounds with a {section_name} section, found {len(sections)}",
            file=sys.stderr,
        )
        return 2
    latest, prior = sections[-1], sections[:-1]
    print(f"== {header(latest)}  (threshold ±{args.threshold:.0%})")
    regressions = 0
    compared = 0
    width = max(len(k) for k, _d in metrics)
    for key, direction in metrics:
        base_vals = [s[key] for s in prior if _num(s.get(key))]
        new = latest.get(key)
        if not base_vals or not _num(new):
            continue
        base = statistics.median(base_vals)
        rel = (new - base) / abs(base) if base else 0.0
        score = rel * direction
        verdict = (
            "regression" if score < -args.threshold
            else "improvement" if score > args.threshold
            else "ok"
        )
        compared += 1
        if verdict == "regression":
            regressions += 1
        print(
            f"{verdict.upper():<12} {section_name}.{key:<{width}} "
            f"{base:g} -> {new:g}  ({rel:+.1%}, "
            f"median of {len(base_vals)} prior round(s))"
        )
    if not compared:
        print(f"ftstop compare --{section_name}: no comparable "
              f"{section_name} metrics", file=sys.stderr)
        return 2
    return 1 if regressions and not args.no_fail else 0


def compare_soak(args) -> int:
    """The soak observatory: gate on the sustained-load numbers —
    steady-state tx/s regresses when it drops, p99 finality when it
    grows — against the per-metric MEDIAN of the prior soak-carrying
    history rounds (same pattern as `--scaling`)."""
    return _gate_sections(
        args, "soak", soak_of, SOAK_METRICS,
        lambda s: (
            f"soak, latest round: steady={s['steady_txs_per_s']:g}tx/s "
            f"p99_finality={s.get('p99_finality_s')} "
            f"queue_max={s['queue_depth_max']:g} "
            f"backpressure={s['backpressure_rejects']} "
            f"driver={s.get('driver', 'fabtoken')} "
            f"sign={s.get('sign_plane', '-')} "
            f"host_validate_frac={s.get('host_validate_frac', '-')} "
            f"faults={s.get('faults_injected', 0)} "
            f"breaker_trips={s.get('breaker_trips', 0)} "
            f"degraded_planes={s.get('degraded_planes', 0)}"
        ),
    )


def state_of(result: dict) -> Optional[dict]:
    """The `state` section of one schema-valid bench result, or None.
    (Callers filter through `validate_result` first, which already
    field-checks any dict-typed state section.)"""
    s = result.get("state")
    return s if isinstance(s, dict) else None


# (state field, direction): +1 = higher is better, -1 = lower is better
STATE_METRICS = (
    ("selector_p99_s", -1),
    ("populate_tokens_per_s", +1),
    ("recover_tokens_per_s", +1),
)


def compare_state(args) -> int:
    """The state-plane observatory: gate the client state plane's scale
    numbers — selection p99 under concurrent spenders regresses when it
    GROWS, steady populate/recover throughput when it DROPS — against
    the per-metric MEDIAN of the prior state-carrying history rounds
    (same contract as `--scaling`/`--soak`)."""
    return _gate_sections(
        args, "state", state_of, STATE_METRICS,
        lambda s: (
            f"state plane, latest round: tokens={s['tokens']} "
            f"selector_p99={s['selector_p99_s']:g}s "
            f"populate={s['populate_tokens_per_s']:g}tok/s "
            f"recover={s['recover_tokens_per_s']:g}tok/s "
            f"rss_hw={s['rss_high_water_mb']:g}MB"
        ),
    )


def device_of(result: dict) -> Optional[dict]:
    """The `device` section of one schema-valid bench result, or None.
    (Callers filter through `validate_result` first, which already
    field-checks any dict-typed device section.)"""
    s = result.get("device")
    return s if isinstance(s, dict) else None


# (device field, direction): +1 = higher is better, -1 = lower is better
DEVICE_METRICS = (
    ("occupancy", +1),
    ("waste_frac", -1),
    ("dispatch_p99_s", -1),
)


def compare_device(args) -> int:
    """The device-plane observatory: gate the dispatch ledger's
    efficiency numbers — batch occupancy regresses when it DROPS,
    padding waste and p99 dispatch wall when they GROW — against the
    per-metric MEDIAN of the prior device-carrying history rounds (same
    contract as `--scaling`/`--soak`/`--state`)."""
    return _gate_sections(
        args, "device", device_of, DEVICE_METRICS,
        lambda s: (
            f"device plane, latest round: dispatches={s['dispatches']} "
            f"occupancy={s.get('occupancy')} "
            f"waste={s.get('waste_frac')} "
            f"p99={s.get('dispatch_p99_s')}s "
            f"compiles={s.get('compiles', 0)} "
            f"degrades={s.get('degrades', 0)} "
            f"planes={','.join(sorted((s.get('planes') or {})))}"
        ),
    )


def host_of(result: dict) -> Optional[dict]:
    """The `host` section of one schema-valid bench result, or None.
    (Callers filter through `validate_result` first, which already
    field-checks any dict-typed host section.)"""
    s = result.get("host")
    return s if isinstance(s, dict) else None


# (host field, direction): +1 = higher is better, -1 = lower is better
HOST_METRICS = (
    ("host_validate_frac", -1),
    ("unmarshal_p99_s", -1),
    ("fiat_shamir_p99_s", -1),
)


def compare_host(args) -> int:
    """The host-path observatory: gate the batch-first host validation
    numbers — the host leg's fraction of block commit wall and the
    per-block unmarshal / fiat_shamir p99s regress when they GROW —
    against the per-metric MEDIAN of the prior host-carrying history
    rounds (same contract as `--scaling`/`--soak`/`--device`)."""
    return _gate_sections(
        args, "host", host_of, HOST_METRICS,
        lambda s: (
            f"host path, latest round: "
            f"host_validate_frac={s.get('host_validate_frac')} "
            f"unmarshal={s['unmarshal_s']:g}s "
            f"fiat_shamir={s['fiat_shamir_s']:g}s "
            f"sig_verify={s['sig_verify_s']:g}s "
            f"batch_rows={s.get('sign_batch_rows', 0)}/"
            f"{s.get('proof_batch_rows', 0)}/"
            f"{s.get('conservation_rows', 0)} "
            f"req_cache={s.get('request_cache_hit_rate')} "
            f"parse_cache={s.get('parse_cache_hit_rate')} "
            f"workers={s.get('workers', '-')}"
        ),
    )


def failover_of(result: dict) -> Optional[dict]:
    """The `failover` section of one schema-valid bench result, or None.
    (Callers filter through `validate_result` first, which already
    field-checks any dict-typed failover section.)"""
    s = result.get("failover")
    return s if isinstance(s, dict) else None


# (failover field, direction): +1 = higher is better, -1 = lower better
FAILOVER_METRICS = (
    ("acked_tx_loss", -1),
    ("duplicate_commits", -1),
    ("failover_p99_s", -1),
    ("follower_lag_max", -1),
)


def compare_failover(args) -> int:
    """The replication observatory: gate the kill-the-leader chaos-soak
    contract. Two verdicts layered: the LOSS metrics (`acked_tx_loss`,
    `duplicate_commits`) are ABSOLUTE — any nonzero value in the latest
    round is a regression regardless of the baseline, because the
    relative engine's `(new - base) / base` arithmetic treats a 0 -> 1
    jump on a zero baseline as 0% change and would wave the one
    regression this gate exists to catch straight through. The latency
    metrics (`failover_p99_s`, `follower_lag_max`) gate relatively
    against the median of prior failover-carrying rounds, same contract
    as `--soak`/`--host`."""
    rc = _gate_sections(
        args, "failover", failover_of, FAILOVER_METRICS,
        lambda s: (
            f"failover, latest round: acked={s.get('acked_txs', '-')} "
            f"loss={s['acked_tx_loss']} dups={s['duplicate_commits']} "
            f"p99={s.get('failover_p99_s')}s "
            f"lag_max={s['follower_lag_max']:g} "
            f"epoch={s.get('promoted_epoch', '-')} "
            f"promotion={s.get('promotion', '-')} "
            f"switches={s.get('failover_switches', 0)}"
        ),
    )
    if rc == 2:
        return rc
    # the absolute layer: zero-tolerance on the correctness metrics
    sections = []
    for row in benchschema.load_history(args.history):
        result = benchschema.extract_result(row)
        if not result or benchschema.validate_result(result):
            continue
        s = failover_of(result)
        if s:
            sections.append(s)
    if args.last:
        sections = sections[-args.last:]
    hard = 0
    for key in ("acked_tx_loss", "duplicate_commits"):
        v = sections[-1].get(key) if sections else None
        if _num(v) and v > 0:
            hard += 1
            print(f"REGRESSION   failover.{key:<17} {v:g}  "
                  "(absolute: any nonzero value fails the gate)")
    if hard:
        return 1 if not args.no_fail else rc
    return rc


def compare_slo(args) -> int:
    """The SLO gate: unlike the regression observatories (which diff
    against prior rounds), this is an ABSOLUTE verdict on the latest
    history round that carries an `slo` section — the declared
    objectives ARE the baseline. Exit 1 when any error budget is
    exhausted (`ok: false`; CI-gateable, `--no-fail` disables), 2 when
    no round carries the section, 0 when every budget has headroom."""
    rows = benchschema.load_history(args.history)
    sections = []
    for row in rows:
        result = benchschema.extract_result(row)
        if not result or benchschema.validate_result(result):
            continue
        s = result.get("slo")
        if isinstance(s, dict) and isinstance(s.get("slos"), dict):
            sections.append(s)
    if args.last:
        sections = sections[-args.last:]
    if not sections:
        print(
            "ftstop compare --slo: no history round carries an slo "
            "section", file=sys.stderr,
        )
        return 2
    latest = sections[-1]
    print(f"== slo verdict, latest round (window {latest.get('window_s')}s)")
    breaches = 0
    for name, r in sorted(latest["slos"].items()):
        if not isinstance(r, dict):
            continue
        ok = r.get("ok") is not False
        if not ok:
            breaches += 1
        target = r.get("target_s")
        print(
            f"{'OK' if ok else 'BREACH':<12} {name:<16} "
            f"objective={r.get('objective')}"
            + (f"@{target:g}s" if _num(target) else "")
            + f" good_frac={r.get('good_frac')}"
            f" burn={r.get('burn')}x"
            f" budget_remaining={r.get('budget_remaining')}"
            f" n={r.get('total')}"
        )
    print(
        f"verdict: {breaches} breached error budget(s) of "
        f"{len(latest['slos'])}"
    )
    return 1 if breaches and not args.no_fail else 0


def baseline_of(records: List[dict]) -> dict:
    """Per-metric median over a set of valid rounds — the history-mode
    baseline (one outlier round cannot poison it)."""
    base = {}
    for key, _dir in COMPARE_METRICS:
        vals = [r[key] for r in records if _num(r.get(key))]
        if vals:
            base[key] = statistics.median(vals)
    return base


def compare(args) -> int:
    if args.history:
        rows = benchschema.load_history(args.history)
        valid = []
        for i, row in enumerate(rows):
            result = benchschema.extract_result(row)
            problems = benchschema.validate_result(result)
            if problems:
                print(
                    f"[ftstop] {args.history} line {i + 1} fails the bench "
                    f"schema ({problems[0]}) — skipped",
                    file=sys.stderr,
                )
                continue
            valid.append(result)
        if args.last:
            valid = valid[-args.last:]
        if len(valid) < 2:
            print("ftstop compare: need at least 2 schema-valid history "
                  f"records, found {len(valid)}", file=sys.stderr)
            return 2
        # degraded rounds are truncated OUTCOMES, not baselines: their
        # zero/partial metrics would drag the median toward 0 and turn a
        # real regression into an "improvement". The LATEST round still
        # compares whatever it is — a degraded latest is exactly the
        # alert the observatory exists to raise.
        prior = [r for r in valid[:-1] if not r.get("degraded")]
        if not prior:
            print("ftstop compare: no full (non-degraded) prior rounds to "
                  "baseline against", file=sys.stderr)
            return 2
        old, new = baseline_of(prior), valid[-1]
        old_label = f"median({len(prior)} prior full rounds)"
        new_label = "latest round"
    else:
        old = benchschema.load_result(args.old)
        new = benchschema.load_result(args.new)
        for path, result in ((args.old, old), (args.new, new)):
            problems = benchschema.validate_result(result)
            if problems:
                print(
                    f"[ftstop] {path} fails the bench schema: "
                    + "; ".join(problems),
                    file=sys.stderr,
                )
                return 2
        old_label, new_label = args.old, args.new
    print(f"== {old_label} -> {new_label}  (threshold ±{args.threshold:.0%})")
    for rec, label in ((old, old_label), (new, new_label)):
        if rec.get("degraded"):
            print(f"   note: {label} is a DEGRADED result "
                  f"(died in phase {rec.get('phase', '?')!r})")
    verdicts = compare_records(old, new, args.threshold)
    if not verdicts:
        print("no comparable metrics between the two records")
        return 2
    for v in verdicts:
        chg = "n/a" if v["change_frac"] is None else f"{v['change_frac']:+.1%}"
        print(
            f"{v['verdict'].upper():<12} {v['metric']:<26} "
            f"{v['old']:g} -> {v['new']:g}  ({chg})"
        )
    regressions = [v for v in verdicts if v["verdict"] == "regression"]
    improvements = [v for v in verdicts if v["verdict"] == "improvement"]
    print(
        f"verdict: {len(regressions)} regression(s), "
        f"{len(improvements)} improvement(s), "
        f"{len(verdicts) - len(regressions) - len(improvements)} ok"
    )
    return 1 if regressions and not args.no_fail else 0


# ------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ftstop", description=__doc__.splitlines()[0]
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_top = sub.add_parser("top", help="live ops view of a running node")
    p_top.add_argument("address", help="HOST:PORT of a LedgerServer")
    p_top.add_argument("--interval", type=float, default=None,
                       help="poll interval seconds (default 2)")
    p_top.add_argument("--count", type=int, default=None,
                       help="stop after N polls (default: forever)")
    p_top.add_argument("--once", action="store_true",
                       help="one poll, then exit (same as --count 1)")
    p_dev = sub.add_parser(
        "devices",
        help="per-program device dispatch ledger of a running node",
    )
    p_dev.add_argument("address", help="HOST:PORT of a LedgerServer")
    p_dev.add_argument("--interval", type=float, default=None,
                       help="poll interval seconds (default 2)")
    p_dev.add_argument("--count", type=int, default=None,
                       help="stop after N polls (default: forever)")
    p_dev.add_argument("--once", action="store_true",
                       help="one poll, then exit (same as --count 1)")
    p_cmp = sub.add_parser("compare", help="diff bench rounds for regressions")
    p_cmp.add_argument("old", nargs="?", help="old result/round JSON")
    p_cmp.add_argument("new", nargs="?", help="new result/round JSON")
    p_cmp.add_argument("--history", help="BENCH_history.jsonl observatory file")
    p_cmp.add_argument("--last", type=int, default=None,
                       help="history mode: only consider the last N rounds")
    p_cmp.add_argument("--threshold", type=float, default=0.1,
                       help="relative change that counts as a verdict")
    # one gate mode per invocation: a silently-ignored second flag would
    # let its regression pass CI unreported
    p_gate = p_cmp.add_mutually_exclusive_group()
    p_gate.add_argument("--scaling", action="store_true",
                        help="gate on the throughput-vs-devices curve: "
                             "per-device efficiency at the max device count "
                             "(history mode only)")
    p_gate.add_argument("--soak", action="store_true",
                        help="gate on the sustained-load soak: steady-state "
                             "tx/s and p99 finality vs the median of prior "
                             "soak-carrying rounds (history mode only)")
    p_gate.add_argument("--state", action="store_true",
                        help="gate on the state-plane scale numbers: selector "
                             "p99 (growth) and populate/recover throughput "
                             "(drop) vs the median of prior state-carrying "
                             "rounds (history mode only)")
    p_gate.add_argument("--slo", action="store_true",
                        help="gate on the latest round's SLO verdict: exit 1 "
                             "when any error budget is exhausted — absolute, "
                             "not relative to prior rounds (history mode "
                             "only)")
    p_gate.add_argument("--device", action="store_true",
                        help="gate on the device-plane dispatch ledger: batch "
                             "occupancy (drop), padding waste and p99 "
                             "dispatch wall (growth) vs the median of prior "
                             "device-carrying rounds (history mode only)")
    p_gate.add_argument("--host", action="store_true",
                        help="gate on the batch-first host path: host-leg "
                             "fraction of commit wall and unmarshal / "
                             "fiat_shamir p99 (growth) vs the median of "
                             "prior host-carrying rounds (history mode only)")
    p_gate.add_argument("--failover", action="store_true",
                        help="gate on the kill-the-leader chaos soak: "
                             "acked-tx loss and duplicate commits "
                             "(absolute — any nonzero fails), failover p99 "
                             "and follower lag (growth) vs the median of "
                             "prior failover-carrying rounds (history mode "
                             "only)")
    p_cmp.add_argument("--no-fail", action="store_true",
                       help="exit 0 even when regressions are flagged")
    args = ap.parse_args(argv)
    if args.cmd == "top":
        return top(args.address, args.interval,
                   1 if args.once else args.count)
    if args.cmd == "devices":
        return devices(args.address, args.interval,
                       1 if args.once else args.count)
    if args.scaling:
        if not args.history:
            ap.error("compare --scaling needs --history")
        return compare_scaling(args)
    if args.soak:
        if not args.history:
            ap.error("compare --soak needs --history")
        return compare_soak(args)
    if args.state:
        if not args.history:
            ap.error("compare --state needs --history")
        return compare_state(args)
    if args.slo:
        if not args.history:
            ap.error("compare --slo needs --history")
        return compare_slo(args)
    if args.device:
        if not args.history:
            ap.error("compare --device needs --history")
        return compare_device(args)
    if args.host:
        if not args.history:
            ap.error("compare --host needs --history")
        return compare_host(args)
    if args.failover:
        if not args.history:
            ap.error("compare --failover needs --history")
        return compare_failover(args)
    if not args.history and (not args.old or not args.new):
        ap.error("compare needs OLD and NEW files, or --history")
    return compare(args)


if __name__ == "__main__":
    sys.exit(main())
