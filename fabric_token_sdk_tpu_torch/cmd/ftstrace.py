"""Assemble per-transaction distributed traces from sidecar dumps.

Counterpart of the JAX package's `cmd/ftstrace.py`: the same arguments,
output lines and exit codes; sidecars of either package read alike.

Usage (`ftstrace` is `python -m fabric_token_sdk_tpu_torch.cmd.ftstrace`):
    ftstrace timeline <tx-id-or-trace-id> <sidecar.json> [...]
    ftstrace export -o chrome_trace.json <sidecar.json> [...]
    ftstrace tail [-n N] <flight.json>
    ftstrace flame [--role ROLE] <result-or-history.json>
    ftstrace devices [--plane PLANE] <result-or-history.json>

Inputs are any mix of ``*.metrics.json`` (span trees — what
``Registry.snapshot()`` flushes) and ``*.flight.json`` (flight-recorder
rings) sidecars, from ONE process or MANY: spans and events are stitched
by ``trace_id``, the propagation id `services/network/remote.py` carries
inside request frames — so a client sidecar plus a ledger-node sidecar
yield one causal timeline per transaction (client submit -> server
orderer -> batched device verify -> WAL append -> finality).

`timeline` prints one trace chronologically, including the per-block
critical-path breakdown (queue wait / grouping / device verify / host
validate with its named sub-legs / WAL / merge) of the block that
committed the tx. `export` writes Chrome-trace-event JSON (load in
chrome://tracing or https://ui.perfetto.dev). `tail` prints the last N
flight-recorder events of a crash dump — the first thing to read after
an rc=124. `flame` dumps the host-path sampling profile of a bench
result (the `profile.stacks` section a bench records with its sampling
profiler on) in collapsed-stack format — pipe it straight into
flamegraph.pl or paste into speedscope.app. `devices` renders the
device-plane dispatch ledger of a bench result (the `device` section,
`utils/devobs.py`) as a per-program breakdown — dispatches, occupancy,
padding waste, wall share, compile forensics — from a result JSON or
the latest device-carrying round of `BENCH_history.jsonl` (same
dual-source rule as `flame`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from ..utils import benchschema

# breakdown keys of a `block.commit` flight event, in pipeline order
# (`overlap_s` only present on blocks the pipelined engine committed;
# the `host_*` sub-legs decompose `host_validate_s` by named phase)
BLOCK_BREAKDOWN_KEYS = (
    "queue_wait_max_s", "grouping_s", "device_verify_s", "sign_verify_s",
    "host_validate_s", "host_unmarshal_s", "host_fiat_shamir_s",
    "host_sig_verify_s", "host_conservation_s", "host_input_match_s",
    "wal_s", "merge_s", "overlap_s",
)


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _fmt_s(v: float) -> str:
    if v >= 60:
        return f"{v / 60:.1f}m"
    if v >= 1:
        return f"{v:.2f}s"
    if v >= 0.001:
        return f"{v * 1000:.1f}ms"
    return f"{v * 1e6:.0f}us"


def _walk_spans(node: dict, out: List[dict], src: str, pid) -> None:
    row = dict(node)
    row.pop("children", None)
    row["src"] = src
    row["pid"] = pid
    out.append(row)
    for child in node.get("children", ()):
        _walk_spans(child, out, src, pid)


def collect(paths: List[str]) -> Tuple[List[dict], List[dict]]:
    """Load every sidecar; return (flat spans, flight events), each row
    tagged with its source file and pid."""
    spans: List[dict] = []
    events: List[dict] = []
    for path in paths:
        doc = _load(path)
        src = os.path.basename(path)
        pid = doc.get("pid", 0)
        for root in doc.get("spans", ()):
            _walk_spans(root, spans, src, pid)
        for evt in doc.get("events", ()):
            row = dict(evt)
            row["src"] = src
            row["pid"] = pid
            events.append(row)
    return spans, events


def known_traces(spans: List[dict], events: List[dict]) -> Dict[str, str]:
    """trace_id -> a tx anchor seen for it (or ''), discovery aid."""
    out: Dict[str, str] = {}
    for s in spans:
        t = s.get("trace_id")
        if t:
            out.setdefault(t, "")
            tx = (s.get("attrs") or {}).get("tx")
            if tx:
                out[t] = tx
    for e in events:
        t = e.get("trace_id")
        if t:
            out.setdefault(t, "")
            if e.get("tx"):
                out[t] = e["tx"]
        if e.get("kind") == "block.commit":
            for tx, tr in zip(e.get("txs", ()), e.get("traces", ())):
                if tr:
                    out[tr] = tx
    return out


def resolve_traces(ident: str, spans: List[dict],
                   events: List[dict]) -> List[str]:
    """Accept either a trace id or a tx anchor; return every matching
    trace id. A tx can legitimately own more than one (e.g. assembled
    under a ttx trace, then shipped as raw bytes through a batched
    `submit_many` that mints per-request traces) — the tx timeline is
    the union."""
    traces = known_traces(spans, events)
    if ident in traces:
        return [ident]
    return sorted(t for t, tx in traces.items() if tx == ident)


def _trace_rows(trace_ids: List[str], spans: List[dict],
                events: List[dict]) -> List[tuple]:
    """(ts, kind, label, detail) rows for a set of traces, chronological."""
    wanted = set(trace_ids)
    rows: List[tuple] = []
    for s in spans:
        if s.get("trace_id") not in wanted or not s.get("start_unix"):
            continue
        attrs = s.get("attrs") or {}
        detail = " ".join(f"{k}={v}" for k, v in attrs.items())
        rows.append((
            s["start_unix"], "span",
            f"{s['name']:<28} {_fmt_s(s.get('duration_s', 0.0)):>8}",
            f"pid={s['pid']} {detail}".strip(),
        ))
    for e in events:
        kind = e.get("kind", "?")
        in_trace = e.get("trace_id") in wanted
        in_block = (
            kind == "block.commit"
            and wanted.intersection(e.get("traces") or ())
        )
        if not (in_trace or in_block):
            continue
        if kind == "block.commit":
            # the block's critical path applies to every tx it committed
            parts = " ".join(
                f"{k[:-2]}={_fmt_s(float(e.get(k, 0.0)))}"
                for k in BLOCK_BREAKDOWN_KEYS if k in e
            )
            rows.append((
                e.get("ts", 0.0), "block",
                f"block {e.get('block')} critical path ({len(e.get('txs', ()))} txs)",
                parts,
            ))
            continue
        detail = " ".join(
            f"{k}={v}" for k, v in e.items()
            if k not in ("ts", "kind", "trace_id", "src", "pid")
        )
        rows.append((e.get("ts", 0.0), "event", kind, detail))
    rows.sort(key=lambda r: r[0])
    return rows


def timeline(ident: str, paths: List[str]) -> int:
    spans, events = collect(paths)
    trace_ids = resolve_traces(ident, spans, events)
    if not trace_ids:
        traces = known_traces(spans, events)
        print(f"no trace found for {ident!r}", file=sys.stderr)
        if traces:
            print("known traces:", file=sys.stderr)
            for t, tx in sorted(traces.items())[:20]:
                print(f"  {t}  tx={tx or '?'}", file=sys.stderr)
        return 1
    rows = _trace_rows(trace_ids, spans, events)
    if not rows:
        print(f"trace {trace_ids}: no timed rows recorded", file=sys.stderr)
        return 1
    t0 = rows[0][0]
    print(f"== trace {' + '.join(trace_ids)} ({ident}) — {len(rows)} rows "
          f"across {len(paths)} sidecar(s)")
    for ts, kind, label, detail in rows:
        print(f"  +{ts - t0:>10.6f}s  {kind:<5}  {label}"
              + (f"  [{detail}]" if detail else ""))
    return 0


def export(out_path: str, paths: List[str]) -> int:
    """Chrome-trace-event JSON: spans become complete ('X') events on a
    per-trace lane, flight events become instants ('i')."""
    spans, events = collect(paths)
    tid_of: Dict[str, int] = {}
    lanes: set = set()  # (pid, tid) pairs actually carrying events

    def tid(trace_id: Optional[str], pid) -> int:
        key = trace_id or "(untraced)"
        if key not in tid_of:
            tid_of[key] = len(tid_of) + 1
        lanes.add((pid, tid_of[key], key))
        return tid_of[key]

    out: List[dict] = []
    for s in spans:
        if not s.get("start_unix"):
            continue
        args = dict(s.get("attrs") or {})
        for k in ("trace_id", "span_id", "parent_span_id"):
            if s.get(k):
                args[k] = s[k]
        out.append({
            "name": s["name"], "cat": "span", "ph": "X",
            "ts": s["start_unix"] * 1e6,
            "dur": max(1.0, s.get("duration_s", 0.0) * 1e6),
            "pid": s["pid"], "tid": tid(s.get("trace_id"), s["pid"]),
            "args": args,
        })
    for e in events:
        args = {
            k: v for k, v in e.items()
            if k not in ("ts", "kind", "src", "pid")
        }
        out.append({
            "name": e.get("kind", "?"), "cat": "flight", "ph": "i",
            "ts": e.get("ts", 0.0) * 1e6, "s": "p",
            "pid": e["pid"], "tid": tid(e.get("trace_id"), e["pid"]),
            "args": args,
        })
    # label the per-trace lanes so the viewer shows trace ids, not ints
    # — one metadata row per (pid, tid) pair that actually carries
    # events, or the labels attach to nothing
    meta = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": n,
         "args": {"name": f"trace {key}"}}
        for pid, n, key in sorted(lanes)
    ]
    with open(out_path, "w") as fh:
        json.dump({"traceEvents": meta + out}, fh)
    print(f"wrote {len(out)} events ({len(tid_of)} lanes) to {out_path}")
    return 0


def tail(path: str, n: int = 20) -> int:
    doc = _load(path)
    events = doc.get("events", [])
    print(f"== {path}: {len(events)} events "
          f"(capacity {doc.get('capacity', '?')}, pid {doc.get('pid', '?')})")
    for e in events[-n:]:
        detail = " ".join(
            f"{k}={v}" for k, v in e.items() if k not in ("ts", "kind")
        )
        print(f"  {e.get('ts', 0.0):.3f}  {e.get('kind', '?'):<20} {detail}")
    return 0


def _section_of(path: str, name: str) -> Optional[dict]:
    """A named dict section of a bench result file, or of the LATEST
    section-carrying round of a history jsonl."""
    if path.endswith(".jsonl"):
        found = None
        for row in benchschema.load_history(path):
            result = benchschema.extract_result(row)
            if result and isinstance(result.get(name), dict):
                found = result[name]
        return found
    doc = _load(path)
    s = doc.get(name)
    return s if isinstance(s, dict) else None


def _profile_of(path: str) -> Optional[dict]:
    """The `profile` section of a bench result file, or of the LATEST
    profile-carrying round of a history jsonl."""
    return _section_of(path, "profile")


def flame(path: str, role: Optional[str] = None, out=None) -> int:
    """Print a recorded profile's collapsed stacks (`stack count` lines,
    hottest first) — flamegraph.pl / speedscope input. Stacks are keyed
    `role;mod:func;...`; `--role` keeps one thread role's stacks."""
    out = out if out is not None else sys.stdout
    prof = _profile_of(path)
    if prof is None:
        print(f"{path}: no profile section (a bench run with its sampling "
              "profiler on records one)", file=sys.stderr)
        return 1
    stacks = prof.get("stacks") or {}
    if role:
        stacks = {s: c for s, c in stacks.items()
                  if s.split(";", 1)[0] == role}
    if not stacks:
        roles = sorted({s.split(";", 1)[0] for s in (prof.get("stacks") or {})})
        print(
            f"{path}: no stacks"
            + (f" for role {role!r} (roles seen: {', '.join(roles) or '-'})"
               if role else " recorded"),
            file=sys.stderr,
        )
        return 1
    for stack, count in sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0])):
        print(f"{stack} {count}", file=out)
    return 0


def _frac(v) -> str:
    return "-" if not isinstance(v, (int, float)) else f"{v:.1%}"


def devices(path: str, plane: Optional[str] = None, out=None) -> int:
    """Render the per-program device dispatch breakdown of a recorded
    bench round (`device` section): dispatches, occupancy, padding
    waste, share of total dispatch wall, and compile forensics —
    heaviest program first; `--plane` keeps one plane's programs."""
    out = out if out is not None else sys.stdout
    dev = _section_of(path, "device")
    if dev is None:
        print(f"{path}: no device section (recorded by a bench when the "
              "dispatch ledger is on: devobs.enable, default on)",
              file=sys.stderr)
        return 1
    programs = dev.get("programs") or {}
    if plane:
        programs = {
            k: r for k, r in programs.items()
            if isinstance(r, dict) and r.get("plane") == plane
        }
    if not programs:
        planes = sorted((dev.get("planes") or {}))
        print(
            f"{path}: no programs"
            + (f" for plane {plane!r} (planes seen: "
               f"{', '.join(planes) or '-'})" if plane else " recorded"),
            file=sys.stderr,
        )
        return 1
    print(
        f"== device plane: {dev.get('dispatches', 0)} dispatches  "
        f"occupancy={_frac(dev.get('occupancy'))}  "
        f"waste={_frac(dev.get('waste_frac'))}  "
        f"p99={dev.get('dispatch_p99_s')}s  "
        f"compiles={dev.get('compiles', 0)} "
        f"({dev.get('compile_s', 0)}s)  "
        f"cache={dev.get('cache_hits', 0)}h/"
        f"{dev.get('cache_misses', 0)}m  "
        f"degrades={dev.get('degrades', 0)}",
        file=out,
    )
    total_wall = sum(
        r.get("wall_s", 0.0) for r in programs.values()
        if isinstance(r, dict)
    )
    rows = sorted(
        (r for r in programs.values() if isinstance(r, dict)),
        key=lambda r: -r.get("wall_s", 0.0),
    )
    for r in rows:
        share = (
            r.get("wall_s", 0.0) / total_wall if total_wall else 0.0
        )
        print(
            f"  {r.get('plane', '-'):<8} {r.get('program', '-'):<20} "
            f"disp={r.get('dispatches', 0):<6} "
            f"occ={_frac(r.get('occupancy')):<6} "
            f"waste={_frac(r.get('waste_frac')):<6} "
            f"wall={_fmt_s(r.get('wall_s', 0.0)):>8} ({share:.0%}) "
            f"p50={_fmt_s(r.get('p50_s') or 0.0):>8} "
            f"p99={_fmt_s(r.get('p99_s') or 0.0):>8} "
            f"compiles={r.get('compiles', 0)} "
            f"degrades={r.get('degrades', 0)}",
            file=out,
        )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ftstrace", description=__doc__.splitlines()[0]
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_tl = sub.add_parser(
        "timeline", help="print one tx's stitched causal timeline"
    )
    p_tl.add_argument("ident", help="tx anchor or trace id")
    p_tl.add_argument("sidecars", nargs="+")
    p_ex = sub.add_parser(
        "export", help="write Chrome-trace-event JSON for all traces"
    )
    p_ex.add_argument("-o", "--out", default="fts_trace.json")
    p_ex.add_argument("sidecars", nargs="+")
    p_ta = sub.add_parser(
        "tail", help="print the last N events of a flight dump"
    )
    p_ta.add_argument("-n", type=int, default=20)
    p_ta.add_argument("flight")
    p_fl = sub.add_parser(
        "flame", help="dump a recorded host-path profile as collapsed stacks"
    )
    p_fl.add_argument("--role", default=None,
                      help="keep one thread role (commit-worker, "
                           "stage-a-driver, remote-handler, client, other)")
    p_fl.add_argument("result",
                      help="bench result JSON or BENCH_history.jsonl")
    p_dv = sub.add_parser(
        "devices",
        help="render a recorded round's per-program device dispatch "
             "breakdown",
    )
    p_dv.add_argument("--plane", default=None,
                      help="keep one plane's programs (verify, sign, "
                           "prove, stages)")
    p_dv.add_argument("result",
                      help="bench result JSON or BENCH_history.jsonl")
    args = ap.parse_args(argv)
    if args.cmd == "timeline":
        return timeline(args.ident, args.sidecars)
    if args.cmd == "export":
        return export(args.out, args.sidecars)
    if args.cmd == "flame":
        return flame(args.result, args.role)
    if args.cmd == "devices":
        return devices(args.result, args.plane)
    return tail(args.flight, args.n)


if __name__ == "__main__":
    sys.exit(main())
