"""Pretty-print / diff `*.metrics.json` sidecar dumps.

Counterpart of the JAX package's `cmd/ftsmetrics.py`: the same
arguments, output lines and exit codes.

Usage:
    python -m fabric_token_sdk_tpu_torch.cmd.ftsmetrics show NODE.metrics.json
    python -m fabric_token_sdk_tpu_torch.cmd.ftsmetrics show --prometheus NODE.metrics.json
    python -m fabric_token_sdk_tpu_torch.cmd.ftsmetrics diff OLD.metrics.json NEW.metrics.json

The sidecar format is whatever `utils/metrics.py` `Registry.snapshot()`
emits (a port node's `metrics.flush_sidecar`, or its `ops.metrics`
answer written to a file): meta, phase timeline, counters, gauges,
histograms, span summary. Sidecars of either package read alike.
"""

from __future__ import annotations

import argparse
import json
import sys


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _fmt_s(v: float) -> str:
    if v >= 60:
        return f"{v / 60:.1f}m"
    if v >= 1:
        return f"{v:.1f}s"
    return f"{v * 1000:.1f}ms"


def _print_kv(title: str, rows, fmt=str) -> None:
    if not rows:
        return
    print(f"\n{title}")
    width = max(len(k) for k, _ in rows)
    for k, v in rows:
        print(f"  {k:<{width}}  {fmt(v)}")


def show(path: str, prometheus: bool = False) -> None:
    d = _load(path)
    if prometheus:
        # re-serialize counters/gauges through a scratch registry so one
        # exporter owns that part of the text format
        from ..utils.metrics import Registry, _prom_name, _prom_num

        reg = Registry()
        for name, v in d.get("counters", {}).items():
            reg.counter(name).inc(v)
        for name, v in d.get("gauges", {}).items():
            reg.gauge(name).set(v)
        sys.stdout.write(reg.to_prometheus())
        # histograms come from the snapshot dict directly (the sidecar
        # stores per-bucket counts for the non-empty buckets only)
        lines = []
        for name, h in sorted(d.get("histograms", {}).items()):
            m = _prom_name(name)
            lines.append(f"# TYPE {m} histogram")
            cum = 0
            finite = {
                float(le): c
                for le, c in h.get("buckets", {}).items()
                if le != "+Inf"
            }
            for le in sorted(finite):
                cum += finite[le]
                lines.append(f'{m}_bucket{{le="{_prom_num(le)}"}} {cum}')
            cum += h.get("buckets", {}).get("+Inf", 0)
            lines.append(f'{m}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{m}_sum {_prom_num(h.get('sum', 0))}")
            lines.append(f"{m}_count {h.get('count', 0)}")
            for q in ("p50", "p95", "p99"):
                if q in h:
                    lines.append(f"{m}_{q} {_prom_num(h[q])}")
        if lines:
            sys.stdout.write("\n".join(lines) + "\n")
        return

    print(f"== {path}")
    meta = d.get("meta", {})
    if meta:
        _print_kv("meta", sorted(meta.items()))

    phases = d.get("phases", [])
    if phases:
        print("\nphases")
        for p in phases:
            el = p.get("elapsed_s")
            el_s = _fmt_s(el) if el is not None else "(unfinished)"
            attrs = p.get("attrs", {})
            extra = "".join(f" {k}={v}" for k, v in attrs.items())
            print(f"  {p['name']:<18} {el_s:>10}{extra}")
        total = sum(p.get("elapsed_s", 0.0) for p in phases)
        print(f"  {'TOTAL':<18} {_fmt_s(total):>10}")

    _print_kv("counters", sorted(d.get("counters", {}).items()))

    # one-line compile/cache health: the cold-cache-regression check.
    # programs = distinct XLA programs backend-compiled this run; a warm
    # persistent cache shows programs=0 with cache_hits > 0. These are a
    # JAX package sidecar's counters: a port sidecar compiles no XLA and
    # reads zeros (its kernel builds and loads are the dispatch ledger's,
    # `ftstop devices`).
    comp = d.get("histograms", {}).get(
        "jax.core.compile.backend_compile_duration.seconds", {}
    )
    ctr = d.get("counters", {})
    print(
        f"\ncompile summary: programs={comp.get('count', 0)}"
        f" compile_sum={_fmt_s(comp.get('sum', 0.0))}"
        f" cache_hits={ctr.get('jax.compilation_cache.cache_hits', 0)}"
        f" cache_misses={ctr.get('jax.compilation_cache.cache_misses', 0)}"
        f" load_failures={ctr.get('jax.cache.load_failures', 0)}"
    )

    # one-line block-pipeline health: how much of the validate plane rode
    # the batched device path vs the host fallback
    blocks = ctr.get("ledger.blocks.committed", 0)
    if blocks:
        bsize = d.get("histograms", {}).get("ledger.block.size", {})
        txs = int(bsize.get("sum", 0))
        batched = ctr.get("ledger.validate.batched", 0)
        host = ctr.get("ledger.validate.host", 0)
        frac = batched / (batched + host) if (batched + host) else 0.0
        print(
            f"block summary: blocks={blocks} txs={txs}"
            f" txs_per_block={txs / blocks:.1f}"
            f" batched={batched} host={host} batched_frac={frac:.2f}"
        )

    # one-line prove-plane health: how much proof GENERATION rode the
    # batched device prover vs the host prover (and device-error
    # fallbacks — nonzero fallbacks mean the degrade-only contract fired)
    p_batches = ctr.get("batch.prove.batches", 0)
    p_txs = ctr.get("batch.prove.txs", 0)
    p_host = ctr.get("batch.prove.host", 0)
    p_fall = ctr.get("batch.prove.host_fallbacks", 0)
    if p_batches or p_host or p_fall:
        denom = p_txs + p_host
        frac = p_txs / denom if denom else 0.0
        print(
            f"prove summary: batches={p_batches} device_txs={p_txs}"
            f" host={p_host} host_fallbacks={p_fall}"
            f" device_frac={frac:.2f}"
        )

    # one-line sign-plane health: how much signature verification rode
    # the batched device plane vs the host loop (fallbacks nonzero means
    # the degrade-only contract fired), plus the identity parse-cache
    # hit rate shared by both paths
    s_batches = ctr.get("batch.sign.batches", 0)
    s_rows = ctr.get("batch.sign.rows", 0)
    s_host = ctr.get("batch.sign.host", 0)
    s_fall = ctr.get("batch.sign.host_fallbacks", 0)
    ic_hits = ctr.get("identity.cache.hits", 0)
    ic_miss = ctr.get("identity.cache.misses", 0)
    if s_batches or s_host or s_fall or ic_hits or ic_miss:
        lookups = ic_hits + ic_miss
        hit_rate = ic_hits / lookups if lookups else 0.0
        print(
            f"sign summary: batches={s_batches} device_rows={s_rows}"
            f" host={s_host} host_fallbacks={s_fall}"
            f" identity_cache_hit_rate={hit_rate:.2f}"
        )

    # one-line resilience health: circuit-breaker transitions, open-
    # breaker rejections, bounded-dispatch timeouts and abandoned-worker
    # straggler completions — nonzero opens/timeouts mean a device plane
    # was degraded and the commit path rode its host fallback
    r_open = ctr.get("resilience.breaker.open", 0)
    r_close = ctr.get("resilience.breaker.close", 0)
    r_probe = ctr.get("resilience.breaker.probe", 0)
    r_rej = ctr.get("resilience.breaker.rejected", 0)
    b_calls = ctr.get("resilience.bounded.calls", 0)
    b_to = ctr.get("resilience.bounded.timeouts", 0)
    b_strag = ctr.get("resilience.bounded.stragglers", 0)
    if r_open or r_rej or b_to or b_calls:
        print(
            f"resilience summary: breaker_opens={r_open} closes={r_close}"
            f" probes={r_probe} rejected={r_rej}"
            f" bounded_calls={b_calls} timeouts={b_to}"
            f" stragglers={b_strag}"
        )

    # one-line tracing health: how many distributed traces / trace-tagged
    # spans this run produced, flight-recorder traffic, and ring dumps
    # (assemble the actual timelines with cmd/ftstrace.py)
    tr = ctr.get("trace.traces", 0)
    fe = ctr.get("flight.events", 0)
    if tr or fe:
        print(
            f"trace summary: traces={tr}"
            f" spans={ctr.get('trace.spans', 0)}"
            f" recorder_events={fe}"
            f" dumps={ctr.get('flight.dumps', 0)}"
        )

    # one-line durability health: journal traffic, recovery/torn-tail
    # events, injected chaos, and client-side retry pressure
    wal_appends = ctr.get("wal.appends", 0)
    faults_injected = sum(
        v for k, v in ctr.items() if k.startswith("faults.injected.")
    )
    retries = sum(v for k, v in ctr.items() if k.startswith("remote.retry."))
    if wal_appends or faults_injected or retries or ctr.get("wal.recoveries", 0):
        print(
            f"durability summary: wal_appends={wal_appends}"
            f" replayed={ctr.get('wal.replayed.records', 0)}"
            f" torn_tails={ctr.get('wal.torn_tails', 0)}"
            f" snapshots={ctr.get('wal.snapshots', 0)}"
            f" recoveries={ctr.get('wal.recoveries', 0)}"
            f" faults_injected={faults_injected}"
            f" remote_retries={retries}"
        )

    # one-line state-plane health: vault traffic (tokens held / stored /
    # spent / certs dropped, journal appends+failures) and the selector's
    # p99 + lock-contention rate under concurrent spenders
    v_stored = ctr.get("vault.tokens.stored", 0)
    v_spent = ctr.get("vault.tokens.spent", 0)
    s_busy = ctr.get("selector.lock.busy", 0)
    s_acq = ctr.get("selector.lock.acquired", 0)
    if v_stored or v_spent or s_acq or ctr.get("vault.recoveries", 0):
        sel_h = d.get("histograms", {}).get("selector.select.seconds", {})
        busy_rate = s_busy / (s_busy + s_acq) if (s_busy + s_acq) else 0.0
        held = d.get("gauges", {}).get("vault.tokens.held", 0)
        print(
            f"state summary: tokens_held={int(held)}"
            f" stored={v_stored} spent={v_spent}"
            f" certs_dropped={ctr.get('vault.certs.dropped', 0)}"
            f" vault_appends={ctr.get('vault.appends', 0)}"
            f"(+{ctr.get('vault.append_failures', 0)} failed)"
            f" recoveries={ctr.get('vault.recoveries', 0)}"
            f" selector_p99="
            + ("-" if not sel_h.get("count") else _fmt_s(sel_h.get("p99", 0.0)))
            + f" lock_busy_rate={busy_rate:.2f}"
        )

    # one-line live-ops summary: queue/memory state at flush time plus
    # the latency quantiles the ops plane serves (p50/p95/p99)
    g = d.get("gauges", {})
    hh = d.get("histograms", {})
    commit_h = hh.get("ledger.block.commit.seconds", {})
    fin_h = hh.get("network.submit_to_finality.seconds", {})
    if ("orderer.queue.depth" in g or "ledger.inflight" in g
            or commit_h.get("count") or fin_h.get("count")):

        def _qs(h):
            if not h.get("count"):
                return "-"
            return "/".join(_fmt_s(h.get(q, 0.0)) for q in ("p50", "p95", "p99"))

        def _mb(v):
            return "-" if not v else f"{float(v) / 1e6:.1f}MB"

        print(
            f"ops summary: queue_depth={int(g.get('orderer.queue.depth', 0))}"
            f" inflight={int(g.get('ledger.inflight', 0))}"
            f" rss_peak={_mb(g.get('proc.rss.peak.bytes'))}"
            f" dev_mem_hw={_mb(g.get('stages.mem.high_water.bytes'))}"
            f" block_commit[p50/p95/p99]={_qs(commit_h)}"
            f" finality[p50/p95/p99]={_qs(fin_h)}"
        )

    # the slow-tx exemplar ring (`slo.exemplars` meta): the K slowest
    # submit->finality txs with their trace ids — paste one straight
    # into `ftstrace timeline`
    exemplars = meta.get("slo.exemplars")
    if isinstance(exemplars, list) and exemplars:
        print("\nslowest txs (submit->finality; trace with ftstrace timeline)")
        for row in exemplars:
            if not isinstance(row, (list, tuple)) or len(row) < 3:
                continue
            secs, tx, trace_id = row[0], row[1], row[2]
            print(f"  {_fmt_s(float(secs)):>8}  tx={tx}"
                  f"  trace={trace_id or '-'}")

    _print_kv(
        "gauges",
        sorted(d.get("gauges", {}).items()),
        fmt=lambda v: f"{v:g}",
    )

    hists = d.get("histograms", {})
    if hists:
        print("\nhistograms (count / mean / max / sum)")
        width = max(len(k) for k in hists)
        for name, h in sorted(hists.items()):
            if not h.get("count"):
                continue
            print(
                f"  {name:<{width}}  n={h['count']:<6} "
                f"mean={_fmt_s(h.get('mean', 0)):>8} "
                f"max={_fmt_s(h.get('max', 0)):>8} "
                f"sum={_fmt_s(h.get('sum', 0)):>8}"
            )

    spans = d.get("span_summary", {})
    if spans:
        print("\nspan summary (by total time)")
        width = max(len(k) for k in spans)
        for name, a in sorted(
            spans.items(), key=lambda kv: -kv[1].get("total_s", 0)
        ):
            print(
                f"  {name:<{width}}  n={a['count']:<6} "
                f"total={_fmt_s(a['total_s']):>8}"
            )


def diff(path_a: str, path_b: str) -> None:
    a, b = _load(path_a), _load(path_b)
    print(f"== {path_a} -> {path_b}")

    def _delta_rows(key, fmt_delta):
        names = sorted(set(a.get(key, {})) | set(b.get(key, {})))
        rows = []
        for n in names:
            va = a.get(key, {}).get(n, 0)
            vb = b.get(key, {}).get(n, 0)
            if va != vb:
                rows.append((n, fmt_delta(va, vb)))
        return rows

    _print_kv(
        "counters (old -> new)",
        _delta_rows("counters", lambda x, y: f"{x} -> {y}  ({y - x:+d})"),
    )
    _print_kv(
        "gauges (old -> new)",
        _delta_rows("gauges", lambda x, y: f"{x:g} -> {y:g}"),
    )

    ha, hb = a.get("histograms", {}), b.get("histograms", {})
    rows = []
    for n in sorted(set(ha) | set(hb)):
        ca = ha.get(n, {}).get("count", 0)
        cb = hb.get(n, {}).get("count", 0)
        sa = ha.get(n, {}).get("sum", 0.0)
        sb = hb.get(n, {}).get("sum", 0.0)
        if (ca, sa) != (cb, sb):
            rows.append(
                (n, f"n {ca} -> {cb}, sum {_fmt_s(sa)} -> {_fmt_s(sb)}")
            )
    _print_kv("histograms (old -> new)", rows)

    for label, d_ in (("old", a), ("new", b)):
        phases = d_.get("phases", [])
        if phases:
            line = ", ".join(
                f"{p['name']}={_fmt_s(p['elapsed_s'])}"
                for p in phases
                if "elapsed_s" in p
            )
            print(f"\nphases[{label}]: {line}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ftsmetrics", description=__doc__.splitlines()[0]
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_show = sub.add_parser("show", help="pretty-print one sidecar")
    p_show.add_argument("path")
    p_show.add_argument(
        "--prometheus",
        action="store_true",
        help="emit Prometheus text exposition instead of the human view",
    )
    p_diff = sub.add_parser("diff", help="diff two sidecars")
    p_diff.add_argument("old")
    p_diff.add_argument("new")
    args = ap.parse_args(argv)
    if args.cmd == "show":
        show(args.path, prometheus=args.prometheus)
    else:
        diff(args.old, args.new)
    return 0


if __name__ == "__main__":
    sys.exit(main())
