"""SLO engine: declarative service-level objectives over sliding windows.

Counterpart of `fabric_token_sdk_tpu/utils/slo.py`. Each SLO states
what fraction of events must be GOOD over a sliding window; the engine
evaluates it from the always-on instruments (histograms and counters:
nothing new is measured, only re-read), and the error-budget BURN rate
is the one number an operator needs: burn < 1 means the window is within
budget, burn >= 1 means the objective is being missed right now.

Objectives (targets via `FTS_SLO_*`, all optional):

    finality_p99   99% of submissions reach finality within
                   `FTS_SLO_FINALITY_P99_S` (default 1.0s), from
                   `network.submit_to_finality.seconds`
    commit_p99     99% of block commits complete within
                   `FTS_SLO_COMMIT_P99_S` (default 1.0s), from
                   `ledger.block.commit.seconds`
    availability   at least `FTS_SLO_AVAILABILITY` (default 0.999) of
                   submissions are admitted: bad = backpressure rejects
                   + breaker-open rejections, total = enqueued + rejects

A p99 <= T objective is evaluated as "fraction of window observations
<= T must be >= 0.99", computed from bucket-count DELTAS between
ring-buffered cumulative histogram states (`Histogram.state()`).
Burn = bad_frac / (1 - objective); budget_remaining = max(0, 1 - burn).

Surfaces: the `slo` section of `Network.health()`, `slo.burn.<slo>` /
`slo.budget.<slo>` gauges, a `slo.breaches` counter and one `slo.breach`
flight event per ok -> exhausted transition.

Slow-tx exemplars: a bounded ring of the `FTS_SLO_EXEMPLARS` (default
5) slowest submit-to-finality transactions, recorded by
`Submission._resolve` and published into registry meta
(`slo.exemplars`) with their tx and trace ids.
"""

from __future__ import annotations

import heapq
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import metrics as mx

DEFAULT_WINDOW_S = 60.0
DEFAULT_FINALITY_P99_S = 1.0
DEFAULT_COMMIT_P99_S = 1.0
DEFAULT_AVAILABILITY = 0.999

# the counters behind the availability objective (deltas over the window)
_CTR_ENQUEUED = "ledger.ordering.enqueued"
_CTR_BACKPRESSURE = "orderer.backpressure.rejects"
_CTR_BREAKER_REJECTED = "resilience.breaker.rejected"
_COUNTERS = (_CTR_ENQUEUED, _CTR_BACKPRESSURE, _CTR_BREAKER_REJECTED)

_HIST_FINALITY = "network.submit_to_finality.seconds"
_HIST_COMMIT = "ledger.block.commit.seconds"
_HISTS = (_HIST_FINALITY, _HIST_COMMIT)


def _env_num(name: str, default: float) -> float:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


class SLOEngine:
    """Sliding-window SLO evaluator over the process-wide registry.

    Lazily driven — no thread of its own: `evaluate()` (and the
    throttled `tick()` the ledger calls after each block commit)
    appends a timestamped cumulative state to a bounded ring, diffs the
    newest state against the one closest to `window_s` ago, and derives
    per-SLO burn. Evaluation touches only instrument locks, never the
    ledger or commit locks, so a health probe can never stall on it."""

    def __init__(self, window_s: Optional[float] = None,
                 finality_p99_s: Optional[float] = None,
                 commit_p99_s: Optional[float] = None,
                 availability: Optional[float] = None):
        self.window_s = max(
            1.0,
            _env_num("FTS_SLO_WINDOW_S", DEFAULT_WINDOW_S)
            if window_s is None else window_s,
        )
        self.finality_p99_s = (
            _env_num("FTS_SLO_FINALITY_P99_S", DEFAULT_FINALITY_P99_S)
            if finality_p99_s is None else finality_p99_s
        )
        self.commit_p99_s = (
            _env_num("FTS_SLO_COMMIT_P99_S", DEFAULT_COMMIT_P99_S)
            if commit_p99_s is None else commit_p99_s
        )
        self.availability = min(
            0.999999,
            _env_num("FTS_SLO_AVAILABILITY", DEFAULT_AVAILABILITY)
            if availability is None else availability,
        )
        self._lock = threading.Lock()
        # ring of (monotonic_t, {hist: (counts, count, sum)}, {ctr: value})
        self._ring: List[Tuple[float, dict, dict]] = []
        self._min_gap_s = max(0.25, self.window_s / 32.0)
        self._last_tick = 0.0
        self._last_ok: Dict[str, bool] = {}
        self._seed()

    def _seed(self) -> None:
        # seed the ring with the creation-time state so the FIRST
        # evaluation already has a baseline: until a full window has
        # passed, the "window" is everything since the engine was built
        # (engine construction, which is process start for ENGINE)
        hists, ctrs = self._capture()
        with self._lock:
            self._ring.append((time.monotonic(), hists, ctrs))

    # -- state capture ------------------------------------------------

    @staticmethod
    def _capture() -> Tuple[dict, dict]:
        hists = {}
        for name in _HISTS:
            h = mx.REGISTRY.histogram(name)
            hists[name] = (h.buckets,) + h.state()
        ctrs = {name: mx.REGISTRY.counter(name).value for name in _COUNTERS}
        return hists, ctrs

    def _append(self, now: float, hists: dict, ctrs: dict) -> None:
        with self._lock:
            if self._ring and now - self._ring[-1][0] < self._min_gap_s:
                return
            self._ring.append((now, hists, ctrs))
            # keep one state OLDER than the window as the delta baseline;
            # prune everything older than that
            cutoff = now - 1.5 * self.window_s
            while len(self._ring) > 2 and self._ring[1][0] < cutoff:
                self._ring.pop(0)

    def _baseline(self, now: float) -> Optional[Tuple[float, dict, dict]]:
        with self._lock:
            if not self._ring:
                return None
            base = self._ring[0]
            for entry in self._ring:
                if entry[0] <= now - self.window_s:
                    base = entry
                else:
                    break
            return base

    # -- evaluation ---------------------------------------------------

    def _latency_row(self, name: str, threshold: float,
                     now_h: dict, base_h: dict) -> dict:
        buckets, counts_n, count_n, _sum_n = now_h[name]
        _b, counts_b, count_b, _sum_b = base_h[name]
        delta = [a - b for a, b in zip(counts_n, counts_b)]
        total = count_n - count_b
        good_frac = mx.Histogram.fraction_le(buckets, delta, threshold)
        return self._row(0.99, good_frac, total, target_s=threshold)

    def _availability_row(self, now_c: dict, base_c: dict) -> dict:
        bad = (
            (now_c[_CTR_BACKPRESSURE] - base_c[_CTR_BACKPRESSURE])
            + (now_c[_CTR_BREAKER_REJECTED] - base_c[_CTR_BREAKER_REJECTED])
        )
        admitted = now_c[_CTR_ENQUEUED] - base_c[_CTR_ENQUEUED]
        total = admitted + (
            now_c[_CTR_BACKPRESSURE] - base_c[_CTR_BACKPRESSURE]
        )
        good_frac = (
            None if total <= 0 else max(0.0, 1.0 - bad / total)
        )
        return self._row(self.availability, good_frac, int(total))

    @staticmethod
    def _row(objective: float, good_frac: Optional[float], total: int,
             target_s: Optional[float] = None) -> dict:
        if good_frac is None:
            burn = 0.0  # no traffic in the window: nothing burned
            good_frac_out = None
        else:
            burn = (1.0 - good_frac) / (1.0 - objective)
            good_frac_out = round(good_frac, 6)
        row = {
            "objective": objective,
            "good_frac": good_frac_out,
            "total": max(0, int(total)),
            "burn": round(burn, 4),
            "budget_remaining": round(max(0.0, 1.0 - burn), 4),
            "ok": burn < 1.0,
        }
        if target_s is not None:
            row["target_s"] = target_s
        return row

    def evaluate(self) -> dict:
        """Evaluate every SLO over the sliding window; returns the
        `slo` section of `Network.health()`. Fires gauges, the
        `slo.breaches` counter and an `slo.breach` flight event on each
        ok -> exhausted transition."""
        now = time.monotonic()
        hists, ctrs = self._capture()
        self._append(now, hists, ctrs)
        base = self._baseline(now)
        if base is None:  # unreachable after the append above; defensive
            base = (now, hists, ctrs)
        _t, base_h, base_c = base
        slos = {
            "finality_p99": self._latency_row(
                _HIST_FINALITY, self.finality_p99_s, hists, base_h
            ),
            "commit_p99": self._latency_row(
                _HIST_COMMIT, self.commit_p99_s, hists, base_h
            ),
            "availability": self._availability_row(ctrs, base_c),
        }
        for name, row in slos.items():
            mx.gauge(f"slo.burn.{name}").set(row["burn"])
            mx.gauge(f"slo.budget.{name}").set(row["budget_remaining"])
            was_ok = self._last_ok.get(name, True)
            if was_ok and not row["ok"]:
                mx.counter("slo.breaches").inc()
                mx.flight(
                    "slo.breach", slo=name, burn=row["burn"],
                    good_frac=row["good_frac"], total=row["total"],
                    objective=row["objective"],
                )
            self._last_ok[name] = row["ok"]
        return {"window_s": self.window_s, "slos": slos}

    def tick(self) -> None:
        """Throttled evaluate — the ledger calls this after each block
        commit so breaches surface during load even when nothing polls
        `Network.health()`. At most one evaluation per second."""
        now = time.monotonic()
        if now - self._last_tick < 1.0:
            return
        self._last_tick = now
        self.evaluate()

    def health_section(self) -> dict:
        """The `slo` body of `Network.health()` (a fresh evaluation)."""
        return self.evaluate()

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._last_ok.clear()
            self._last_tick = 0.0
        self._seed()


ENGINE = SLOEngine()


def reset(**kwargs) -> SLOEngine:
    """Rebuild the process-wide engine (re-reading `FTS_SLO_*` env) and
    clear the exemplar ring — test isolation, like `faults.clear()`."""
    global ENGINE
    ENGINE = SLOEngine(**kwargs)
    with _ex_lock:
        _ex_heap.clear()
    return ENGINE


# ------------------------------------------------------------ exemplars

_ex_lock = threading.Lock()
# min-heap of (seconds, seq, tx_id, trace_id): the K slowest stay, the
# heap root is the fastest of the kept set and the eviction candidate
_ex_heap: List[Tuple[float, int, str, Optional[str]]] = []
_ex_seq = 0


def _exemplar_k() -> int:
    try:
        return max(0, int(os.environ.get("FTS_SLO_EXEMPLARS", "5")))
    except ValueError:
        return 5


def record_exemplar(seconds: float, tx_id: str,
                    trace_id: Optional[str]) -> None:
    """Offer one submit-to-finality observation to the slow-tx ring.
    Keeps the K slowest; publishes to registry meta only when the kept
    set actually changes (so the common fast path is one lock + one
    heap peek)."""
    global _ex_seq
    k = _exemplar_k()
    if k <= 0:
        return
    with _ex_lock:
        if len(_ex_heap) >= k and seconds <= _ex_heap[0][0]:
            return
        _ex_seq += 1
        heapq.heappush(_ex_heap, (seconds, _ex_seq, tx_id, trace_id))
        while len(_ex_heap) > k:
            heapq.heappop(_ex_heap)
        top = sorted(_ex_heap, reverse=True)
    mx.REGISTRY.set_meta(
        "slo.exemplars",
        [[round(s, 6), tx, tr] for s, _q, tx, tr in top],
    )


def exemplars() -> List[Tuple[float, str, Optional[str]]]:
    """The current K slowest (seconds, tx_id, trace_id), slowest first."""
    with _ex_lock:
        top = sorted(_ex_heap, reverse=True)
    return [(s, tx, tr) for s, _q, tx, tr in top]
