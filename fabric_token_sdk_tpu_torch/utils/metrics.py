"""Metrics core: counters, gauges, histograms, span trees and the phase
timeline in one registry, the flight recorder, and the export plane.

Counterpart of the JAX package's `utils/metrics.py`: the batched
verifiers, the host prover and verifier, the parse caches, the native
self-checks, the dispatch ledger (`utils/devobs.py`), the mesh plane
(`parallel/sharding.py`), the host-path profiler (`utils/profiler.py`),
the SLO engine (`utils/slo.py`), the block validation path, the remote
node and its replication plane (`services/network/`) keep their
instruments under the same names, and the operator tools
(`cmd/ftsmetrics.py`, `ftstop.py`, `ftstrace.py`) read them.

* One process-wide thread-safe ``Registry`` (``REGISTRY``) holding named
  counters, gauges and histograms, completed span trees and free-form
  metadata. Instruments are get-or-create by name.
* Counters and gauges are always live. Spans are recorded only after
  ``enable(True)``: the disabled ``span()`` is a single global check.
* Trace contexts: ``new_trace()`` mints a ``trace_id``; ``use_trace(ctx)``
  activates it for the thread; spans opened under it carry
  ``trace_id``/``span_id``/``parent_span_id``, so the work a group-commit
  thread does for another submitter's tx lands in that tx's trace.
  ``TraceContext.to_wire``/``from_wire`` is the format the remote node
  (`services/network/remote.py`) carries in its request frames.
* The flight recorder (``FLIGHT`` / ``flight(kind, ...)``) is an
  always-on bounded ring of structured events (mesh clamps, degrades,
  submits, block cuts, verify decisions, WAL appends, faults), each
  tagged with the active or the passed trace id.
* Export: ``Registry.snapshot()``/``to_json()`` (the ``*.metrics.json``
  sidecar format, and the body of the node's ``ops.metrics`` RPC, with
  p50/p95/p99 a histogram); ``flush_sidecar`` writes it and the flight
  ring's ``*.flight.json``, ``install_sidecar`` does so at exit and on
  SIGTERM/SIGINT; ``to_prometheus()`` is the text exposition format
  (counters, gauges, histograms with their quantile series).
* ``Heartbeat`` prints phase-stamped progress lines from a daemon thread
  and records the phase timeline (the snapshot's ``phases``).
* ``logger`` is the port's logger (the reference's `utils/tracing.logger`).
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import logging
import os
import signal
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger("fts_torch")

_enabled = False


def enabled() -> bool:
    return _enabled


def enable(flag: bool = True) -> None:
    """Turn span recording on or off."""
    global _enabled
    _enabled = flag


# ------------------------------------------------------------ instruments


class Counter:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value


# Latency buckets sized for this codebase: sub-ms host ops up through
# multi-minute pairing batches.
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)


# Quantile labels every histogram exports (the snapshot's keys): the
# latency numbers the node's `ops.metrics` RPC serves.
QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


class Histogram:
    """Counts of observations per bucket (`DEFAULT_BUCKETS` unless the
    first creator names others, plus +Inf), their count, sum, min and
    max. The SLO engine (`utils/slo.py`) diffs `state()` copies and
    reads the share of a window under a bound with `fraction_le`;
    `quantile` and `snapshot` serve the ops plane."""

    __slots__ = ("name", "buckets", "_counts", "_count", "_sum", "_min", "_max", "_lock")

    def __init__(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +inf bucket
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @staticmethod
    def _interp(q: float, buckets, counts, total: int, lo: float, hi: float) -> float:
        """Bucket-interpolated quantile (Prometheus `histogram_quantile`
        style): the bucket where the cumulative count crosses rank
        ``q*total``, linearly between its bounds, clamped to the observed
        ``[min, max]`` (a single observation reports itself). A rank in
        the +Inf bucket reports the observed max."""
        rank = q * total
        cum, prev = 0, 0.0
        for b, c in zip(buckets, counts):
            if c and cum + c >= rank:
                v = prev + (b - prev) * (rank - cum) / c
                return min(max(v, lo), hi)
            cum += c
            prev = b
        return hi

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the q-quantile (0 < q < 1); None when empty."""
        with self._lock:
            if not self._count:
                return None
            counts = list(self._counts)
            total, lo, hi = self._count, self._min, self._max
        return self._interp(q, self.buckets, counts, total, lo, hi)

    def state(self) -> tuple:
        """`(counts, count, sum)`: a consistent copy of the cumulative
        state, which sliding-window readers diff between two instants."""
        with self._lock:
            return list(self._counts), self._count, self._sum

    @staticmethod
    def fraction_le(buckets, counts, threshold: float) -> Optional[float]:
        """Fraction of observations <= `threshold` given per-bucket
        counts (typically a window's delta of two `state()` copies),
        interpolating linearly inside the bucket the threshold falls in.
        None when the counts are empty: no data is not all-good."""
        total = sum(counts)
        if total <= 0:
            return None
        good = 0.0
        prev = 0.0
        for b, c in zip(buckets, counts):
            if threshold >= b:
                good += c
                prev = b
                continue
            if threshold > prev and c:
                good += c * (threshold - prev) / (b - prev)
            break
        return min(1.0, good / total)

    def snapshot(self) -> dict:
        # timed acquire: may run under a signal handler (see Registry)
        acquired = self._lock.acquire(timeout=1.0)
        try:
            d = {
                "count": self._count,
                "sum": round(self._sum, 6),
                "buckets": {("%g" % b): c for b, c in zip(self.buckets, self._counts) if c},
            }
            if self._counts[-1]:
                d["buckets"]["+Inf"] = self._counts[-1]
            if self._count:
                d["min"] = round(self._min, 6)
                d["max"] = round(self._max, 6)
                d["mean"] = round(self._sum / self._count, 6)
                counts = list(self._counts)
                for label, q in QUANTILES:
                    d[label] = round(self._interp(q, self.buckets, counts, self._count,
                                                  self._min, self._max), 6)
            return d
        finally:
            if acquired:
                self._lock.release()


# ------------------------------------------------------------ span trees


@dataclass
class Span:
    name: str
    start: float  # monotonic
    end: Optional[float] = None
    attrs: dict = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)
    # trace plane: wall-clock anchor and ids for stitching across threads
    start_unix: float = 0.0
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else time.monotonic()) - self.start

    def to_dict(self) -> dict:
        d = {"name": self.name, "duration_s": round(self.duration, 6)}
        if self.start_unix:
            d["start_unix"] = round(self.start_unix, 6)
        if self.trace_id:
            d["trace_id"] = self.trace_id
        if self.span_id:
            d["span_id"] = self.span_id
        if self.parent_span_id:
            d["parent_span_id"] = self.parent_span_id
        if self.attrs:
            d["attrs"] = {k: _jsonable(v) for k, v in self.attrs.items()}
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


_tls = threading.local()


# ------------------------------------------------------------ trace context


def _new_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


@dataclass
class TraceContext:
    """Trace identity: ``trace_id`` names one end-to-end transaction;
    ``span_id`` is the id new child spans adopt as their parent.
    ``to_wire()``/``from_wire()`` is the cross-process format the remote
    node carries in request frames (the JAX package's)."""

    trace_id: str
    span_id: str = ""

    def to_wire(self) -> list:
        return [self.trace_id, self.span_id]

    @classmethod
    def from_wire(cls, wire) -> Optional["TraceContext"]:
        if not wire:
            return None
        try:
            return cls(str(wire[0]), str(wire[1]) if len(wire) > 1 else "")
        except (TypeError, KeyError, IndexError):
            return None


def new_trace() -> TraceContext:
    """Mint a fresh trace context. Always available: trace ids tag
    flight-recorder events even when span recording is disabled."""
    REGISTRY.counter("trace.traces").inc()
    return TraceContext(_new_id(8), _new_id(4))


def current_trace() -> Optional[TraceContext]:
    """The thread's active trace context: derived from the innermost
    open span when it belongs to the `use_trace`-activated trace (so new
    children nest), else the activation itself. An explicit `use_trace`
    of a DIFFERENT trace overrides enclosing spans: that is what lets a
    group-commit thread attribute per-tx work to each submitter's trace
    while its own spans stay open."""
    ctx = getattr(_tls, "trace", None)
    stack = getattr(_tls, "stack", None)
    if stack:
        s = stack[-1]
        if s.trace_id and (ctx is None or ctx.trace_id == s.trace_id):
            return TraceContext(s.trace_id, s.span_id)
    return ctx


@contextlib.contextmanager
def use_trace(ctx: Optional[TraceContext]):
    """Activate `ctx` for this thread (None is a no-op): spans opened and
    flight events recorded inside join the trace."""
    if ctx is None:
        yield None
        return
    prev = getattr(_tls, "trace", None)
    _tls.trace = ctx
    try:
        yield ctx
    finally:
        _tls.trace = prev


@contextlib.contextmanager
def span(name: str, **attrs):
    """Timed span; nests into the thread's open span, inherits the active
    trace context and observes its duration into histogram
    ``<name>.seconds``. No-op (yields None) when spans are disabled."""
    if not _enabled:
        yield None
        return
    s = Span(name, time.monotonic(), attrs=attrs)
    s.start_unix = time.time()
    s.span_id = _new_id(4)
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    parent = stack[-1] if stack else None
    # trace linkage: the parent's trace when it is the active one (or
    # none is active); an explicitly activated DIFFERENT trace wins
    ctx = getattr(_tls, "trace", None)
    if parent is not None and parent.trace_id and (
        ctx is None or ctx.trace_id == parent.trace_id
    ):
        s.trace_id = parent.trace_id
        s.parent_span_id = parent.span_id
    elif ctx is not None:
        s.trace_id = ctx.trace_id
        s.parent_span_id = ctx.span_id
    if s.trace_id:
        REGISTRY.counter("trace.spans").inc()
    stack.append(s)
    try:
        yield s
    finally:
        s.end = time.monotonic()
        stack.pop()
        if parent is not None:
            parent.children.append(s)
        else:
            REGISTRY.record_span_root(s)
        REGISTRY.histogram(name + ".seconds").observe(s.duration)


def record_span(name: str, start_unix: float, end_unix: float,
                trace: Optional[TraceContext] = None, **attrs) -> Optional[Span]:
    """Record an already-timed root span (work measured across threads,
    such as a submission's queue wait stamped at block cut). Gated like
    `span`."""
    if not _enabled:
        return None
    s = Span(name, 0.0, end=max(0.0, end_unix - start_unix), attrs=attrs)
    s.start_unix = start_unix
    s.span_id = _new_id(4)
    if trace is not None:
        s.trace_id = trace.trace_id
        s.parent_span_id = trace.span_id
        REGISTRY.counter("trace.spans").inc()
    REGISTRY.record_span_root(s)
    REGISTRY.histogram(name + ".seconds").observe(s.duration)
    return s


# ------------------------------------------------------------ registry


class Registry:
    """Thread-safe named-instrument store."""

    MAX_SPAN_ROOTS = 2000

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._span_roots: List[Span] = []
        self._phases: List[dict] = []
        self._meta: Dict[str, object] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        """Get-or-create by name; `buckets` applies only on FIRST creation."""
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name, buckets))
        return h

    def record_span_root(self, s: Span) -> None:
        with self._lock:
            self._span_roots.append(s)
            if len(self._span_roots) > self.MAX_SPAN_ROOTS:
                del self._span_roots[: self.MAX_SPAN_ROOTS // 2]

    MAX_PHASES = 500

    def record_phase(self, name: str, start: float, end: Optional[float], **attrs) -> None:
        """One row of the phase timeline: `name`, its wall-clock start and,
        once it ended, its elapsed seconds (what `Heartbeat` records)."""
        row = {"name": name, "start_unix": round(start, 3)}
        if end is not None:
            row["elapsed_s"] = round(end - start, 3)
        if attrs:
            row["attrs"] = {k: _jsonable(v) for k, v in attrs.items()}
        with self._lock:
            self._phases.append(row)
            if len(self._phases) > self.MAX_PHASES:
                del self._phases[: self.MAX_PHASES // 2]

    def set_meta(self, key: str, value) -> None:
        with self._lock:
            self._meta[key] = value

    def meta(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._meta)

    def span_summary(self) -> Dict[str, dict]:
        """Aggregate completed span trees by name (depth-first)."""
        agg: Dict[str, dict] = {}

        def walk(s: Span):
            a = agg.setdefault(s.name, {"count": 0, "total_s": 0.0})
            a["count"] += 1
            a["total_s"] += s.duration
            for c in s.children:
                walk(c)

        # timed acquire: may run under a signal handler (see snapshot)
        acquired = self._lock.acquire(timeout=1.0)
        try:
            roots = list(self._span_roots)
        finally:
            if acquired:
                self._lock.release()
        for s in roots:
            walk(s)
        for a in agg.values():
            a["total_s"] = round(a["total_s"], 6)
        return agg

    def snapshot(self) -> dict:
        """Everything the registry holds, JSON-ready: the sidecar format
        and the body of the `ops.metrics` RPC."""
        # timed acquire: flush_sidecar() runs from signal handlers, which
        # can interrupt a thread that already holds this (non-reentrant)
        # lock; fall back to a best-effort unlocked read over deadlock
        acquired = self._lock.acquire(timeout=1.0)
        try:
            counters = {n: c.value for n, c in sorted(self._counters.items())}
            gauges = {n: g.value for n, g in sorted(self._gauges.items())}
            hists = dict(sorted(self._histograms.items()))
            meta = {k: _jsonable(v) for k, v in self._meta.items()}
            roots = list(self._span_roots)
            phases = list(self._phases)
        finally:
            if acquired:
                self._lock.release()
        return {
            "meta": meta,
            "pid": os.getpid(),
            "flushed_unix": round(time.time(), 3),
            "phases": phases,
            "counters": counters,
            "gauges": gauges,
            "histograms": {n: h.snapshot() for n, h in hists.items()},
            "span_summary": self.span_summary(),
            "spans": [s.to_dict() for s in roots[-200:]],
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=False)

    def to_prometheus(self) -> str:
        """Text exposition format: counters, gauges and histograms (with
        their p50/p95/p99 as companion series), names sanitized to
        `fts_[a-z0-9_]`."""
        lines: List[str] = []
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._histograms.items())
        for name, c in counters:
            m = _prom_name(name)
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {c.value}")
        for name, g in gauges:
            m = _prom_name(name)
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_prom_num(g.value)}")
        for name, h in hists:
            m = _prom_name(name)
            lines.append(f"# TYPE {m} histogram")
            cum = 0
            with h._lock:
                counts = list(h._counts)
                total, s = h._count, h._sum
                lo, hi = h._min, h._max
            for b, n in zip(h.buckets, counts):
                cum += n
                lines.append(f'{m}_bucket{{le="{_prom_num(b)}"}} {cum}')
            cum += counts[-1]
            lines.append(f'{m}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{m}_sum {_prom_num(s)}")
            lines.append(f"{m}_count {total}")
            if total:
                for label, q in QUANTILES:
                    v = Histogram._interp(q, h.buckets, counts, total, lo, hi)
                    lines.append(f"{m}_{label} {_prom_num(round(v, 9))}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._span_roots.clear()
            self._phases.clear()
            self._meta.clear()


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() else "_" for c in name.lower())
    if out and out[0].isdigit():
        out = "_" + out
    return "fts_" + out


def _prom_num(v: float) -> str:
    return ("%d" % v) if float(v).is_integer() else repr(float(v))


REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, buckets)


@contextlib.contextmanager
def timed(hist_name: str):
    """Observe the block's wall time into a histogram (gated like span)."""
    if not _enabled:
        yield
        return
    t0 = time.monotonic()
    try:
        yield
    finally:
        REGISTRY.histogram(hist_name).observe(time.monotonic() - t0)


# ------------------------------------------------------------ heartbeat


class Heartbeat:
    """Phase-stamped progress lines on a stream (stderr by default) from a
    daemon thread, ``[fts] phase=warmup elapsed=14s total=20s``, every
    `interval_s` seconds (the reference's `FTS_HEARTBEAT_SECS` default).

    Each completed phase is recorded in the registry's phase timeline
    (stamped with the process's RSS, and the card's allocated bytes where
    CUDA is initialized, as it ended), so a sidecar flushed at death says
    where the time went; every phase change is a flight event. Lines and
    phase rows are gated like spans (`enable`)."""

    def __init__(self, tag: str = "fts", interval_s: float = 15.0, stream=None):
        self.tag = tag
        self.interval_s = interval_s
        self.stream = stream if stream is not None else sys.stderr
        self._t0 = time.time()
        self._phase = "init"
        self._phase_start = self._t0
        self._attrs: dict = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def set_phase(self, name: str, **attrs) -> None:
        now = time.time()
        with self._lock:
            prev, prev_start, prev_attrs = self._phase, self._phase_start, self._attrs
            self._phase, self._phase_start, self._attrs = name, now, attrs
        FLIGHT.record("phase", phase=name, **attrs)
        if _enabled:
            done_attrs = dict(prev_attrs)
            try:
                from . import sysmon

                mem = sysmon.sample()
                done_attrs.setdefault("rss_mb", round(mem["rss_bytes"] / 1e6, 1))
                if mem.get("device_bytes") is not None:
                    done_attrs.setdefault("dev_mem_mb", round(mem["device_bytes"] / 1e6, 1))
            except Exception:
                pass  # telemetry must never break a phase change
            REGISTRY.record_phase(prev, prev_start, now, **done_attrs)
            REGISTRY.gauge("progress.phase_start_unix").set(now)
            REGISTRY.set_meta("progress.phase", name)
        self.emit()

    def emit(self) -> None:
        if not _enabled:
            return
        with self._lock:
            phase, phase_start, attrs = self._phase, self._phase_start, self._attrs
        now = time.time()
        extra = "".join(f" {k}={_jsonable(v)}" for k, v in attrs.items())
        try:
            print(f"[{self.tag}] phase={phase}{extra} elapsed={now - phase_start:.0f}s "
                  f"total={now - self._t0:.0f}s", file=self.stream, flush=True)
        except Exception:
            pass  # the stream may be gone at interpreter teardown

    def start(self) -> "Heartbeat":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="fts-heartbeat", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.emit()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            phase, phase_start, attrs = self._phase, self._phase_start, self._attrs
        if _enabled:
            REGISTRY.record_phase(phase, phase_start, time.time(), **attrs)


# ------------------------------------------------------------ flight recorder


class FlightRecorder:
    """Bounded ring of structured lifecycle events, always on (one lock
    and a deque append on rare events); the oldest events go first."""

    def __init__(self, capacity: int = 1024):
        self.capacity = max(1, capacity)
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    def record(self, kind: str, trace: Optional[TraceContext] = None, **attrs) -> None:
        ctx = trace if trace is not None else current_trace()
        evt = {"ts": round(time.time(), 6), "kind": kind}
        if ctx is not None:
            evt["trace_id"] = ctx.trace_id
        evt.update((k, _jsonable(v)) for k, v in attrs.items() if v is not None)
        with self._lock:
            self._ring.append(evt)
        REGISTRY.counter("flight.events").inc()

    def tail(self, n: Optional[int] = None) -> List[dict]:
        # timed acquire: dump() may run under a signal handler that
        # interrupted the thread holding the lock; then read unlocked,
        # retrying a read a concurrent append invalidated
        acquired = self._lock.acquire(timeout=1.0)
        try:
            if acquired:
                events = list(self._ring)
            else:
                events = []
                for _ in range(3):
                    try:
                        events = list(self._ring)
                        break
                    except RuntimeError:
                        continue
        finally:
            if acquired:
                self._lock.release()
        return events if n is None else events[-n:]

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def dump(self, path: str) -> Optional[str]:
        """Write the ring to `path` (atomic rename); returns the path, or
        None on failure. Never raises: a SIGTERM flush must not die
        building its own payload."""
        try:
            payload = json.dumps({"dumped_unix": round(time.time(), 3), "pid": os.getpid(),
                                  "capacity": self.capacity, "events": self.tail()})
        except Exception:
            return None
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as fh:
                fh.write(payload)
            os.replace(tmp, path)
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        REGISTRY.counter("flight.dumps").inc()
        return path


FLIGHT = FlightRecorder()


def flight(kind: str, trace: Optional[TraceContext] = None, **attrs) -> None:
    """Record one flight-recorder event (tags the active, or the passed,
    trace context)."""
    FLIGHT.record(kind, trace=trace, **attrs)


def flight_sidecar_path(metrics_path: str) -> str:
    """The flight sidecar beside a metrics sidecar (``X.metrics.json``
    -> ``X.flight.json``)."""
    if metrics_path.endswith(".metrics.json"):
        return metrics_path[: -len(".metrics.json")] + ".flight.json"
    return metrics_path + ".flight.json"


# ------------------------------------------------------------ sidecar


_sidecar_lock = threading.Lock()
_sidecar_path: Optional[str] = None
_sidecar_installed = False


def flush_sidecar(path: Optional[str] = None) -> Optional[str]:
    """Write the registry snapshot to the sidecar JSON (atomic rename)
    and the flight ring to the derived ``*.flight.json``. Safe from
    signal handlers; returns the metrics path written, or None when no
    path is configured or the write failed."""
    p = path or _sidecar_path
    if not p:
        return None
    payload = REGISTRY.to_json()
    acquired = _sidecar_lock.acquire(timeout=2.0)  # may run under a signal
    try:
        tmp = f"{p}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as fh:
                fh.write(payload)
            os.replace(tmp, p)
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
    finally:
        if acquired:
            _sidecar_lock.release()
    FLIGHT.dump(flight_sidecar_path(p))
    return p


def install_sidecar(path: str,
                    signals: Sequence[int] = (signal.SIGTERM, signal.SIGINT)) -> None:
    """Flush a metrics sidecar at normal exit and on SIGTERM/SIGINT; the
    handlers then re-raise the signal with its default disposition, so
    the exit code still reflects the kill."""
    global _sidecar_path, _sidecar_installed
    _sidecar_path = path
    if _sidecar_installed:
        return
    _sidecar_installed = True
    atexit.register(flush_sidecar)

    def _on_signal(signum, frame):
        REGISTRY.set_meta("killed_by_signal", signum)
        flush_sidecar()
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    for sig in signals:
        try:
            signal.signal(sig, _on_signal)
        except (ValueError, OSError):
            pass  # not the main thread, or an unsupported platform
