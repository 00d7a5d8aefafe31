"""Metrics core: counters, gauges, histograms and span trees in one
registry, and the flight recorder.

The part of the JAX package's `utils/metrics.py` that the port calls:
the batched verifiers, the host prover and verifier, the parse caches,
the native self-checks, the dispatch ledger (`utils/devobs.py`), the
mesh plane (`parallel/sharding.py`), the host-path profiler
(`utils/profiler.py`), the SLO engine (`utils/slo.py`) and the block
validation path (`services/network/`) keep their instruments under the
same names. Heartbeats, sidecars and the JSON and Prometheus export
come over when a port module needs them.

* One process-wide thread-safe ``Registry`` (``REGISTRY``) holding named
  counters, gauges and histograms, completed span trees and free-form
  metadata. Instruments are get-or-create by name.
* Counters and gauges are always live. Spans are recorded only after
  ``enable(True)``: the disabled ``span()`` is a single global check.
* Trace contexts: ``new_trace()`` mints a ``trace_id``; ``use_trace(ctx)``
  activates it for the thread; spans opened under it carry
  ``trace_id``/``span_id``/``parent_span_id``, so the work a group-commit
  thread does for another submitter's tx lands in that tx's trace.
* The flight recorder (``FLIGHT`` / ``flight(kind, ...)``) is an
  always-on bounded ring of structured events (mesh clamps, degrades,
  submits, block cuts, verify decisions, WAL appends, faults), each
  tagged with the active or the passed trace id.
* ``logger`` is the port's logger (the reference's `utils/tracing.logger`).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
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

    @property
    def value(self) -> float:
        return self._value


# Latency buckets sized for this codebase: sub-ms host ops up through
# multi-minute pairing batches.
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)


class Histogram:
    """Counts of observations per bucket (`DEFAULT_BUCKETS` unless the
    first creator names others, plus +Inf), their count and sum. The SLO
    engine (`utils/slo.py`) diffs `state()` copies and reads the share of
    a window under a bound with `fraction_le`; quantiles and export come
    with the port's export plane."""

    __slots__ = ("name", "buckets", "_counts", "_count", "_sum", "_lock")

    def __init__(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +inf bucket
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += v
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

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


_tls = threading.local()


# ------------------------------------------------------------ trace context


def _new_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


@dataclass
class TraceContext:
    """Trace identity: ``trace_id`` names one end-to-end transaction;
    ``span_id`` is the id new child spans adopt as their parent."""

    trace_id: str
    span_id: str = ""


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

        with self._lock:
            roots = list(self._span_roots)
        for s in roots:
            walk(s)
        for a in agg.values():
            a["total_s"] = round(a["total_s"], 6)
        return agg

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._span_roots.clear()
            self._meta.clear()


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


# ------------------------------------------------------------ flight recorder


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


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
        with self._lock:
            events = list(self._ring)
        return events if n is None else events[-n:]

    def __len__(self) -> int:
        return len(self._ring)


FLIGHT = FlightRecorder()


def flight(kind: str, trace: Optional[TraceContext] = None, **attrs) -> None:
    """Record one flight-recorder event (tags the active, or the passed,
    trace context)."""
    FLIGHT.record(kind, trace=trace, **attrs)
