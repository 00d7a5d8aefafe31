"""Metrics core: counters, gauges, histograms and span trees in one
registry, and the flight recorder.

The part of the JAX package's `utils/metrics.py` that the port calls:
the batched verifiers, the host prover and verifier, the parse caches,
the native self-checks, the dispatch ledger (`utils/devobs.py`), the
mesh plane (`parallel/sharding.py`) and the host-path profiler
(`utils/profiler.py`) keep their instruments under the same names.
Trace contexts, heartbeats and the export plane come over when a port
module needs them.

* One process-wide thread-safe ``Registry`` (``REGISTRY``) holding named
  counters, gauges and histograms, completed span trees and free-form
  metadata. Instruments are get-or-create by name.
* Counters and gauges are always live. Spans are recorded only after
  ``enable(True)``: the disabled ``span()`` is a single global check.
* The flight recorder (``FLIGHT`` / ``flight(kind, ...)``) is an
  always-on bounded ring of structured events (mesh clamps, degrades).
* ``logger`` is the port's logger (the reference's `utils/tracing.logger`).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

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
    """Counts of observations per latency bucket (`DEFAULT_BUCKETS`
    plus +Inf). Written by the host-path profiler; its quantiles and
    export come with the port's export plane."""

    __slots__ = ("name", "buckets", "_counts", "_count", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.buckets = DEFAULT_BUCKETS
        self._counts = [0] * (len(self.buckets) + 1)  # +inf bucket
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count


# ------------------------------------------------------------ span trees


@dataclass
class Span:
    name: str
    start: float  # monotonic
    end: Optional[float] = None
    attrs: dict = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else time.monotonic()) - self.start


_tls = threading.local()


@contextlib.contextmanager
def span(name: str, **attrs):
    """Timed span; nests into the thread's open span. No-op (yields
    None) when spans are disabled."""
    if not _enabled:
        yield None
        return
    s = Span(name, time.monotonic(), attrs=attrs)
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    parent = stack[-1] if stack else None
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

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name))
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


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


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

    def record(self, kind: str, **attrs) -> None:
        evt = {"ts": round(time.time(), 6), "kind": kind}
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


def flight(kind: str, **attrs) -> None:
    """Record one flight-recorder event."""
    FLIGHT.record(kind, **attrs)
