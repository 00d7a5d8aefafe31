"""Metrics core: counters, gauges and span trees in one registry.

The part of the JAX package's `utils/metrics.py` that the port calls:
the batched verifiers, the host prover and verifier, the parse cache and
the native self-checks keep their counters and spans under the same
names. Histograms, trace contexts, the flight recorder, heartbeats and
the export plane come over when a port module needs them.

* One process-wide thread-safe ``Registry`` (``REGISTRY``) holding named
  counters and gauges, completed span trees and free-form metadata.
  Instruments are get-or-create by name.
* Counters and gauges are always live. Spans are recorded only after
  ``enable(True)``: the disabled ``span()`` is a single global check.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

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
            self._span_roots.clear()
            self._meta.clear()


REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)
