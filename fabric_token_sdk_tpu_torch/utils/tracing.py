"""Span tracing facade over the metrics core (``utils/metrics.py``).

Counterpart of `fabric_token_sdk_tpu/utils/tracing.py`. ``tracer.span``
and ``tracer.count`` feed the process-wide metrics registry; there is
one span model, `metrics.Span`, with its ``trace_id`` / ``span_id`` /
``parent_span_id`` (``Span``, ``TraceContext``, ``new_trace``,
``current_trace`` and ``use_trace`` are re-exported below). ``logger``
is the port's logger, the same object as ``metrics.logger``.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from . import metrics

logger = logging.getLogger("fts_torch")

# re-exported: one span model and one id scheme, metrics.py's
Span = metrics.Span
TraceContext = metrics.TraceContext
new_trace = metrics.new_trace
current_trace = metrics.current_trace
use_trace = metrics.use_trace


class Tracer:
    """The Tracer API over the shared registry."""

    @property
    def enabled(self) -> bool:
        return metrics.enabled()

    @enabled.setter
    def enabled(self, flag: bool) -> None:
        metrics.enable(flag)

    def span(self, name: str, **attrs):
        return metrics.span(name, **attrs)

    def count(self, name: str, n: int = 1) -> None:
        metrics.counter(name).inc(n)

    def current_trace(self) -> Optional[metrics.TraceContext]:
        return metrics.current_trace()

    def summary(self) -> Dict[str, dict]:
        return metrics.REGISTRY.span_summary()

    def reset(self) -> None:
        metrics.REGISTRY.reset()


tracer = Tracer()
