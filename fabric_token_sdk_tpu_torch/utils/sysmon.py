"""Process and card memory telemetry for the live ops plane.

Counterpart of `fabric_token_sdk_tpu/utils/sysmon.py`. Post-mortem
sidecars answer "where did the time go"; this module answers "how much
memory is this node holding", live, cheaply, and without perturbing the
data plane:

* **Host**: current RSS from ``/proc/self/statm`` (peak from
  ``getrusage``), exported as the ``proc.rss.bytes`` /
  ``proc.rss.peak.bytes`` gauges.
* **Device**: the bytes the CUDA caching allocator holds allocated on
  every visible card (``torch.cuda.memory_allocated``), exported as
  ``device.mem.bytes`` / ``device.mem.peak.bytes``.
* **Safety invariant**: sampling never initializes CUDA. In a process
  that has not touched the card (``torch.cuda.is_initialized()`` false,
  or torch not imported) the device reading is None.
* **Stage-runner high-water** (``sample_stages``): every kernel wrapper
  of `ops/stages.py` calls it as it routes a batch; it is throttled to
  one real sample per ``MIN_SAMPLE_INTERVAL_S`` and keeps the
  ``stages.mem.*`` high-water gauges: the peak footprint the data plane
  reached.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

from . import metrics as mx

# the reference's FTS_MEM_SAMPLE_S default: at most one stage sample a
# half second
MIN_SAMPLE_INTERVAL_S = 0.5

try:
    _PAGE = os.sysconf("SC_PAGE_SIZE")
except (AttributeError, ValueError, OSError):
    _PAGE = 4096


def host_rss_bytes() -> int:
    """Current resident set size in bytes (0 if unreadable)."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return host_rss_peak_bytes()  # non-/proc platforms: peak is all we have


def host_rss_peak_bytes() -> int:
    """Peak RSS in bytes (``ru_maxrss`` is KiB on Linux)."""
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return 0


def device_memory_bytes() -> Optional[int]:
    """Bytes the CUDA caching allocator holds allocated, summed over every
    visible card, or None when torch is not imported or CUDA is not
    initialized in this process. Never initializes CUDA."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None  # nothing on the card yet: do not create a context
        return sum(int(torch.cuda.memory_allocated(i))
                   for i in range(torch.cuda.device_count()))
    except Exception:
        return None


def sample() -> dict:
    """Take one memory sample and publish the process-wide gauges
    (`proc.rss.bytes`, `proc.rss.peak.bytes`, `device.mem.bytes`,
    `device.mem.peak.bytes`). Returns the raw readings."""
    rss = host_rss_bytes()
    peak = host_rss_peak_bytes()
    mx.gauge("proc.rss.bytes").set(rss)
    if peak:
        mx.gauge("proc.rss.peak.bytes").set(peak)
    out = {"rss_bytes": rss, "rss_peak_bytes": peak}
    dev = device_memory_bytes()
    out["device_bytes"] = dev
    if dev is not None:
        mx.gauge("device.mem.bytes").set(dev)
        g = mx.gauge("device.mem.peak.bytes")
        if dev > g.value:
            g.set(dev)
    return out


_lock = threading.Lock()
_last_stage_sample = 0.0


def sample_stages() -> Optional[dict]:
    """Throttled sampling hook of the stage runner: at most one real
    sample per `MIN_SAMPLE_INTERVAL_S`, maintaining the `stages.mem.*`
    high-water gauges. Returns the sample, or None when throttled."""
    global _last_stage_sample
    now = time.monotonic()
    with _lock:
        if now - _last_stage_sample < MIN_SAMPLE_INTERVAL_S:
            return None
        _last_stage_sample = now
    s = sample()
    dev = s.get("device_bytes")
    if dev is not None:
        mx.gauge("stages.mem.device.bytes").set(dev)
        hw = mx.gauge("stages.mem.high_water.bytes")
        if dev > hw.value:
            hw.set(dev)
    rss_hw = mx.gauge("stages.mem.rss_high_water.bytes")
    if s["rss_bytes"] > rss_hw.value:
        rss_hw.set(s["rss_bytes"])
    return s
