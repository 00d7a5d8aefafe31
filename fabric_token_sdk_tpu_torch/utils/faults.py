"""Fault injection: named fault points armed via env or API.

Counterpart of `fabric_token_sdk_tpu/utils/faults.py`. The durability
and recovery guarantees of the ledger (WAL and snapshot recovery, the
degrade of a failed or hung device plane to host verification) are only
credible when exercised under injected faults; this module is the lever
the port's chaos tests pull. Production code calls `faults.fire("<site>")`
at crash-interesting boundaries; nothing happens unless a fault is armed
for that site.

Sites in the port (grep for `faults.fire` to confirm the live set):

    wal.append           before a WAL record is written + fsync'd
    ledger.commit_block  before the block's WAL append / atomic merge
    orderer.cut          before a block is cut from the ordering queue
    batch.verify         inside the device-plane block verify (degrades
                         to host validation, never fails the block)
    batch.sign           inside the batched signature verify (degrades
                         every signature row to the host loop, never
                         fails the block)
    repl.apply           at the start of `Network.apply_delta`
    repl.ship            on a leader's link thread, before it ships a
                         record (degrades that link, never the commit)
    repl.heartbeat       on a leader's link thread, before a heartbeat
    remote.send          in `RemoteNetwork._call`, before a frame is sent
    remote.recv          in `RemoteNetwork._call`, before the answer is
                         read (a drop there races the server's commit)

Arming:

* Env: ``FTS_FAULTS="site:kind:prob[:count[:delay_s]]"``, comma-separated
  for multiple sites; parsed once at import and re-parseable via
  ``load_env()``. Example: ``FTS_FAULTS="batch.verify:error:1.0:1"``
  fails the device verify exactly once, with probability 1.
* Programmatic: ``faults.arm("wal.append", "error", prob=0.5, count=3)``.

Kinds: ``error`` raises ``FaultInjected``; ``drop`` raises
``FaultConnectionDrop`` (a ``ConnectionError``); ``delay`` sleeps
``delay_s`` then returns; ``hang`` BLOCKS the firing thread until the
site is disarmed (``disarm``/``clear`` release it) or a cap expires
(``delay_s``, default ``HANG_CAP_S`` = 120s when unspecified): the kind
that models an indefinite device stall. The resilience layer's bounded
dispatch (`utils/resilience.py`) is tested against ``hang``: the hung
worker is abandoned at the deadline and released here at disarm/cap.
Every firing increments the ``faults.injected.<site>`` counter and
records a ``fault`` flight event with the active trace id.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from . import metrics as mx


class FaultInjected(RuntimeError):
    """An armed `error`-kind fault point fired."""


class FaultConnectionDrop(ConnectionError):
    """An armed `drop`-kind fault point fired (transport-shaped)."""


_KINDS = ("error", "drop", "delay", "hang")

# default cap of a `hang` firing when no explicit delay_s is armed: long
# enough that only a deadline-bounded caller escapes it, short enough
# that a hung worker thread is eventually released even if nobody disarms
HANG_CAP_S = 120.0


@dataclass
class _Armed:
    site: str
    kind: str
    prob: float = 1.0
    remaining: Optional[int] = None  # None = unlimited firings
    delay_s: float = 0.05
    exc: Optional[BaseException] = None  # overrides the default exception
    release: Optional[threading.Event] = None  # hang: set on disarm/clear


_armed: Dict[str, _Armed] = {}
_lock = threading.Lock()
# deterministic by default so prob<1 chaos runs are reproducible
_rng = random.Random(int(os.environ.get("FTS_FAULTS_SEED", "0xF75"), 0))


def arm(site: str, kind: str = "error", prob: float = 1.0,
        count: Optional[int] = None, delay_s: Optional[float] = None,
        exc: Optional[BaseException] = None) -> None:
    """Arm `site` to fire `count` times (None = forever) with `prob`.
    For `hang`, `delay_s` is the release CAP (default `HANG_CAP_S`)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown fault kind {kind!r} (want one of {_KINDS})")
    if delay_s is None:
        delay_s = HANG_CAP_S if kind == "hang" else 0.05
    release = threading.Event() if kind == "hang" else None
    with _lock:
        old = _armed.get(site)
        _armed[site] = _Armed(site, kind, prob, count, delay_s, exc, release)
    if old is not None and old.release is not None:
        old.release.set()  # re-arming must not strand earlier hangers


def disarm(site: str) -> None:
    with _lock:
        f = _armed.pop(site, None)
    if f is not None and f.release is not None:
        f.release.set()  # release any thread blocked in a hang firing


def clear() -> None:
    with _lock:
        fs = list(_armed.values())
        _armed.clear()
    for f in fs:
        if f.release is not None:
            f.release.set()


def armed() -> Dict[str, str]:
    """Snapshot of armed sites -> kind (for logs/tests)."""
    with _lock:
        return {s: f.kind for s, f in _armed.items()}


def fire(site: str) -> None:
    """The fault point: no-op unless `site` is armed (the disarmed fast
    path is one dict lookup on an almost-always-empty dict)."""
    if not _armed:
        return
    with _lock:
        f = _armed.get(site)
        if f is None:
            return
        if f.remaining is not None and f.remaining <= 0:
            return
        if f.prob < 1.0 and _rng.random() >= f.prob:
            return
        if f.remaining is not None:
            f.remaining -= 1
        kind, delay_s, exc, release = f.kind, f.delay_s, f.exc, f.release
    mx.counter(f"faults.injected.{site}").inc()
    # flight-record the firing with the ACTIVE trace id, so a chaos run
    # can correlate each injected fault to the exact tx it hit
    mx.flight("fault", site=site, fault_kind=kind)
    if kind == "delay":
        time.sleep(delay_s)
        return
    if kind == "hang":
        # an indefinite stall, bounded only by disarm()/clear() or the
        # armed cap — the firing thread then RETURNS (the stall ended;
        # the call it was injected into proceeds normally, so a caller
        # that abandoned it at a deadline sees a straggler completion)
        release.wait(delay_s)
        return
    if exc is not None:
        raise exc
    if kind == "drop":
        raise FaultConnectionDrop(f"injected connection drop at {site}")
    raise FaultInjected(f"injected fault at {site}")


def load_env(spec: Optional[str] = None) -> int:
    """Parse ``FTS_FAULTS="site:kind:prob[:count[:delay_s]],..."`` and arm
    every entry; returns how many were armed. A malformed entry raises
    (arming faults wrong should be loud, not silent)."""
    if spec is None:
        spec = os.environ.get("FTS_FAULTS", "")
    n = 0
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(f"bad FTS_FAULTS entry {part!r}")
        site, kind = fields[0], fields[1]
        # an empty field keeps its default, so "site:delay:1.0::1.5"
        # reads as prob=1.0, unlimited count, delay_s=1.5
        prob = float(fields[2]) if len(fields) > 2 and fields[2] else 1.0
        count = int(fields[3]) if len(fields) > 3 and fields[3] else None
        # None lets arm() pick the per-kind default (hang: HANG_CAP_S)
        delay_s = float(fields[4]) if len(fields) > 4 and fields[4] else None
        arm(site, kind, prob=prob, count=count, delay_s=delay_s)
        n += 1
    return n


load_env()
