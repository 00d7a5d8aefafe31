"""Host-path profiler: sub-leg timers and a sampling wall-clock profiler.

The host work of validating a request, around the batched proof planes
on the card, is per-tx Python. `leg(name)` is its attribution layer: an
explicit, always-on decomposition of a host-validate loop (any caller
that opens a `collect()` window around `RequestValidator.validate`, as
`chip_smoke.py`'s `[drivers]` phase does) into named histograms
`ledger.host.<name>.seconds` for the legs

    unmarshal      request decode + canonical re-marshalling
                   (`TokenRequest.from_bytes`, `marshal_to_sign/audit`)
    fiat_shamir    host zk proof verification (zkatdlog transfer/issue
                   verifiers — the non-interactive challenge re-derivation)
    sig_verify     host signature checks (`identity.verify_signature`:
                   Schnorr pk, nym, htlc dispatch)
    conservation   token parse + type/sum conservation checks
    input_match    input id decode, ledger resolve, action/record
                   consistency checks

Legs are attributed EXCLUSIVELY: a `leg` nested inside another bills the
inner leg only (the outer leg's self-time excludes it), so the sum of
legs never double-counts. Timing runs ONLY while a collector is active;
everywhere else — client-side marshalling, wallet flows — `leg()` is a
zero-cost passthrough (one thread-local lookup), so the
`ledger.host.*` histograms see validation samples exclusively and the
off-path overhead is nil. Cumulative totals (`leg_totals()`) let a
caller compute what fraction of its host time the named sub-legs
explain.

Thread roles (`set_thread_role`, read by `thread_role`): the block
pipeline registers its commit worker and its host-batch pool threads as
`commit-worker` (`services/network/pipeline.py`), the remote node its
connection handlers as `remote-handler`.

**Sampling profiler** (`SamplingProfiler`, and the process-wide one of
`start`/`stop`/`active`): a daemon thread walking `sys._current_frames()`
at `hz` samples a second (0, the default, is off: no thread at all),
aggregating collapsed stacks per thread role:

    commit-worker   the pipelined engine's stage-B thread and host pool
    stage-a-driver  whoever drives the cut and the device verify
    remote-handler  per-connection server threads (remote.py)
    client          bench submitter threads
    other           everything else (main thread included)

A role resolves from a registration (`set_thread_role`), then the thread
name, then a stack heuristic. The table holds at most `max_stacks`
distinct stacks; a new stack beyond that is dropped and counted
(`prof.dropped`). `collapsed()` gives flamegraph-ready
`role;frame;frame -> count`. The observer's own metrics: `prof.samples`
counts passes, `prof.stacks` gauges the table, `prof.errors` counts
failed passes. The reference's `FTS_PROF_HZ` and `FTS_PROF_MAX_STACKS`
are the arguments `hz=` and `max_stacks=` here, with its defaults (0 and
2000); no environment variable is read. Nothing on a path starts it.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Dict, Optional

from . import metrics as mx

# the named sub-legs of the host-validate loop, in report order
LEGS = ("unmarshal", "fiat_shamir", "sig_verify", "conservation",
        "input_match")

_tl = threading.local()

# cumulative per-leg seconds collected across every `collect()` window
# of the process; a caller diffs two copies around a measured window
_totals: Dict[str, float] = {}
_totals_lock = threading.Lock()


@contextlib.contextmanager
def leg(name: str):
    """Time one named sub-leg of the host-validate path.

    Active only under a `collect()` window on the same thread (a
    host-validate loop); anywhere else this is a zero-cost
    passthrough. Nested legs bill exclusively: the outer leg's recorded
    time excludes the inner leg's wall time."""
    stack = getattr(_tl, "stack", None)
    if stack is None:
        yield
        return
    frame = [name, time.monotonic(), 0.0]  # [name, t0, child_wall_s]
    stack.append(frame)
    try:
        yield
    finally:
        now = time.monotonic()
        stack.pop()
        wall = now - frame[1]
        self_s = max(0.0, wall - frame[2])
        if stack:
            stack[-1][2] += wall  # parent excludes this leg's wall time
        mx.histogram(f"ledger.host.{name}.seconds").observe(self_s)
        col = _tl.collector
        col[name] = col.get(name, 0.0) + self_s
        with _totals_lock:
            _totals[name] = _totals.get(name, 0.0) + self_s


@contextlib.contextmanager
def collect():
    """Activate sub-leg collection on this thread; yields the dict the
    window's per-leg seconds accumulate into ({leg: seconds}). Open it
    around a single-threaded host-validate loop, such as the calls to
    `RequestValidator.validate` over a block, so that thread-local
    state is exact. Windows nest: the inner one collects alone and the
    outer one resumes when it closes."""
    prev_stack = getattr(_tl, "stack", None)
    prev_col = getattr(_tl, "collector", None)
    out: Dict[str, float] = {}
    _tl.stack = []
    _tl.collector = out
    try:
        yield out
    finally:
        _tl.stack = prev_stack
        _tl.collector = prev_col


def leg_totals() -> Dict[str, float]:
    """Cumulative per-leg seconds collected so far (process lifetime,
    collector windows only) — diff two copies around a measured window."""
    with _totals_lock:
        return dict(_totals)


# ------------------------------------------------------------ thread roles

_roles: Dict[int, str] = {}
_roles_lock = threading.Lock()


def set_thread_role(role: str) -> None:
    """Register the CALLING thread's role (commit worker, client). One
    entry per live thread id, overwritten on reuse."""
    with _roles_lock:
        _roles[threading.get_ident()] = role


def thread_role(ident: Optional[int] = None) -> Optional[str]:
    """The role registered for thread `ident` (default: the calling
    thread), or None."""
    with _roles_lock:
        return _roles.get(threading.get_ident() if ident is None else ident)


# thread-name prefixes -> role (the commit worker and bench clients are
# named at spawn; registration beats this map when both apply)
_NAME_ROLES = (
    ("fts-block-commit", "commit-worker"),
    ("fts-commit-host", "commit-worker"),
    ("fts-soak-client", "client"),
)

# sampler-internal threads that must never appear in their own profile
_SKIP_NAMES = ("fts-prof", "fts-heartbeat")


def _classify(ident: int, name: str, frames) -> str:
    """The role of a sampled thread: its registration, its name, else the
    files and functions on its stack (`frames`, root first)."""
    role = thread_role(ident)
    if role:
        return role
    for prefix, r in _NAME_ROLES:
        if name.startswith(prefix):
            return r
    for filename, func in frames:
        if filename.endswith("remote.py"):
            return "remote-handler"
        if filename.endswith("pipeline.py") and func == "submit":
            return "stage-a-driver"
        if filename.endswith("orderer.py") and func in ("drive", "flush"):
            return "stage-a-driver"
    return "other"


# ------------------------------------------------------------ sampler

DEFAULT_HZ = 0.0
DEFAULT_MAX_STACKS = 2000


class SamplingProfiler:
    """Wall-clock sampling profiler over `sys._current_frames()`.

    `hz` <= 0 is off: `start()` spawns nothing. The stack table is
    bounded at `max_stacks` distinct collapsed stacks; past the cap a new
    stack is dropped (counted), a known one keeps counting."""

    def __init__(self, hz: float = DEFAULT_HZ, max_stacks: int = DEFAULT_MAX_STACKS,
                 max_depth: int = 48):
        self.hz = float(hz)
        self.max_stacks = max(1, int(max_stacks))
        self.max_depth = max(1, max_depth)
        self.samples = 0
        self.dropped = 0
        self._stacks: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SamplingProfiler":
        if self.hz <= 0 or self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="fts-prof", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> "SamplingProfiler":
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None
        return self

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            try:
                self.sample()
            except Exception:
                # the observer must never take the process down
                mx.counter("prof.errors").inc()

    def sample(self) -> None:
        """One sampling pass over every live thread but the sampler's own
        (public, so a caller can drive it without the daemon thread)."""
        me = threading.get_ident()
        names = {t.ident: t.name or "" for t in threading.enumerate()}
        for ident, top in sys._current_frames().items():
            if ident == me:
                continue
            name = names.get(ident, "")
            if name.startswith(_SKIP_NAMES):
                continue
            frames = []
            f = top
            while f is not None and len(frames) < self.max_depth:
                code = f.f_code
                frames.append((code.co_filename, code.co_name))
                f = f.f_back
            frames.reverse()  # root first, flamegraph order
            role = _classify(ident, name, frames)
            key = role + ";" + ";".join(
                "%s:%s" % (os.path.basename(fn).rsplit(".", 1)[0], func) for fn, func in frames)
            with self._lock:
                if key in self._stacks:
                    self._stacks[key] += 1
                elif len(self._stacks) < self.max_stacks:
                    self._stacks[key] = 1
                else:
                    self.dropped += 1
                    mx.counter("prof.dropped").inc()
        self.samples += 1
        mx.counter("prof.samples").inc()
        mx.gauge("prof.stacks").set(len(self._stacks))

    def collapsed(self, role: Optional[str] = None) -> Dict[str, int]:
        """{collapsed stack: sample count}, keys `role;frame;frame` root
        first; `role` keeps one thread role."""
        with self._lock:
            items = dict(self._stacks)
        if role is not None:
            prefix = role + ";"
            items = {k: v for k, v in items.items() if k.startswith(prefix)}
        return items

    def stack_count(self) -> int:
        with self._lock:
            return len(self._stacks)


# the process-wide sampler, started around a measured window
_active: Optional[SamplingProfiler] = None
_active_lock = threading.Lock()


def start(hz: float = DEFAULT_HZ, max_stacks: int = DEFAULT_MAX_STACKS) -> Optional[SamplingProfiler]:
    """Start the process-wide sampler (idempotent: a running one is
    returned as it is). None when `hz` <= 0: off means no thread."""
    global _active
    with _active_lock:
        if _active is not None and _active.running():
            return _active
        p = SamplingProfiler(hz=hz, max_stacks=max_stacks)
        if p.hz <= 0:
            return None
        _active = p.start()
        return _active


def stop() -> Optional[SamplingProfiler]:
    """Stop the process-wide sampler; returns it, with its samples, or
    None if none was started."""
    global _active
    with _active_lock:
        p = _active
        _active = None
    if p is not None:
        p.stop()
    return p


def active() -> Optional[SamplingProfiler]:
    return _active
