"""Host-path profiler: sub-leg timers.

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
`commit-worker` (`services/network/pipeline.py`).

Not ported yet: the reference's sampling wall-clock profiler, which
reads the roles, and its `FTS_PROF_HZ`/`FTS_PROF_MAX_STACKS` settings.
They come with their first caller in the port (a bench).
"""

from __future__ import annotations

import contextlib
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
