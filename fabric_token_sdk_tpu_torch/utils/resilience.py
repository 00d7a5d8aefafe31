"""Resilience layer: bounded device dispatch + per-plane circuit breakers.

Counterpart of `fabric_token_sdk_tpu/utils/resilience.py`. The block
validation path handles a device plane that fails fast: on the card the
block fails, on the CPU it falls to host verification with identical
verdicts. A call that HANGS would block the committing thread forever; this module closes that gap with the two
primitives every serving stack pairs:

* ``bounded_call(fn, deadline_s)`` — run one device dispatch on a daemon
  worker thread and give the caller back control when the wall budget
  expires (``DeviceTimeout``). Work queued on the card **cannot be
  cancelled**: the kernels the worker launched keep running on their
  CUDA stream, the worker runs on until its wrapper returns (a `.cpu()`
  copy waits for them), and whatever it returns or raises is DISCARDED,
  never applied (counted under ``resilience.bounded.stragglers``). The
  next dispatch on that stream queues behind the abandoned launches, so
  a wedged kernel also delays, or times out, the dispatches after it:
  the breaker below is what stops them piling on. Discarding is safe
  because every device plane here is read-only over request bytes.

* ``CircuitBreaker`` — per-plane closed/open/half-open breaker. After
  ``FTS_BREAKER_FAILURES`` consecutive failures or
  ``FTS_BREAKER_TIMEOUTS`` consecutive timeouts it OPENS, rejecting
  dispatches outright (the block fails fast on the card, falls to host
  on the CPU) for
  ``FTS_BREAKER_COOLDOWN_S`` of monotonic-clock cooldown, then admits
  exactly ONE half-open probe; a probe success closes the breaker, a
  probe failure re-opens it and restarts the cooldown.

Accept/reject never depends on this layer: a rejected or timed-out
dispatch fails its block on the card (tests/test_torch_device_failure.py)
or falls to the host path on the CPU, whose verdicts are the reference's
(tests/test_torch_resilience.py, including the ``hang`` fault kind).

Planes wired (one breaker each, registered lazily by name):

    verify  — `BlockValidationPipeline.proof_verdicts` group calls
    sign    — `BlockValidationPipeline.sign_verdicts`

Deadlines resolve per plane via ``device_deadline_s(plane, device)``:
``FTS_DEVICE_DEADLINE_<PLANE>_S`` wins, else ``FTS_DEVICE_DEADLINE_S``,
else the default — the commit-path planes (verify/sign) are bounded at
``ACCEL_DEADLINE_S`` (120s) when the plane's device is a CUDA device and
UNBOUNDED on the CPU (where the plain torch versions of a big block
legitimately take minutes, and a tight default would open the breaker
against a healthy plane); other planes default unbounded. ``0`` always
means unbounded, and an unbounded call runs inline (no worker thread).
The device is the one the caller resolved (`crypto.batch.resolve_device`),
never a guess from what the process has imported.

Observability: counters ``resilience.breaker.{open,close,probe,
rejected}`` and ``resilience.bounded.{calls,timeouts,stragglers}``, a
per-plane state gauge (0=closed, 1=half-open, 2=open), and a ``breaker``
flight event per transition/timeout/straggler; ``Network.health()``
serves the breaker states.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from . import metrics as mx
from .tracing import logger

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

# default wall budget of commit-path device dispatch on a REAL
# accelerator (generous: a healthy warmed-up device verify is seconds;
# only a wedged backend runs into minutes)
ACCEL_DEADLINE_S = 120.0

# planes bounded by default (on accelerators) — the commit path
_COMMIT_PLANES = ("verify", "sign")


class DeviceTimeout(RuntimeError):
    """A bounded device dispatch exceeded its wall deadline. The
    abandoned worker may still be running (launches on a CUDA stream
    cannot be cancelled); its late result is discarded, never applied."""


def _env_num(name: str, default: float) -> float:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


class CircuitBreaker:
    """closed/open/half-open breaker guarding one device plane.

    Thread-safe; all transitions happen under one lock and are counted +
    flight-recorded OUTSIDE it. The clock is injectable for tests
    (monotonic by default — wall-clock jumps must not early-close a
    breaker).
    """

    def __init__(self, plane: str,
                 failure_threshold: Optional[int] = None,
                 timeout_threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.plane = plane
        self.failure_threshold = int(
            _env_num("FTS_BREAKER_FAILURES", 5)
            if failure_threshold is None else failure_threshold
        )
        self.timeout_threshold = int(
            _env_num("FTS_BREAKER_TIMEOUTS", 2)
            if timeout_threshold is None else timeout_threshold
        )
        self.cooldown_s = float(
            _env_num("FTS_BREAKER_COOLDOWN_S", 30.0)
            if cooldown_s is None else cooldown_s
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0  # consecutive failures of any kind
        self._timeouts = 0  # consecutive deadline timeouts
        self._opened_at = 0.0
        self._probing = False  # the single half-open probe is in flight
        self._gauge()  # live-state gauge exists from creation (0=closed)

    # ------------------------------------------------------------ state

    @property
    def state(self) -> str:
        """Current state, with the open->half-open cooldown transition
        applied (so observers see `half-open` once a probe is due)."""
        with self._lock:
            self._tick()
            return self._state

    def _tick(self) -> None:
        # lock held: promote open -> half-open once the cooldown expires
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.cooldown_s
        ):
            self._state = HALF_OPEN
            self._probing = False
            self._gauge()  # the live-state gauge tracks the promotion too

    def _gauge(self) -> None:
        mx.gauge(f"resilience.breaker.state.{self.plane}").set(
            _STATE_CODE[self._state]
        )

    def rejecting(self) -> bool:
        """Non-consuming admission preview: True while the plane is
        hard-open (cooldown not yet expired). Half-open is NOT rejecting
        — a probe is available. Cheap enough for per-block fast-path
        gates that want to skip even collection work."""
        with self._lock:
            self._tick()
            rejected = self._state == OPEN
        if rejected:
            mx.counter("resilience.breaker.rejected").inc()
        return rejected

    def allow(self) -> bool:
        """Consuming admission check, called immediately before one
        dispatch: True in closed state, True for exactly ONE caller in
        half-open (the probe — everyone else is rejected until the probe
        reports), False while open. The caller that got True MUST report
        back via `record_success`/`record_failure`."""
        with self._lock:
            self._tick()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                probe = True
            else:
                probe = False
        if probe:
            mx.counter("resilience.breaker.probe").inc()
            mx.flight("breaker", plane=self.plane, event="probe")
            return True
        mx.counter("resilience.breaker.rejected").inc()
        return False

    def cancel_probe(self) -> None:
        """Release a consumed `allow()` admission WITHOUT recording an
        outcome — for the caller that discovered there is nothing to
        dispatch after all (e.g. the driver has no batched plane). The
        half-open probe slot re-opens for the next dispatcher; state is
        otherwise unchanged. Without this, an unreported probe would
        wedge the breaker in half-open forever."""
        with self._lock:
            self._probing = False

    def record_success(self) -> None:
        with self._lock:
            was = self._state
            self._state = CLOSED
            self._failures = 0
            self._timeouts = 0
            self._probing = False
            self._gauge()
        if was != CLOSED:
            mx.counter("resilience.breaker.close").inc()
            mx.flight("breaker", plane=self.plane, event="close")
            logger.info(
                "resilience: %s breaker closed (plane healed)", self.plane
            )

    def record_failure(self, timeout: bool = False,
                       trip_now: bool = False) -> None:
        """`trip_now` opens the breaker on THIS failure regardless of
        thresholds — for structural failures (e.g. verifier construction
        OOM) where per-block retries are known-useless; unlike the old
        process-lifetime latch, the half-open probe still heals it."""
        with self._lock:
            self._failures += 1
            self._timeouts = self._timeouts + 1 if timeout else 0
            tripped = trip_now or self._state == HALF_OPEN  # failed probe
            if self._state == CLOSED and (
                self._failures >= self.failure_threshold
                or self._timeouts >= self.timeout_threshold
            ):
                tripped = True
            if tripped:
                self._state = OPEN
                self._opened_at = self._clock()
                self._probing = False
            self._gauge()
        if tripped:
            mx.counter("resilience.breaker.open").inc()
            mx.flight(
                "breaker", plane=self.plane, event="open",
                timeout=bool(timeout), cooldown_s=self.cooldown_s,
            )
            logger.warning(
                "resilience: %s breaker OPEN (%s) — dispatches are "
                "refused for %.1fs, then one half-open probe",
                self.plane, "timeout" if timeout else "failures",
                self.cooldown_s,
            )


# ---------------------------------------------------------------- registry

_breakers: Dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker(plane: str) -> CircuitBreaker:
    """Process-wide breaker for one plane (created lazily; env-config is
    read at creation, so tests set `FTS_BREAKER_*` then `reset()`)."""
    with _breakers_lock:
        b = _breakers.get(plane)
        if b is None:
            b = _breakers[plane] = CircuitBreaker(plane)
        return b


def breaker_states() -> Dict[str, str]:
    """{plane: state} snapshot of every breaker that exists — the body
    of the `breakers` section of `Network.health()`."""
    with _breakers_lock:
        bs = list(_breakers.items())
    return {plane: b.state for plane, b in bs}


def reset() -> None:
    """Drop every breaker (test isolation — breakers are process-global
    by design, like the fault registry)."""
    with _breakers_lock:
        _breakers.clear()


# ---------------------------------------------------------------- deadlines


def _accelerator_backend(device) -> bool:
    """True when the plane's device is a CUDA device: the device the
    caller resolved, a `torch.device` or its string form."""
    return device is not None and str(device).split(":")[0] == "cuda"


def device_deadline_s(plane: str, device=None) -> float:
    """Wall budget for one bounded dispatch of `plane` on `device`.
    Resolution: `FTS_DEVICE_DEADLINE_<PLANE>_S` > `FTS_DEVICE_DEADLINE_S`
    > default. 0 = unbounded (runs inline, no worker thread). Default:
    the commit-path planes (verify/sign) are bounded at
    `ACCEL_DEADLINE_S` on a CUDA device and unbounded on the CPU, where
    the plain torch versions of a big block legitimately take minutes
    and a tight default would open the breaker against a healthy plane.
    Other planes default unbounded."""
    v = os.environ.get(f"FTS_DEVICE_DEADLINE_{plane.upper()}_S")
    if v is None:
        v = os.environ.get("FTS_DEVICE_DEADLINE_S")
    if v is not None:
        try:
            return max(0.0, float(v))
        except ValueError:
            pass
    if plane in _COMMIT_PLANES and _accelerator_backend(device):
        return ACCEL_DEADLINE_S
    return 0.0


# ---------------------------------------------------------------- bounded

# live ABANDONED workers (timed-out dispatches still running). A daemon
# thread inside native code (a ctypes kernel wrapper, a CUDA copy) while
# the interpreter tears down can crash the process at exit, so exit
# waits a bounded `FTS_STRAGGLER_DRAIN_S` for stragglers to finish —
# short stragglers drain cleanly; a truly hung one still cannot block
# shutdown for more than the budget.
_stragglers: List[threading.Thread] = []
_stragglers_lock = threading.Lock()

def _track_straggler(worker: threading.Thread) -> None:
    with _stragglers_lock:
        _stragglers[:] = [t for t in _stragglers if t.is_alive()]
        _stragglers.append(worker)


def drain_stragglers(timeout_s: float = 5.0) -> bool:
    """Join abandoned workers for up to `timeout_s` total; True when
    none remain alive. Called automatically at interpreter exit."""
    deadline = time.monotonic() + max(0.0, timeout_s)
    with _stragglers_lock:
        live = [t for t in _stragglers if t.is_alive()]
        _stragglers[:] = live
    for t in live:
        t.join(max(0.0, deadline - time.monotonic()))
    with _stragglers_lock:
        _stragglers[:] = [t for t in _stragglers if t.is_alive()]
        return not _stragglers


atexit.register(
    lambda: drain_stragglers(
        _env_num("FTS_STRAGGLER_DRAIN_S", 5.0)
    )
)


def bounded_call(fn: Callable, deadline_s: Optional[float], *args,
                 plane: str = "device", **kwargs):
    """Run `fn(*args, **kwargs)` under a wall deadline.

    `deadline_s` None/0 runs inline (unbounded — zero overhead, the
    default on the CPU). Otherwise `fn` runs on a daemon worker thread
    with the caller's trace context propagated; if it does not finish
    within the budget, `DeviceTimeout` raises on the CALLER's stack and
    the worker is abandoned. Exceptions from a non-abandoned `fn`
    re-raise on the caller's stack unchanged.

    What "abandoned" means for CUDA work: nothing is cancelled. The
    kernels the worker already launched keep running on their stream
    (the thread's current stream of the device, by default its default
    stream), and the worker keeps running until its wrapper returns; its
    late result or error is discarded, never applied, and counted as a
    straggler (`resilience.bounded.stragglers`, a `breaker` flight event
    `straggler`). The next dispatch on that stream queues behind the
    abandoned launches. Abandoned workers that are still alive are
    tracked, and interpreter exit joins them for up to
    `FTS_STRAGGLER_DRAIN_S` (`drain_stragglers`).
    """
    if not deadline_s or deadline_s <= 0:
        return fn(*args, **kwargs)
    mx.counter("resilience.bounded.calls").inc()
    box: dict = {}
    done = threading.Event()
    lock = threading.Lock()
    state = {"finished": False, "abandoned": False}
    ctx = mx.current_trace()

    def _run():
        try:
            with mx.use_trace(ctx):
                box["result"] = fn(*args, **kwargs)
            box["ok"] = True
        except BaseException as e:  # delivered to (or discarded for) caller
            box["error"] = e
        finally:
            with lock:
                state["finished"] = True
                straggler = state["abandoned"]
            done.set()
            if straggler:
                # completed AFTER the caller gave up: the result above is
                # dead — the caller already failed or resolved the block
                mx.counter("resilience.bounded.stragglers").inc()
                mx.flight(
                    "breaker", plane=plane, event="straggler",
                    ok="error" not in box,
                )

    worker = threading.Thread(
        target=_run, name=f"fts-bounded-{plane}", daemon=True
    )
    worker.start()
    if not done.wait(deadline_s):
        with lock:
            finished = state["finished"]
            if not finished:
                state["abandoned"] = True
        if not finished:
            _track_straggler(worker)
            mx.counter("resilience.bounded.timeouts").inc()
            mx.flight(
                "breaker", plane=plane, event="timeout",
                deadline_s=deadline_s,
            )
            raise DeviceTimeout(
                f"{plane}: device dispatch exceeded its {deadline_s}s wall "
                "deadline (worker abandoned; a late result is discarded)"
            )
        # finished in the race window between wait() expiry and the lock:
        # box is fully populated before `finished` flips — take the result
    if box.get("ok"):
        return box["result"]
    raise box["error"]
