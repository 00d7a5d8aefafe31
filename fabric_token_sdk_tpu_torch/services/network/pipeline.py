"""Pipelined block engine: overlap device verify with commit.

Counterpart of `fabric_token_sdk_tpu/services/network/pipeline.py`.
The sequential group commit is stop-and-wait: cut a block -> device
verify (the dominant phase on every measured critical-path breakdown) ->
host validate -> WAL -> merge -> only then cut the next block, so the
device plane idles while the host/WAL plane works and vice versa. This
engine streams instead, exploiting the seam the sequential engine
already proved safe: a block's batched device verification is
STATE-INDEPENDENT (it checks proofs against request bytes, never ledger
state), while host validation / WAL / merge must run in strict height
order.

Two stages, double-buffered:

* **Stage A (verify)** runs on the DRIVING thread — whoever wins the cut
  race: cut block N+1 from the ordering queue, run its batched device
  verification (`Network._verify_stage` -> `BlockValidationPipeline`),
  hand the verdicts off. Stage A is serialized by `stage_lock`, so cut
  order == hand-off order == commit order.
* **Stage B (commit)** runs on one daemon worker thread per engine:
  host-validate + WAL append + atomic merge + finality resolution
  (`Network._commit_stage`), strictly in hand-off order. The bounded
  hand-off queue is the double buffer: while the worker commits block N,
  the driving thread verifies block N+1; a third block blocks in
  `submit()` until the buffer drains.

Invariants preserved (differential-tested against the sequential engine
and the JAX package's ledger in `tests/test_torch_pipeline.py`):

* **Height order** — stage B is a single consumer of a FIFO queue fed
  under `stage_lock`; merges happen in exactly cut order.
* **Degrade chain** — stage A is `BlockValidationPipeline.proof_verdicts`
  unchanged: device -> host per block, with each device dispatch
  bounded by the plane's `FTS_DEVICE_DEADLINE_S` wall budget and
  guarded by its circuit breaker (utils/resilience.py) — a hung device
  call is abandoned at the deadline inside stage A itself, so it can
  never wedge the driving thread, and BOTH engines inherit the same
  seam because the sequential path calls the same pipeline methods.
  A `DevicePlaneError` (a plane failed on the card) is handed to
  stage B, which fails that block in its height order without
  dispatching again; any other verify-stage exception downgrades to
  `pre=None`, making stage B re-run verification exactly as the
  sequential engine would (`orderer.pipeline.verify_errors`).
* **Exactly-once** — dedup at stage A is provisional (skip work already
  recorded); stage B re-checks under the final committed state, so a
  duplicate racing across two in-flight blocks resolves from the
  recorded verdict, never validates twice.
* **Error propagation** — a commit exception on the worker cannot reach
  a driving thread's stack, so stage B attaches it to every stranded
  submission (`Submission._commit_error`) and `result()` re-raises it —
  the same contract the sequential engine gives its driving thread.

Overlap accounting: `BusyClock` tracks stage-B busy time; stage A
measures how much of its verify wall clock ran while stage B was busy
(`orderer.pipeline.overlap.seconds` histogram, `overlap_frac` gauge,
and the `overlap_s` field of the block critical-path breakdown).

`FTS_BLOCK_PIPELINE=0`, the engine's one selector, disables it entirely
and restores the exact sequential path — accept/reject can never depend
on the overlap.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

from ...utils import metrics as mx
from ...utils import profiler
from ...utils.tracing import logger
from .orderer import DevicePlaneError


# ------------------------------------------------------------ host workers
#
# Shared worker pool for the batch-first HOST validation passes
# (`BlockValidationPipeline._host_sign_batch` / `_host_proof_batch`):
# the native bn254/sha256 calls release the GIL, so chunking one block's
# rows across a few threads overlaps their C time. WAL append and vault
# merge stay single-threaded on the stage-B worker — this pool only ever
# computes pure verdicts over immutable row tuples.

_HOST_MIN_CHUNK = 8

# half the cores, capped at 4: host batch rows only parallelize inside
# the GIL-free native calls, beyond that threads just contend
_HOST_WORKERS = min(4, max(1, (os.cpu_count() or 2) // 2))

_host_pool: Optional[ThreadPoolExecutor] = None
_host_pool_lock = threading.Lock()


def host_map(fn: Callable[[List], List], items) -> List:
    """Fan `fn` (chunk -> aligned verdict list) over `items` on the
    shared commit-host pool, preserving order. Small batches (or a
    1-worker pool) run inline — the pool must never cost more than the
    loop it replaces. A chunk exception propagates to the caller, which
    owns the degrade-to-scalar decision."""
    items = list(items)
    n = _HOST_WORKERS
    if n <= 1 or len(items) < 2 * _HOST_MIN_CHUNK:
        return list(fn(items))
    global _host_pool
    with _host_pool_lock:
        if _host_pool is None:
            _host_pool = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="fts-commit-host",
                initializer=profiler.set_thread_role,
                initargs=("commit-worker",),
            )
        pool = _host_pool
    n_chunks = min(n, len(items) // _HOST_MIN_CHUNK)
    size = (len(items) + n_chunks - 1) // n_chunks
    futs = [
        pool.submit(fn, items[i : i + size])
        for i in range(0, len(items), size)
    ]
    out: List = []
    for f in futs:
        out.extend(f.result())
    return out


class BusyClock:
    """Cumulative busy-time clock: `value()` at two instants brackets how
    long the tracked activity ran in between, including a span still in
    progress — the primitive behind the verify/commit overlap metric."""

    __slots__ = ("_total", "_since", "_lock")

    def __init__(self):
        self._total = 0.0
        self._since: Optional[float] = None
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            self._since = time.monotonic()

    def stop(self) -> None:
        with self._lock:
            if self._since is not None:
                self._total += time.monotonic() - self._since
                self._since = None

    def value(self) -> float:
        with self._lock:
            t = self._total
            if self._since is not None:
                t += time.monotonic() - self._since
            return t


class PipelinedBlockEngine:
    """Double-buffered verify/commit pipeline for one ledger.

    `verify_fn(subs) -> pre` is stage A (`Network._verify_stage`);
    `commit_fn(subs, pre)` is stage B (`Network._commit_stage`). `depth`
    bounds the hand-off buffer (1 = classic double buffer: one block in
    verify, one queued/committing).
    """

    def __init__(self, verify_fn: Callable, commit_fn: Callable,
                 depth: int = 1):
        self._verify_fn = verify_fn
        self._commit_fn = commit_fn
        # serializes stage A (cut + verify + hand-off): cut order IS
        # commit order. RLock: a stage-A caller may re-enter via metrics
        # callbacks; reentrancy is harmless here.
        self.stage_lock = threading.RLock()
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._cond = threading.Condition()
        self._submitted = 0
        self._committed = 0
        self._commit_clock = BusyClock()
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()

    # ------------------------------------------------------------ threads

    def on_worker_thread(self) -> bool:
        """True when the calling thread IS the commit worker — a finality
        listener (re)submitting from inside stage B must drive its block
        inline (sequential path) or it would deadlock waiting on itself."""
        return threading.current_thread() is self._worker

    def _ensure_worker(self) -> None:
        with self._worker_lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._run, name="fts-block-commit", daemon=True
                )
                self._worker.start()

    # ------------------------------------------------------------ stage A

    def submit(self, subs: List) -> None:
        """Stage A for one cut block: batched device verify on the
        CALLING thread (overlapping the worker's commit of the previous
        block), then hand off for strictly-ordered commit. Must be called
        with `stage_lock` held. Blocks when the double buffer is full."""
        self._ensure_worker()
        t0 = time.monotonic()
        c0 = self._commit_clock.value()
        try:
            pre = self._verify_fn(subs)
        except DevicePlaneError as e:
            # the card failed this block: stage B fails it, in height
            # order, without dispatching again on the plane that failed
            pre = {"device_error": e}
        except Exception:
            # outside the pipeline's own degrade handling (which never
            # raises): downgrade to pre=None so stage B re-runs the
            # verification exactly as the sequential engine would —
            # including raising the same exception if it reproduces
            mx.counter("orderer.pipeline.verify_errors").inc()
            logger.exception(
                "pipeline: verify stage failed; commit stage will re-run"
            )
            pre = None
        if pre is not None and "device_error" not in pre:
            verify_wall_s = time.monotonic() - t0
            overlap_s = self._commit_clock.value() - c0
            pre["overlap_s"] = overlap_s
            pre["verify_wall_s"] = verify_wall_s
            mx.histogram("orderer.pipeline.overlap.seconds").observe(overlap_s)
            if verify_wall_s > 0:
                mx.gauge("orderer.pipeline.overlap_frac").set(
                    round(min(1.0, overlap_s / verify_wall_s), 6)
                )
        with self._cond:
            self._submitted += 1
            mx.gauge("orderer.pipeline.depth").set(
                self._submitted - self._committed
            )
        self._q.put((subs, pre))

    # ------------------------------------------------------------ stage B

    def _run(self) -> None:
        # profile role of this thread: every stage-B sample collapses
        # under `commit-worker` in the flamegraph export
        profiler.set_thread_role("commit-worker")
        while True:
            subs, pre = self._q.get()
            self._commit_clock.start()
            try:
                self._commit_fn(subs, pre)
            except Exception:
                # every submission was already resolved (the ledger's
                # stranded contract) and carries the exception for
                # `result()` to re-raise; the worker itself must survive
                # for the next block
                logger.exception("pipeline: block commit failed")
            finally:
                self._commit_clock.stop()
                mx.counter("orderer.pipeline.blocks").inc()
                with self._cond:
                    self._committed += 1
                    mx.gauge("orderer.pipeline.depth").set(
                        self._submitted - self._committed
                    )
                    self._cond.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Condition-variable wait (no spin) until every submitted block
        has committed; returns False on timeout."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._committed >= self._submitted, timeout
            )

    def inflight(self) -> int:
        with self._cond:
            return self._submitted - self._committed
