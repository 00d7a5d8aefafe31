"""Orderer: multi-tx block cutting + the batched block-validation plane.

Counterpart of `fabric_token_sdk_tpu/services/network/orderer.py`.
Reference: Fabric's ordering service in front of the committing peers,
and the validator scope note in SURVEY §3 — "the validator runs batched
verification for a whole block". Submissions enter an ordering queue;
blocks are cut by size policy; a block validation pipeline groups
same-shape zkatdlog transfers and verifies each group in ONE
`BatchedTransferVerifier` call on the card (the driver's
`batch_verifier()`: one launch a kernel over all of the group's rows,
`ops/stages.py`), and the block's pk-kind signatures in ONE
`BatchedSchnorrVerifier` call, with the host `RequestValidator` as the
path for fabtoken transfers, issues, and shapes too rare to batch. The ledger
(`ledger.py`) then applies intra-block MVCC — a double-spend inside a
block invalidates the LATER tx, never the block — and commits the block
atomically with per-tx finality events.

Concurrency model: **group commit without a dedicated thread.**
Submitters enqueue, then race for the commit lock; the winner cuts a
block from everything pending (up to `max_block_txs`) and commits it;
losers either find their submission finalized by the winner's block or
cut the next block themselves. Sequential callers therefore see one-tx
blocks with zero added latency, while concurrent load batches naturally
— and deterministic multi-tx blocks are available via
`Network.submit_many` / `Orderer.flush`.

Pipelined mode (`pipeline.PipelinedBlockEngine`, default on, opt-out
`FTS_BLOCK_PIPELINE=0`, its one selector): the driving thread runs only
the CUT + batched device verify of block N+1 while a commit worker
finishes block N's host-validate/WAL/merge — verify overlaps commit, height order is
preserved at the hand-off queue, and waiters park on their submission's
event (condition wait, no spinning on the commit lock).

Admission control: `BlockPolicy.queue_max` bounds the ordering queue; a
full queue rejects the submission BEFORE it enters ordering with a typed
`Backpressure` error — retry-safe by construction (nothing was enqueued,
nothing can commit).
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ...api.request import TokenRequest
from ...api.validator import SIG_AUDITOR, RequestValidator
from ...crypto.batch import resolve_device
from ...parallel.sharding import mesh_on_device, same_device
from ...drivers import identity
from ...utils import faults, resilience, slo
from ...utils import metrics as mx
from ...utils.tracing import logger


class Backpressure(RuntimeError):
    """The ordering queue is at `BlockPolicy.queue_max` capacity: the
    submission was rejected BEFORE entering ordering, so a retry (with
    backoff) is always safe — nothing was enqueued, nothing can commit,
    and the exactly-once contract is untouched. The remote server maps
    this to a typed wire error (`error_class: "Backpressure"`) and the
    remote client raises it back as this same type."""


class DevicePlaneError(RuntimeError):
    """A batched plane failed on a CUDA device: its kernels did not build
    or load, its verifier could not be built, a launch raised, the
    dispatch outlived its deadline, or the plane's breaker is open. The
    block that needed the plane fails (nothing of it commits, each of
    its submitters sees this error) and the next block dispatches anew.
    On the card the port never re-verifies on the host what a kernel
    failed to verify; on the CPU the reference's host re-verification
    stands (`BlockValidationPipeline`)."""


@dataclass
class BlockPolicy:
    """Block-cut + batched-validation policy.

    `max_block_txs`  — hard cap on txs per block.
    `min_batch`      — smallest same-shape transfer group worth a device
                       batch call; smaller groups take the host path.
    `use_batched`    — master switch for the batched proof plane.
    `queue_max`      — admission control: ordering-queue depth beyond
                       which enqueues are rejected with `Backpressure`
                       (0 = unbounded, the default).
    `sign_batched`   — the batched SIGNATURE plane: True forces it on,
                       False off, None (default, auto) engages it only
                       when the pipeline's device is a CUDA device — on
                       the CPU the plain torch versions of the kernels
                       cost seconds a block against ~1 ms a row for the
                       host check.
    `sign_min_batch` — smallest per-block pk-obligation count worth the
                       one batched signature call; smaller blocks stay
                       on the host path.

    The pipelined block engine has one selector, the environment's
    `FTS_BLOCK_PIPELINE` (`0` restores the sequential group commit),
    read when the `Network` is built.
    """

    max_block_txs: int = 64
    min_batch: int = 2
    use_batched: bool = True
    queue_max: int = 0
    sign_batched: Optional[bool] = None
    sign_min_batch: int = 4


class Submission:
    """Handle for one ordered tx. `result()` drives block cutting until
    the tx is final — under group commit any waiter may end up committing
    the block that contains it. Carries the tx's trace context (captured
    at enqueue) so block-commit work done by WHICHEVER thread wins the
    commit race still lands in the submitting tx's trace."""

    __slots__ = ("request", "event", "_done", "_orderer", "trace",
                 "enqueued_at", "enqueued_unix", "_commit_error")

    def __init__(self, orderer: Optional["Orderer"], request: TokenRequest):
        self.request = request
        self.event = None  # FinalityEvent once resolved
        self._done = threading.Event()
        self._orderer = orderer
        self.trace = None  # TraceContext captured at enqueue
        self.enqueued_at = 0.0  # monotonic, for queue-wait timing
        self.enqueued_unix = 0.0
        # pipelined mode: a commit exception from the worker thread is
        # attached here (alongside the transient stranded event) so
        # `result()` re-raises it on the waiter's own stack — the same
        # contract the sequential engine gives its driving thread
        self._commit_error = None

    def done(self) -> bool:
        return self._done.is_set()

    def _resolve(self, event) -> None:
        if self._done.is_set():
            return  # idempotent: a submission resolves exactly once
        self.event = event
        self._done.set()
        if self._orderer is not None and self.enqueued_at:
            # live in-flight accounting + the submit→finality latency
            # histogram (always on: the ops plane reads its quantiles)
            self._orderer._mark_resolved()
            finality_s = max(0.0, time.monotonic() - self.enqueued_at)
            mx.histogram("network.submit_to_finality.seconds").observe(
                finality_s
            )
            # slow-tx exemplar ring (utils/slo.py): the K slowest txs
            # keep their trace ids so `ftstrace timeline` has a concrete
            # target after a soak
            slo.record_exemplar(
                finality_s, event.tx_id,
                self.trace.trace_id if self.trace else None,
            )
        mx.flight(
            "finality", trace=self.trace,
            tx=event.tx_id, status=event.status.value,
        )

    def result(self, timeout: Optional[float] = None):
        """Block (driving commits as needed) until this tx has finality.
        Re-raises a pipelined commit-worker exception on the waiter's own
        stack (the sequential engine raises it in the driving thread)."""
        if not self._done.is_set() and self._orderer is not None:
            self._orderer.drive(self, timeout)
        if self._commit_error is not None:
            raise self._commit_error
        return self.event


class Orderer:
    """Ordering queue + group-commit block cutter.

    `commit_block` is the ledger's callback: it takes the cut list of
    Submissions, validates + commits them as ONE block, and resolves each
    submission with its per-tx finality event.
    """

    def __init__(self, commit_block: Callable[[List[Submission]], None],
                 policy: Optional[BlockPolicy] = None):
        self._commit_block = commit_block
        self.policy = policy or BlockPolicy()
        self._pending: collections.deque = collections.deque()
        self._mutex = threading.Lock()  # guards _pending + _inflight
        # submissions enqueued but not yet resolved (queued OR inside a
        # block being committed) — the instantaneous signal `ops.health`
        # serves; queue-wait histograms only exist after commit
        self._inflight = 0
        # RLock: a finality listener that (re)submits must not deadlock
        self._commit_lock = threading.RLock()
        # pipelined block engine (ledger.Network wires it unless
        # FTS_BLOCK_PIPELINE=0 disables the verify/commit overlap)
        self._engine = None

    def set_engine(self, engine) -> None:
        self._engine = engine

    # ------------------------------------------------------------ queue

    def enqueue(self, request: TokenRequest) -> Submission:
        sub = Submission(self, request)
        sub.trace = mx.current_trace()
        sub.enqueued_at = time.monotonic()
        sub.enqueued_unix = time.time()
        with self._mutex:
            qmax = self.policy.queue_max
            if qmax > 0 and len(self._pending) >= qmax:
                # admission control: reject BEFORE ordering, so a retry
                # is always safe — nothing enqueued, nothing can commit
                depth = len(self._pending)
                mx.counter("orderer.backpressure.rejects").inc()
                mx.flight("backpressure", trace=sub.trace,
                          tx=request.anchor, depth=depth, max=qmax)
                raise Backpressure(
                    f"ordering queue at capacity ({depth}/{qmax}); "
                    f"tx {request.anchor} rejected before ordering — "
                    "retry with backoff"
                )
            self._pending.append(sub)
            self._inflight += 1
            mx.gauge("orderer.queue.depth").set(len(self._pending))
            mx.gauge("ledger.inflight").set(self._inflight)
        mx.counter("ledger.ordering.enqueued").inc()
        mx.flight("submit", trace=sub.trace, tx=request.anchor)
        return sub

    def pending(self) -> int:
        with self._mutex:
            return len(self._pending)

    def inflight(self) -> int:
        """Submissions enqueued but not yet resolved (includes the block
        currently being committed, unlike `pending`)."""
        with self._mutex:
            return self._inflight

    def _mark_resolved(self) -> None:
        with self._mutex:
            self._inflight -= 1
            mx.gauge("ledger.inflight").set(self._inflight)

    def _cut(self) -> List[Submission]:
        # fault point BEFORE the pop: an injected cut failure strands
        # nothing — every pending submission survives for the next drive
        faults.fire("orderer.cut")
        with self._mutex:
            n = min(len(self._pending), max(1, self.policy.max_block_txs))
            batch = [self._pending.popleft() for _ in range(n)]
            mx.gauge("orderer.queue.depth").set(len(self._pending))
        if batch:
            mx.flight("block.cut", txs=len(batch))
        return batch

    # ------------------------------------------------------------ drive

    def _pipelining(self) -> bool:
        """True when drives should route through the pipelined engine.
        The commit WORKER thread itself must never route back into the
        engine (a finality listener resubmitting from inside stage B
        would deadlock waiting on itself) — it drives inline instead."""
        return self._engine is not None and not self._engine.on_worker_thread()

    def flush(self) -> None:
        """Cut + commit blocks until the ordering queue is empty (and, in
        pipelined mode, every in-flight block has committed)."""
        if self._pipelining():
            engine = self._engine
            while True:
                with engine.stage_lock:
                    batch = self._cut()
                    if batch:
                        engine.submit(batch)
                if not batch:
                    break
            engine.drain()
            return
        while True:
            with self._commit_lock:
                batch = self._cut()
                if not batch:
                    return
                self._commit_block(batch)

    def drive(self, sub: Submission, timeout: Optional[float] = None):
        """Commit blocks until `sub` resolves; returns its finality event.

        The timeout is honored even while another thread holds the commit
        lock mid-block (timed acquire), not just between commit attempts.
        Waiters whose submission is in flight elsewhere (the pipelined
        worker, or another driver's block) park on the submission's event
        — a condition wait, never a spin on the commit lock.
        """
        deadline = None if timeout is None else time.monotonic() + timeout

        def _remaining() -> Optional[float]:
            return None if deadline is None else deadline - time.monotonic()

        def _expired() -> bool:
            return deadline is not None and time.monotonic() > deadline

        def _timeout_check() -> None:
            if not sub._done.is_set() and _expired():
                raise TimeoutError(
                    f"tx {sub.request.anchor} not ordered within {timeout}s"
                )

        while not sub._done.is_set():
            if self._pipelining():
                engine = self._engine
                remaining = _remaining()
                if remaining is None:
                    acquired = engine.stage_lock.acquire()
                else:
                    acquired = remaining > 0 and engine.stage_lock.acquire(
                        timeout=remaining
                    )
                batch = None
                if acquired:
                    try:
                        if sub._done.is_set():
                            break
                        batch = self._cut()
                        if batch:
                            # stage A: device verify of this cut overlaps
                            # the worker's commit of the previous block
                            engine.submit(batch)
                    finally:
                        engine.stage_lock.release()
                if not batch and not sub._done.is_set():
                    # nothing left to cut: the sub is in flight in the
                    # engine (or another driver's block) — park on its
                    # event instead of re-racing the lock
                    sub._done.wait(_remaining())
                _timeout_check()
                continue
            if deadline is None:
                acquired = self._commit_lock.acquire()
            else:
                remaining = deadline - time.monotonic()
                acquired = remaining > 0 and self._commit_lock.acquire(
                    timeout=remaining
                )
            if acquired:
                try:
                    if sub._done.is_set():
                        break
                    batch = self._cut()
                    if batch:
                        self._commit_block(batch)
                finally:
                    self._commit_lock.release()
            _timeout_check()
        return sub.event


class BlockValidationPipeline:
    """The batched proof plane for one block.

    Phase 1 (plan): ask the driver for a batch plan per transfer record —
    `(shape_key, (input_points, output_points, proof_bytes))`, or None
    for host validation (fabtoken, malformed bytes, non-batchable kinds).

    Phase 2 (batched verify): group plans by shape; every group of at
    least `min_batch` rows goes through ONE call of the driver's
    `batch_verifier()` (the port's `BatchedTransferVerifier` on the
    pipeline's device, which raises on a block of mixed shapes — hence
    the grouping). Verdicts come back keyed
    `{tx_index: {transfer_index: bool}}`.

    Phase 3 is the ledger's: sequential per-tx `RequestValidator.validate`
    with MVCC over the block view; records with a verdict skip (True) or
    fail (False) the host proof check, everything else verifies on host.

    The SIGNATURE plane (`sign_verdicts`) is the same idea for the
    block's pk-kind signature obligations — owner/issuer/auditor Schnorr
    checks, collected across every tx and verified in ONE
    `BatchedSchnorrVerifier` call (no shape grouping needed: Schnorr
    rows are uniform). Non-pk identity kinds (nym, htlc) always stay
    host-verified.

    `device`: None is the card (`crypto.batch.resolve_device`, which
    raises where there is no CUDA); "cpu" runs the kernels' plain torch
    versions. A driver with a device of its own must name the same one
    (ValueError otherwise). `mesh`, a `DeviceMesh` whose first device is
    the pipeline's (ValueError otherwise; a `MeshConfig` names no device
    and raises TypeError), binds both planes: each block's
    `driver.batch_verifier(mesh=mesh)` and the `BatchedSchnorrVerifier`,
    whose stage calls then run over the mesh's row groups. The verdicts
    do not depend on it.

    A plane that cannot serve a block (a failed kernel build or
    verifier construction, a launch error, a deadline timeout, an open
    breaker) is handled by the device (`_plane_failed`):

    * on a CUDA device the block fails with `DevicePlaneError`: nothing
      of it commits and no row is re-verified on the host;
    * on the CPU the rows go to the host verifiers (`transfer_host_batch`,
      `sign.verify_many`, then the per-tx scalar checks), the reference's
      availability rule, whose verdicts are the reference's.

    Neither is quiet: a proof-plane failure counts in
    `ledger.block.batch_errors`, a sign-plane host fallback in
    `batch.sign.host_fallbacks`, and each writes a `verify.*` /
    `sign.*` flight event (`device_error` on the card, `host_fallback`
    on the CPU).

    Resilience (utils/resilience.py): each device dispatch runs under
    `bounded_call` with the plane's wall budget (`device_deadline_s`: 120
    s on the card, unbounded on the CPU; a hung call is abandoned at the
    deadline and its late result discarded), and each plane carries a
    circuit breaker — repeated failures/timeouts OPEN it so later blocks
    fail fast (card) or skip to host (CPU) with no deadline paid, and a
    half-open probe after cooldown re-engages the device plane by
    itself. The kernels' libraries are loaded (`ops/_build.py`, which
    compiles them on a cold machine) when a verifier is built, outside
    the bounded call, so a cold build never trips the deadline.
    """

    def __init__(self, validator: RequestValidator, policy: BlockPolicy,
                 mesh=None, device=None):
        self.validator = validator
        self.policy = policy
        self.device = resolve_device(device)
        self.mesh = None if mesh is None else mesh_on_device(mesh, self.device)
        driver_device = getattr(validator.driver, "device", self.device)
        if not same_device(driver_device, self.device):
            raise ValueError(
                f"the driver runs its batched planes on {driver_device!r} "
                f"but the pipeline on {self.device}: pass the same device"
            )
        # batched signature plane state: the verifier is built lazily on
        # first use. A construction failure records into the `sign`
        # circuit breaker (utils/resilience.py) — an open breaker skips
        # even obligation collection until its cooldown expires and a
        # half-open probe re-tries, so a transient failure heals instead
        # of disabling device signatures for the process lifetime.
        self._sign_verifier = None

    def _plane_failed(self, plane: str, reason: str, **flight) -> None:
        """`plane` ("verify" or "sign") cannot serve this block. On a CUDA
        device: raise `DevicePlaneError` (chained to the exception being
        handled, if any), failing the block. On the CPU: record a
        `<plane>.host_fallback` flight event and return, and the caller
        hands the rows to the host verifiers."""
        if self.device.type == "cuda":
            mx.flight(f"{plane}.device_error", reason=reason, **flight)
            raise DevicePlaneError(
                f"{plane} plane on {self.device}: {reason}; the block fails "
                "and no row is re-verified on the host"
            )
        mx.flight(f"{plane}.host_fallback", reason=reason, **flight)

    def _load_kernels(self) -> None:
        """Build (on a cold machine) and load the CUDA kernels' libraries
        before a verifier is built: outside `bounded_call`, so the first
        block pays the build here and never the deadline there. Nothing
        to load on the CPU."""
        if self.device.type == "cuda":
            from ...ops import _build

            _build.build_all()

    def proof_verdicts(
        self, requests: Sequence[TokenRequest],
        timings: Optional[dict] = None,
        host_verdicts: Optional[Dict[int, Dict[int, bool]]] = None,
    ) -> Dict[int, Dict[int, bool]]:
        """`timings`, when passed, is filled with the critical-path
        split of this call: `grouping_s` (plan + same-shape grouping)
        and `device_verify_s` (time inside batched verify calls,
        including failed ones that degraded to host).

        `host_verdicts`, when passed as a dict, receives True-only
        verdicts from the batch-first HOST pass over every row the
        device plane left behind (`_host_proof_batch`). They are kept
        OUT of the returned device verdicts so the
        `ledger.validate.batched/host` accounting (and every fallback
        counter) still describes the device plane alone; the ledger
        merges the two maps only when handing verdicts to the per-tx
        validator. `None` (the default) skips the host pass — direct
        callers see the exact device-only behavior."""
        if timings is None:
            timings = {}
        timings.setdefault("grouping_s", 0.0)
        timings.setdefault("device_verify_s", 0.0)
        if not self.policy.use_batched:
            return {}
        driver = self.validator.driver
        plan = getattr(driver, "transfer_batch_plan", None)
        if plan is None:
            return {}
        t0 = time.monotonic()
        groups: Dict[tuple, List[Tuple[int, int, tuple]]] = {}
        for ti, req in enumerate(requests):
            for ri, rec in enumerate(req.transfers):
                p = plan(rec.action)
                if p is None:
                    continue
                shape, row = p
                groups.setdefault(shape, []).append((ti, ri, row))
        timings["grouping_s"] = time.monotonic() - t0

        verdicts: Dict[int, Dict[int, bool]] = {}
        verifier = None
        # rows the device plane leaves behind (small groups, open
        # breaker, failed/timed-out dispatches, no device plane at all):
        # the batch-first HOST pass below still verifies them in one
        # native multiexp + one block-level Fiat-Shamir call before the
        # per-tx scalar loop sees them
        leftovers: List[Tuple[int, int, tuple]] = []
        device_dead = False
        brk = resilience.breaker("verify")
        deadline_s = resilience.device_deadline_s("verify", self.device)
        for shape, rows in sorted(groups.items()):
            if device_dead or len(rows) < max(1, self.policy.min_batch):
                leftovers.extend(rows)
                continue
            if not brk.allow():
                # open breaker: fail fast (card) or instant host fallback
                # (CPU) — no deadline paid, no worker stacked onto a sick
                # backend
                self._plane_failed("verify", "breaker_open",
                                   shape=str(shape), txs=len(rows))
                leftovers.extend(rows)
                continue
            if verifier is None:
                try:
                    self._load_kernels()
                    verifier = driver.batch_verifier(mesh=self.mesh)
                except Exception:
                    # construction failures (a failed kernel build, OOM
                    # building tables) are handled as verify failures
                    brk.record_failure()
                    mx.counter("ledger.block.batch_errors").inc()
                    logger.exception("proof plane: verifier construction failed")
                    self._plane_failed("verify", "construct")
                    device_dead = True
                    leftovers.extend(rows)
                    continue
                if verifier is None:
                    # the driver HAS no batched plane: neither success
                    # nor failure — release the admission (else a
                    # half-open probe would stay consumed forever)
                    brk.cancel_probe()
                    device_dead = True
                    leftovers.extend(rows)
                    continue

            def _device_verify(rows=rows):
                # device-plane fault point: firing here (INSIDE the
                # bounded worker, so a `hang` kind is governed by the
                # deadline) exercises the degrade-to-host path below
                faults.fire("batch.verify")
                return verifier.verify([row for _, _, row in rows])

            tg = time.monotonic()
            try:
                with mx.span(
                    "ledger.block.batch_verify", shape=str(shape), txs=len(rows)
                ):
                    ok = resilience.bounded_call(
                        _device_verify, deadline_s, plane="verify"
                    )
            except resilience.DeviceTimeout:
                # the dispatch outlived its wall budget: abandon it (the
                # straggler's late result is discarded by the supervisor)
                # — the block must not stall
                brk.record_failure(timeout=True)
                mx.counter("ledger.block.batch_errors").inc()
                logger.warning(
                    "proof plane: batched verify of %d %s rows timed out "
                    "(worker abandoned, result discarded)", len(rows), shape,
                )
                self._plane_failed("verify", "timeout",
                                   shape=str(shape), txs=len(rows))
                leftovers.extend(rows)
                continue
            except Exception:
                brk.record_failure()
                mx.counter("ledger.block.batch_errors").inc()
                logger.exception(
                    "proof plane: batched verify of %d %s rows failed",
                    len(rows), shape,
                )
                self._plane_failed("verify", "error",
                                   shape=str(shape), txs=len(rows))
                leftovers.extend(rows)
                continue
            finally:
                timings["device_verify_s"] += time.monotonic() - tg
            brk.record_success()
            mx.flight(
                "verify.device", shape=str(shape), txs=len(rows),
                ok=int(sum(1 for g in ok if g)),
            )
            for (ti, ri, _), good in zip(rows, ok):
                verdicts.setdefault(ti, {})[ri] = bool(good)
        if host_verdicts is not None:
            self._host_proof_batch(leftovers, host_verdicts, timings)
        return verdicts

    def _host_proof_batch(
        self, rows: List[Tuple[int, int, tuple]],
        verdicts: Dict[int, Dict[int, bool]], timings: dict,
    ) -> None:
        """Batch-first HOST pass over transfer rows the device plane left
        behind: the driver's `transfer_host_batch` hook recomputes every
        proof's commitments in one native multiexp call and derives all
        Fiat-Shamir challenges in one block-level sha256 batch
        (`hostmath.hash_to_zr_many`). True-only: a True verdict skips the
        per-tx scalar proof check; None/False rows (undecidable shapes,
        malformed bytes, failed proofs) fall through to the scalar path
        that owns the precise error. An exception here degrades to the
        scalar path wholesale — accept/reject can never depend on it."""
        timings.setdefault("host_proof_batch_s", 0.0)
        if not rows:
            return
        hook = getattr(self.validator.driver, "transfer_host_batch", None)
        if hook is None:
            return
        from .pipeline import host_map

        t0 = time.monotonic()
        try:
            try:
                oks = host_map(hook, [row for _, _, row in rows])
            except Exception:
                logger.exception(
                    "host proof batch failed; scalar path verifies"
                )
                return
            batched = 0
            for (ti, ri, _), good in zip(rows, oks):
                if good is True:
                    batched += 1
                    verdicts.setdefault(ti, {})[ri] = True
            if batched:
                mx.counter("hostbatch.proof.rows").inc(batched)
                mx.flight(
                    "verify.host_batch", rows=len(rows), verified=batched
                )
        finally:
            timings["host_proof_batch_s"] += time.monotonic() - t0

    # ------------------------------------------------------ signature plane

    def sign_enabled(self) -> bool:
        """Whether pk-kind signature obligations route to the batched
        device plane. `sign_batched=None` (auto) decides from the
        pipeline's device: on where it is a CUDA device, off on the CPU
        (where the block's pk obligations still fold into the host
        batch pass, `_host_sign_batch`)."""
        if self.policy.sign_batched is not None:
            return self.policy.sign_batched
        return self.device.type == "cuda"

    def _collect_sign_obligations(self, requests: Sequence[TokenRequest]):
        """Walk a block's requests and split every signature obligation
        into batched rows (pk-kind identities from the shared identity
        cache) and a host count (non-pk kinds, unplannable records,
        empty/missing signatures — all verified by the host loop
        unchanged). Rows are `(pk_point, message, sig_raw)`; keys are
        `(tx_index, obligation_key, identity_bytes)`."""
        rows, keys, host = [], [], 0
        auditor = self.validator.auditor
        auditor_pk = identity.public_key(auditor) if auditor else None
        driver = self.validator.driver
        issue_plan = getattr(driver, "issue_sign_plan", None)
        transfer_plan = getattr(driver, "transfer_sign_plan", None)
        for ti, req in enumerate(requests):
            # the sign payload is marshalled lazily: a request with no
            # collectable pk obligation never pays the serialization
            # (the host validate pass re-marshals its own copy anyway)
            payload = None

            def _payload():
                nonlocal payload
                if payload is None:
                    payload = req.marshal_to_sign()
                return payload

            if auditor and req.auditor_signature:
                if auditor_pk is not None:
                    rows.append(
                        (auditor_pk.point, req.marshal_to_audit(),
                         req.auditor_signature)
                    )
                    keys.append((ti, SIG_AUDITOR, auditor))
                else:
                    host += 1
            for ii, rec in enumerate(req.issues):
                if not rec.signature or issue_plan is None:
                    continue  # no obligation / legacy driver: host decides
                ident = issue_plan(rec.action)
                if ident is None:
                    continue  # anonymous or unplannable: nothing to check
                pk = identity.public_key(ident)
                if pk is None:
                    host += 1
                    continue
                rows.append((pk.point, _payload(), rec.signature))
                keys.append((ti, ("issue", ii), ident))
            for ri, rec in enumerate(req.transfers):
                if transfer_plan is None:
                    continue
                owners = transfer_plan(rec.action)
                if owners is None or len(owners) != len(rec.signatures):
                    # unplannable / signature-count mismatch (the host
                    # check rejects the latter with its precise error)
                    host += len(rec.signatures)
                    continue
                for si, (ident, sig) in enumerate(zip(owners, rec.signatures)):
                    pk = identity.public_key(ident)
                    if pk is None:
                        host += 1  # nym/htlc/malformed: host-verified
                        continue
                    rows.append((pk.point, _payload(), sig))
                    keys.append((ti, ("transfer", ri, si), ident))
        return rows, keys, host

    def sign_verdicts(
        self, requests: Sequence[TokenRequest],
        timings: Optional[dict] = None,
    ) -> Dict[int, Dict[tuple, tuple]]:
        """One batched `BatchedSchnorrVerifier` pass over ALL pk-kind
        signature obligations of a block. Returns
        `{tx_index: {obligation_key: (identity_bytes, bool)}}` for
        `RequestValidator.validate(sig_verified=...)`. Failures are
        handled as the proof plane's (`_plane_failed`): any device error,
        deadline timeout, verifier construction failure or open breaker
        records into the `sign` circuit breaker and fails the block on
        the card; on the CPU it drops every row to the host loop
        (`batch.sign.host_fallbacks`), and an OPEN breaker skips even the
        obligation collection until a half-open probe heals it.
        `timings` gains `sign_verify_s` (time inside the batched call,
        including failed ones)."""
        if timings is None:
            timings = {}
        timings.setdefault("sign_verify_s", 0.0)
        if not self.sign_enabled():
            # device plane off (CPU auto / forced off): the batch-first
            # HOST pass still folds every pk obligation of the block into
            # one native multiexp + one Fiat-Shamir sha256 batch
            return self._host_sign_batch(requests, timings)
        brk = resilience.breaker("sign")
        if brk.rejecting() and self.device.type != "cuda":
            # open breaker (cooldown running) on the CPU: skip even the
            # collection — later blocks must not pay per-block
            # marshal/parse work against a plane known sick; the
            # half-open probe after cooldown re-engages it off this fast
            # path. On the card a block with rows to sign fails below.
            return {}
        rows, keys, host = self._collect_sign_obligations(requests)
        if host:
            mx.counter("batch.sign.host").inc(host)
        if not rows:
            return {}
        if len(rows) < max(1, self.policy.sign_min_batch):
            mx.counter("batch.sign.host").inc(len(rows))
            return {}
        if not brk.allow():
            # raced another thread's half-open probe: no second dispatch
            # stacked on the probe
            self._plane_failed("sign", "breaker_open", rows=len(rows))
            mx.counter("batch.sign.host").inc(len(rows))
            return {}
        if self._sign_verifier is None:
            try:
                from ...crypto.batch_sign import BatchedSchnorrVerifier

                self._load_kernels()
                self._sign_verifier = BatchedSchnorrVerifier(device=self.device,
                                                             mesh=self.mesh)
            except Exception:
                # one strike, like the latch this breaker replaced: a
                # construction failure is structural (import/OOM) and
                # per-block retries only re-pay marshal/import/log cost
                # — trip immediately; the half-open probe still heals a
                # transient one after cooldown
                brk.record_failure(trip_now=True)
                logger.exception(
                    "sign plane: verifier construction failed (breaker "
                    "heals via probe)"
                )
                self._plane_failed("sign", "construct", rows=len(rows))
                mx.counter("batch.sign.host_fallbacks").inc(len(rows))
                return {}

        def _device_sign():
            # device-plane fault point: inside the bounded worker, so a
            # `hang` kind is governed by the deadline, never the block
            faults.fire("batch.sign")
            return self._sign_verifier.verify(rows)

        t0 = time.monotonic()
        try:
            with mx.span("ledger.block.batch_sign", rows=len(rows)):
                verdicts = resilience.bounded_call(
                    _device_sign,
                    resilience.device_deadline_s("sign", self.device),
                    plane="sign",
                )
        except resilience.DeviceTimeout:
            brk.record_failure(timeout=True)
            logger.warning(
                "sign plane: batched verify timed out (worker abandoned, "
                "result discarded)"
            )
            self._plane_failed("sign", "timeout", rows=len(rows))
            mx.counter("batch.sign.host_fallbacks").inc(len(rows))
            return {}
        except Exception:
            brk.record_failure()
            logger.exception("sign plane: batched verify failed")
            self._plane_failed("sign", "error", rows=len(rows))
            mx.counter("batch.sign.host_fallbacks").inc(len(rows))
            return {}
        finally:
            timings["sign_verify_s"] += time.monotonic() - t0
        brk.record_success()
        out: Dict[int, Dict[tuple, tuple]] = {}
        device = 0
        for (ti, okey, ident), v in zip(keys, verdicts):
            if v is None:
                # the verifier could not parse this signature blob: the
                # host loop re-verifies and reports the precise error
                mx.counter("batch.sign.host").inc()
                continue
            device += 1
            out.setdefault(ti, {})[okey] = (ident, bool(v))
        mx.flight(
            "sign.device", rows=len(rows), device=device,
            ok=sum(1 for v in verdicts if v),
        )
        return out

    def _host_sign_batch(
        self, requests: Sequence[TokenRequest], timings: dict,
    ) -> Dict[int, Dict[tuple, tuple]]:
        """Batch-first HOST signature pass — the block's pk obligations
        verified via `crypto.sign.verify_many`: ONE native bn254 batch
        multiexp recomputes every Schnorr commitment and ONE block-level
        sha256 batch (`hostmath.hash_to_zr_many`) derives every
        Fiat-Shamir challenge, fanned over the commit-host worker pool
        (`pipeline.host_map`). True-only verdicts: rows that fail or
        don't parse get NO verdict and fall to the per-obligation scalar
        loop, which owns the precise error message — accept/reject can
        never depend on this pass. Shares the device plane's obligation
        collector, so statement pinning (`identity_bytes` echoed with
        each verdict) is identical."""
        timings.setdefault("host_sign_batch_s", 0.0)
        t0 = time.monotonic()
        try:
            rows, keys, host = self._collect_sign_obligations(requests)
            if host:
                mx.counter("batch.sign.host").inc(host)
            if not rows:
                return {}
            try:
                from ...crypto import sign as sign_mod
                from .pipeline import host_map

                oks = host_map(sign_mod.verify_many, rows)
            except Exception:
                mx.counter("batch.sign.host").inc(len(rows))
                logger.exception(
                    "host sign batch failed; block signatures scalar-verify"
                )
                return {}
            out: Dict[int, Dict[tuple, tuple]] = {}
            batched = 0
            for (ti, okey, ident), v in zip(keys, oks):
                if v is not True:
                    # None (unparseable blob) or False (bad signature):
                    # the scalar loop re-verifies and reports precisely
                    mx.counter("batch.sign.host").inc()
                    continue
                batched += 1
                out.setdefault(ti, {})[okey] = (ident, True)
            if batched:
                mx.counter("hostbatch.sign.rows").inc(batched)
                mx.flight(
                    "sign.host_batch", rows=len(rows), verified=batched
                )
            return out
        finally:
            timings["host_sign_batch_s"] += time.monotonic() - t0

    # ------------------------------------------------------ conservation

    def conservation_verdicts(
        self, requests: Sequence[TokenRequest],
        timings: Optional[dict] = None,
    ) -> Dict[int, Dict[int, bool]]:
        """Block-level vectorized conservation/type checks: every
        transfer action's tokens decode into one flat column and the
        per-action verdicts fall out of segment sums
        (`driver.validate_conservation_many`). True-only, keyed
        `{tx_index: {record_index: True}}` for
        `RequestValidator.validate(conservation=...)` — an action with
        no verdict runs the full scalar arithmetic, so the pass can only
        make blocks faster, never change accept/reject."""
        if timings is None:
            timings = {}
        timings.setdefault("host_conservation_batch_s", 0.0)
        hook = getattr(
            self.validator.driver, "validate_conservation_many", None
        )
        if hook is None:
            return {}
        t0 = time.monotonic()
        try:
            actions, keys = [], []
            for ti, req in enumerate(requests):
                for ri, rec in enumerate(req.transfers):
                    actions.append(rec.action)
                    keys.append((ti, ri))
            if not actions:
                return {}
            try:
                oks = hook(actions)
            except Exception:
                logger.exception(
                    "conservation batch failed; scalar checks run per tx"
                )
                return {}
            out: Dict[int, Dict[int, bool]] = {}
            batched = 0
            for (ti, ri), good in zip(keys, oks):
                if good is True:
                    batched += 1
                    out.setdefault(ti, {})[ri] = True
            if batched:
                mx.counter("hostbatch.conservation.rows").inc(batched)
            return out
        finally:
            timings["host_conservation_batch_s"] += time.monotonic() - t0
