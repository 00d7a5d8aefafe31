"""In-memory token ledger: multi-tx blocks, MVCC, finality events.

Counterpart of `fabric_token_sdk_tpu/services/network/ledger.py`.
Reference: `token/services/network/*` (fabric/orion backends + vault
processor) plus the ordering service in front of them. Submissions enter
the `Orderer`'s queue (`orderer.py`); blocks are cut by size
policy and validated by the block pipeline — same-shape zkatdlog
transfer groups in ONE `BatchedTransferVerifier` call and the block's
pk-kind signatures in ONE `BatchedSchnorrVerifier` call, on the card
(`Network(..., device=None)`) or through the kernels' plain torch
versions (`device="cpu"`), host `RequestValidator` for the rest — then
committed atomically: intra-block MVCC (a double-spend inside a block
invalidates the LATER tx only), per-tx finality events, and
crash-isolated listener notification.

Durability (`wal.py`): when constructed with a `wal_path`, every cut
block is appended to an fsync'd CRC-framed write-ahead log *before* the
atomic merge, and a full snapshot is written every `snapshot_every`
blocks (compaction: the WAL's replayed prefix is truncated only after
the snapshot is durably on disk). `Network.recover(validator, path)`
rebuilds the ledger from the latest snapshot plus the WAL suffix, with
torn-tail tolerance — a node can be SIGKILLed mid-block and restart
without losing any finality it ever reported. Snapshots and journal
records are the JAX package's bytes: either package restores or
recovers what the other wrote.

Replication (`replication.py`): a leader's `self.repl` ships every
journaled record from the commit path; a follower applies them through
`apply_delta`/`install_snapshot`, which re-verify nothing. The remote
node (`remote.py`) serves this class over TCP.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple

from ...api.driver import ValidationError
from ...api.request import TokenRequest
from ...api.validator import RequestValidator, ValidationResult
from ...models.token import ID
from ...utils import devobs, faults, profiler, resilience, slo
from ...utils import metrics as mx
from ...utils.tracing import logger, tracer
from .orderer import (
    Backpressure,
    BlockPolicy,
    BlockValidationPipeline,
    Orderer,
    Submission,
)
from .wal import WALError, WriteAheadLog


class TxStatus(Enum):
    PENDING = "Pending"
    VALID = "Valid"
    INVALID = "Invalid"


@dataclass
class FinalityEvent:
    tx_id: str
    status: TxStatus
    message: str = ""
    # True: the rejection was an INTERNAL fault, not a deterministic
    # verdict — the submitter sees it, but nothing durable is recorded
    # (an identical resubmission may succeed). Never persisted.
    transient: bool = False
    # id of the distributed trace this tx's lifecycle was recorded under
    # (diagnostic only — never persisted, empty when tracing was off)
    trace_id: str = ""


@dataclass
class Block:
    number: int
    txs: List[str] = field(default_factory=list)
    timestamp: float = 0.0


class _BlockView:
    """MVCC overlay for one block: txs validate against committed state
    PLUS the writes of earlier valid txs in the same block. Outputs
    created earlier in the block are spendable; inputs consumed earlier
    in the block are conflicts (the later tx is invalidated). Nothing
    touches the committed maps until `merge()` — the block applies
    atomically or (on a crash mid-validate) not at all."""

    def __init__(self, state: Dict[str, bytes], spent: set):
        self._state = state
        self._spent = spent
        self._new: Dict[str, bytes] = {}
        self._consumed: set = set()

    def resolve(self, token_id: ID) -> bytes:
        key = token_id.key()
        if key in self._consumed or key in self._spent:
            raise ValidationError(f"token {token_id} already spent")
        raw = self._new.get(key)
        if raw is None:
            raw = self._state.get(key)
        if raw is None:
            raise ValidationError(f"token {token_id} does not exist")
        return raw

    def apply(self, tx_id: str, result: ValidationResult) -> None:
        for token_id in result.spent:
            key = token_id.key()
            self._consumed.add(key)
            self._new.pop(key, None)
        out_index = 0
        for _, outputs in result.outputs:
            for raw in outputs:
                self._new[ID(tx_id, out_index).key()] = raw
                out_index += 1

    def merge(self) -> None:
        for key in self._consumed:
            self._state.pop(key, None)
            self._spent.add(key)
        self._state.update(self._new)


class Network:
    """Shared ledger + orderer for a set of parties.

    `device` is where the batched planes run: None is the card
    (`crypto.batch.resolve_device`, raising where there is no CUDA),
    "cpu" the kernels' plain torch versions; a driver with a device of
    its own must name the same one (ValueError). `mesh`, a `DeviceMesh`
    laid over that device first (`parallel.sharding.make_mesh`), binds
    the block's batched planes to it (`BlockValidationPipeline`), for
    both engines; `restore` and `recover` take it too. On the card a
    block whose batched plane fails is not committed: its submitters get
    `DevicePlaneError` (orderer.py)."""

    def __init__(self, validator: RequestValidator,
                 policy: Optional[BlockPolicy] = None,
                 wal_path: Optional[str] = None,
                 snapshot_every: Optional[int] = None,
                 mesh=None, device=None):
        self.validator = validator
        self.policy = policy or BlockPolicy()
        self._state: Dict[str, bytes] = {}  # token key -> output bytes
        self._spent: set = set()  # token keys consumed (serials)
        self._blocks: List[Block] = []
        self._status: Dict[str, FinalityEvent] = {}
        self._listeners: List[Callable[[FinalityEvent, TokenRequest], None]] = []
        self._lock = threading.Lock()
        self._pipeline = BlockValidationPipeline(validator, self.policy,
                                                 mesh=mesh, device=device)
        self.device = self._pipeline.device
        self._orderer = Orderer(self._commit_block, self.policy)
        # pipelined block engine: overlap block N+1's batched device
        # verify with block N's host-validate/WAL/merge (pipeline.py).
        # FTS_BLOCK_PIPELINE=0, its one selector, restores the exact
        # sequential path.
        self._engine = None
        if os.environ.get("FTS_BLOCK_PIPELINE", "1") != "0":
            from .pipeline import PipelinedBlockEngine

            self._engine = PipelinedBlockEngine(
                self._verify_stage, self._commit_stage
            )
            self._orderer.set_engine(self._engine)
        # last committed block's critical-path breakdown, served live by
        # `health()` (assignment is atomic; readers copy)
        self.last_block: Optional[dict] = None
        # durability plane: journal + snapshot compaction (wal.py). For an
        # EXISTING journal use `Network.recover(...)` — constructing with
        # a non-empty wal_path appends after whatever is already there.
        self.snapshot_every = 64 if snapshot_every is None else snapshot_every
        self._wal: Optional[WriteAheadLog] = (
            WriteAheadLog(wal_path) if wal_path else None
        )
        self._snapshot_path = (str(wal_path) + ".snap") if wal_path else None
        # replication plane (replication.py): None on a standalone node,
        # attached by `replication.attach_leader`/`attach_follower`. The
        # commit path only ever calls `self.repl.on_commit(...)`, which is
        # bounded and degrade-only.
        self.repl = None

    # ------------------------------------------------------------ queries

    def resolve_input(self, token_id: ID) -> bytes:
        key = token_id.key()
        with self._lock:
            if key in self._spent:
                raise ValidationError(f"token {token_id} already spent")
            if key not in self._state:
                raise ValidationError(f"token {token_id} does not exist")
            return self._state[key]

    def exists(self, token_id: ID) -> bool:
        key = token_id.key()
        with self._lock:
            return key in self._state and key not in self._spent

    def status(self, tx_id: str) -> Optional[FinalityEvent]:
        with self._lock:
            return self._status.get(tx_id)

    def height(self) -> int:
        with self._lock:
            return len(self._blocks)

    def block(self, number: int) -> Optional[Block]:
        with self._lock:
            return self._blocks[number] if 0 <= number < len(self._blocks) else None

    def health(self) -> dict:
        """Side-effect-free node introspection. Touches only the ledger
        lock (held briefly by
        queries and the atomic merge) and the orderer's queue mutex,
        NEVER the orderer's commit lock, so a minutes-long device verify
        cannot block a health probe."""
        with self._lock:
            height = len(self._blocks)
            txs_final = len(self._status)
            last = dict(self.last_block) if self.last_block else None
        wal = None
        if self._wal is not None:
            try:
                size = os.path.getsize(self._wal.path)
            except OSError:
                size = -1
            wal = {
                "path": self._wal.path,
                "bytes": size,
                "sync": self._wal.sync,
                "poisoned": self._wal.poisoned,
            }
        return {
            "pid": os.getpid(),
            "height": height,
            "txs_final": txs_final,
            "queue_depth": self._orderer.pending(),
            "inflight": self._orderer.inflight(),
            "wal": wal,
            "last_block": last,
            # per-plane circuit-breaker states (utils/resilience.py):
            # {} until a plane dispatched at least once; a non-"closed"
            # entry is the live signal a device plane is degraded: its
            # blocks fail fast on the card, ride the host fallback on
            # the CPU
            "breakers": resilience.breaker_states(),
            # live error-budget state (utils/slo.py): per-SLO burn over
            # the sliding window
            "slo": slo.ENGINE.health_section(),
            # the dispatch ledger of every kernel launch, with times on
            # the card by CUDA events (utils/devobs.py), and the batched
            # planes' device
            "device": dict(devobs.health_section(), name=str(self.device)),
            # host-path parse caches (identity / parsed-request / raw
            # bytes): lifetime hit/miss counters — a cold or thrashing
            # cache shows up here before it shows up as host-leg wall
            "caches": self._caches_section(),
            # replication plane: None on a standalone node
            "repl": self.repl.health_section() if self.repl else None,
        }

    @staticmethod
    def _caches_section() -> dict:
        from ...api import request as request_mod

        def _c(name: str) -> int:
            return mx.REGISTRY.counter(name).value

        return {
            "identity": {
                "hits": _c("identity.cache.hits"),
                "misses": _c("identity.cache.misses"),
            },
            "request": {
                "entries": request_mod.cache_len(),
                "hits": _c("request.cache.hits"),
                "misses": _c("request.cache.misses"),
                "evictions": _c("request.cache.evictions"),
            },
            "parse": {
                "hits": _c("parse.cache.hits"),
                "misses": _c("parse.cache.misses"),
            },
        }

    # ------------------------------------------------------------ ordering

    def subscribe(self, listener: Callable[[FinalityEvent, TokenRequest], None]) -> None:
        self._listeners.append(listener)

    def submit(self, request_bytes: bytes) -> FinalityEvent:
        """Order + validate + commit one token request; blocks until the
        block containing it commits (driving the group commit if this
        caller wins the race). Returns the finality event (also pushed to
        subscribers)."""
        sub = self.submit_async(request_bytes)
        # drive under the tx's trace (minted at enqueue, or the caller's
        # — ttx / remote dispatch); a dedup'd resubmission has no trace
        # of its own and use_trace(None) keeps any caller context live
        with mx.use_trace(sub.trace):
            with tracer.span("network.submit", tx=sub.request.anchor):
                return sub.result()

    def submit_async(self, request_bytes: bytes) -> Submission:
        """Enqueue a request into ordering; returns a Submission handle
        whose `result()` waits for (and, if needed, drives) block commit."""
        return self.submit_request(TokenRequest.from_bytes(request_bytes))

    def submit_request(self, request: TokenRequest) -> Submission:
        """`submit_async` for an already-parsed request (the remote
        node's batched submit path decodes up front — no double parse).
        The active trace context (or a fresh one, minted only when the
        request actually enters ordering — dedup'd resubmissions never
        mint orphan traces) is captured into the Submission so
        block-commit spans land in this tx's trace."""
        with self._lock:
            known = self._status.get(request.anchor)
        if known is not None:  # idempotent resubmission
            mx.counter("network.submit.resubmissions").inc()
            mx.flight("submit", tx=request.anchor, dedup=True)
            sub = Submission(None, request)
            sub._resolve(known)
            return sub
        ctx = mx.current_trace() or mx.new_trace()
        with mx.use_trace(ctx):
            return self._orderer.enqueue(request)

    def submit_request_cooperative(self, request: TokenRequest) -> Submission:
        """`submit_request` for BATCH submitters under a bounded ordering
        queue: instead of surfacing `Backpressure` mid-batch (stranding
        the already enqueued prefix), drain the queue with a flush and
        retry — admission control sheds load from OTHER submitters while
        a deterministic batch still lands whole. Shared by the local and
        the remote-server `submit_many` paths."""
        while True:
            try:
                return self.submit_request(request)
            except Backpressure:
                mx.counter("orderer.backpressure.flushes").inc()
                self._orderer.flush()

    def submit_many(self, requests_bytes: List[bytes]) -> List[FinalityEvent]:
        """Deterministic multi-tx blocks: enqueue everything (cooperating
        with admission control), then cut + commit in arrival order
        (`max_block_txs` txs per block)."""
        subs = [
            self.submit_request_cooperative(TokenRequest.from_bytes(rb))
            for rb in requests_bytes
        ]
        self._orderer.flush()
        return [s.result() for s in subs]

    def flush(self) -> None:
        """Force-commit everything pending in the ordering queue."""
        self._orderer.flush()

    # ------------------------------------------------------------ commit

    def _split_fresh(
        self, subs: List[Submission], resolve_known: bool = True,
    ) -> Tuple[List[Submission], Dict[str, List[Submission]]]:
        """Partition a cut into fresh submissions and duplicates: an
        anchor already recorded resolves immediately from the recorded
        event (idempotent resubmission); an anchor appearing twice in one
        cut validates once. `resolve_known=False` is the verify stage's
        PROVISIONAL split — it skips work without resolving or counting,
        because the commit stage re-checks under the final state."""
        fresh: List[Submission] = []
        dup_of: Dict[str, List[Submission]] = {}
        with self._lock:
            for sub in subs:
                anchor = sub.request.anchor
                known = self._status.get(anchor)
                if known is not None:
                    if resolve_known:
                        mx.counter("network.submit.resubmissions").inc()
                        sub._resolve(known)
                elif anchor in dup_of:
                    # same anchor twice in one cut: validate once
                    if resolve_known:
                        mx.counter("network.submit.resubmissions").inc()
                        dup_of[anchor].append(sub)
                else:
                    fresh.append(sub)
                    dup_of[anchor] = []
        return fresh, dup_of

    def _verify_stage(self, subs: List[Submission]) -> dict:
        """Stage A of the pipelined engine: the batched device verify of
        one cut block — state-independent (proofs are checked against
        request bytes, never ledger state), so it safely overlaps the
        commit of the previous block. Returns verdicts keyed by
        SUBMISSION identity: the commit stage re-runs the dedup split
        under the final committed state (a duplicate racing across two
        in-flight blocks must resolve from the recorded verdict), and
        identity keys survive that re-split where indices would not."""
        cut_mono, cut_unix = time.monotonic(), time.time()
        timings: dict = {}
        fresh, _dups = self._split_fresh(subs, resolve_known=False)
        requests = [s.request for s in fresh]
        host_pv: Dict[int, Dict[int, bool]] = {}
        verdicts = self._pipeline.proof_verdicts(
            requests, timings, host_verdicts=host_pv
        )
        # the batched signature plane is state-independent too (payloads
        # and identities come from request bytes), so it overlaps the
        # previous block's commit exactly like the proof plane
        sig_verdicts = self._pipeline.sign_verdicts(requests, timings)
        # block-level vectorized conservation: also state-independent
        # (it checks the ACTION-claimed bytes; the per-tx input_match leg
        # pins them to ledger state before any verdict is consumed)
        cons_verdicts = self._pipeline.conservation_verdicts(
            requests, timings
        )
        return {
            "verdicts": {id(fresh[ti]): v for ti, v in verdicts.items()},
            "sig_verdicts": {
                id(fresh[ti]): v for ti, v in sig_verdicts.items()
            },
            "cons_verdicts": {
                id(fresh[ti]): v for ti, v in cons_verdicts.items()
            },
            "host_verdicts": {
                id(fresh[ti]): v for ti, v in host_pv.items()
            },
            "timings": timings,
            "cut_mono": cut_mono,
            "cut_unix": cut_unix,
        }

    def _commit_stage(self, subs: List[Submission], pre: Optional[dict]) -> None:
        """Stage B of the pipelined engine (commit-worker thread)."""
        self._commit_block(subs, pre=pre, attach_errors=True)

    def _commit_block(self, subs: List[Submission],
                      pre: Optional[dict] = None,
                      attach_errors: bool = False) -> None:
        """Validate + commit one cut block (serialized end to end —
        sequential mode under the orderer's commit lock, pipelined mode
        on the engine's single commit worker). Every submission in the
        cut is GUARANTEED a resolution — even on an internal crash — or
        its waiters would spin forever. `attach_errors` (pipelined mode)
        additionally attaches an escaping exception to each stranded
        submission so `result()` re-raises it on the waiter's stack."""
        try:
            self._commit_block_inner(subs, pre)
        except Exception as e:
            if attach_errors:
                for sub in subs:
                    if not sub.done():
                        sub._commit_error = e
            raise
        finally:
            stranded = [s for s in subs if not s.done()]
            if stranded:  # internal error escaped: fail them loudly
                mx.counter("ledger.commit.stranded").inc(len(stranded))
                for sub in stranded:
                    sub._resolve(
                        FinalityEvent(
                            sub.request.anchor, TxStatus.INVALID,
                            "internal commit error (see ledger logs)",
                            transient=True,
                        )
                    )

    def _commit_block_inner(self, subs: List[Submission],
                            pre: Optional[dict] = None) -> None:
        fresh, dup_of = self._split_fresh(subs)
        if not fresh:
            return
        if pre is not None and "device_error" in pre:
            # stage A's batched plane failed on the card: the block's
            # fresh txs fail in its height order, and nothing commits
            raise pre["device_error"]
        requests = [s.request for s in fresh]
        # queue-wait leg of the critical path: how long each submission
        # sat in the ordering queue before its cut picked it up (in
        # pipelined mode the cut happened at verify-stage entry — use
        # the stamped cut time, not the commit stage's start)
        if pre is not None:
            cut_mono = pre.get("cut_mono") or time.monotonic()
            cut_unix = pre.get("cut_unix") or time.time()
        else:
            cut_mono, cut_unix = time.monotonic(), time.time()
        queue_wait_max = 0.0
        for sub in fresh:
            if sub.enqueued_at:
                wait_s = max(0.0, cut_mono - sub.enqueued_at)
                queue_wait_max = max(queue_wait_max, wait_s)
                mx.histogram("ledger.block.queue_wait.seconds").observe(wait_s)
                mx.record_span(
                    "orderer.queue", sub.enqueued_unix, cut_unix,
                    trace=sub.trace, tx=sub.request.anchor,
                )
        with mx.span("ledger.block.validate", txs=len(requests)) as blk:
            # Validation runs OUTSIDE the ledger lock: the device verify
            # (or a cold kernel build) and the per-tx host checks must not
            # starve concurrent reads. This is safe because every state
            # WRITER is serialized (commit lock, or the engine's single
            # commit worker) — readers under `self._lock` simply observe
            # consistent pre-block state until the atomic merge below.
            if pre is None:
                timings: dict = {}
                host_pv: Dict[int, Dict[int, bool]] = {}
                verdicts = self._pipeline.proof_verdicts(
                    requests, timings, host_verdicts=host_pv
                )
                sig_verdicts = self._pipeline.sign_verdicts(requests, timings)
                cons_verdicts = self._pipeline.conservation_verdicts(
                    requests, timings
                )
            else:
                # stage A already verified this block (overlapping the
                # previous block's commit): adopt its verdicts by
                # submission identity. fresh-at-commit is a subset of
                # fresh-at-verify, so no fresh sub can lack coverage
                # unless stage A found no batchable group for it.
                timings = dict(pre.get("timings") or {})
                timings.setdefault("grouping_s", 0.0)
                timings.setdefault("device_verify_s", 0.0)
                timings.setdefault("sign_verify_s", 0.0)
                pv = pre.get("verdicts") or {}
                verdicts = {
                    ti: pv[id(s)]
                    for ti, s in enumerate(fresh) if id(s) in pv
                }
                psv = pre.get("sig_verdicts") or {}
                sig_verdicts = {
                    ti: psv[id(s)]
                    for ti, s in enumerate(fresh) if id(s) in psv
                }
                pcv = pre.get("cons_verdicts") or {}
                cons_verdicts = {
                    ti: pcv[id(s)]
                    for ti, s in enumerate(fresh) if id(s) in pcv
                }
                phv = pre.get("host_verdicts") or {}
                host_pv = {
                    ti: phv[id(s)]
                    for ti, s in enumerate(fresh) if id(s) in phv
                }
            commit_time = time.time()
            view = _BlockView(self._state, self._spent)
            events: List[FinalityEvent] = []
            t0 = time.monotonic()
            # sub-leg attribution of the host tail: the per-tx loop runs
            # on this one thread, so a thread-local collector decomposes
            # host_validate_s into the named `ledger.host.*` legs
            with profiler.collect() as host_legs:
                for ti, request in enumerate(requests):
                    # device verdicts (True/False) win over the host
                    # batch's True-only rows; the two sets are disjoint
                    # by construction (host rows are device leftovers)
                    dv, hv = verdicts.get(ti), host_pv.get(ti)
                    proofs = {**hv, **dv} if (dv and hv) else (dv or hv)
                    # per-tx validation runs under the TX's trace, not
                    # the committing thread's — whoever wins the race
                    with mx.use_trace(fresh[ti].trace):
                        event = self._validate_tx(
                            request, view, commit_time, proofs,
                            sig_verdicts.get(ti), cons_verdicts.get(ti),
                        )
                    if fresh[ti].trace is not None:
                        event.trace_id = fresh[ti].trace.trace_id
                    events.append(event)
            host_validate_s = time.monotonic() - t0
            faults.fire("ledger.commit_block")
            # WAL append BEFORE the atomic merge: once the record is
            # fsync'd the block is durable — a crash between here and the
            # merge redoes it on recovery (clients that never got an
            # answer re-learn the verdict via status()). A crash before
            # here loses only unacknowledged work.
            wal_s = 0.0
            if self._wal is not None:
                t0 = time.monotonic()
                record = self._wal_record(requests, events, view, commit_time)
                self._wal.append(record)
                wal_s = time.monotonic() - t0
                mx.flight(
                    "wal.append", block=len(self._blocks), bytes=len(record),
                    txs=[e.tx_id for e in events if not e.transient],
                )
                if self.repl is not None:
                    # ship the journaled record to followers BEFORE the
                    # submitters are resolved (below): an acknowledged tx
                    # is replicated first. Degrade-only for the leader —
                    # the wait is bounded, a slow/hung/dead follower is
                    # dropped loudly (counted + breaker), never stalls
                    # this commit.
                    self.repl.on_commit(len(self._blocks), record)
            t0 = time.monotonic()
            with self._lock:
                # atomic apply + finalize; transient-fault events resolve
                # their submitter but leave no durable trace
                view.merge()
                block = Block(
                    len(self._blocks),
                    [e.tx_id for e in events if not e.transient],
                    commit_time,
                )
                self._blocks.append(block)
                for event in events:
                    if not event.transient:
                        self._status[event.tx_id] = event
                self._record_block_metrics(requests, events, verdicts)
            merge_s = time.monotonic() - t0
            # per-block critical-path breakdown: where this block's wall
            # time went (queue wait / grouping / device verify / host
            # validate incl. fallbacks / WAL fsync / atomic merge)
            breakdown = {
                "queue_wait_max_s": round(queue_wait_max, 6),
                "grouping_s": round(timings.get("grouping_s", 0.0), 6),
                "device_verify_s": round(timings.get("device_verify_s", 0.0), 6),
                "sign_verify_s": round(timings.get("sign_verify_s", 0.0), 6),
                # batch-first host passes (FTS_HOST_BATCH): block-level
                # sign / proof / conservation work hoisted out of the
                # per-tx loop — their wall is NOT in host_validate_s
                "host_sign_batch_s": round(
                    timings.get("host_sign_batch_s", 0.0), 6
                ),
                "host_proof_batch_s": round(
                    timings.get("host_proof_batch_s", 0.0), 6
                ),
                "host_conservation_batch_s": round(
                    timings.get("host_conservation_batch_s", 0.0), 6
                ),
                "host_validate_s": round(host_validate_s, 6),
                "wal_s": round(wal_s, 6),
                "merge_s": round(merge_s, 6),
            }
            # the host leg decomposed (utils/profiler.py sub-leg timers):
            # exclusive per-leg seconds of THIS block's host-validate loop
            for leg_name in profiler.LEGS:
                breakdown[f"host_{leg_name}_s"] = round(
                    host_legs.get(leg_name, 0.0), 6
                )
            if pre is not None:
                # pipelined engine: how much of THIS block's device
                # verify ran while the previous block's commit stage was
                # still busy — the overlap the pipeline exists to create
                breakdown["overlap_s"] = round(pre.get("overlap_s", 0.0), 6)
            mx.histogram("ledger.block.host_validate.seconds").observe(
                host_validate_s
            )
            mx.histogram("ledger.block.merge.seconds").observe(merge_s)
            # per-block wall of the batch-first host passes (zero-valued
            # blocks skipped: the quantiles should describe blocks that
            # actually ran a pass)
            if timings.get("host_sign_batch_s", 0.0) > 0:
                mx.histogram("ledger.block.host_sign_batch.seconds").observe(
                    timings["host_sign_batch_s"]
                )
            if timings.get("host_proof_batch_s", 0.0) > 0:
                mx.histogram("ledger.block.host_proof_batch.seconds").observe(
                    timings["host_proof_batch_s"]
                )
            if timings.get("host_conservation_batch_s", 0.0) > 0:
                mx.histogram(
                    "ledger.block.host_conservation.seconds"
                ).observe(timings["host_conservation_batch_s"])
            # whole-block commit latency, always on (the SLO engine
            # reads it), plus the breakdown `health()` reports for the
            # LAST committed block
            commit_wall_s = time.monotonic() - cut_mono
            mx.histogram("ledger.block.commit.seconds").observe(commit_wall_s)
            self.last_block = {
                "number": block.number,
                "txs": len(requests),
                "committed_unix": round(commit_time, 3),
                "commit_s": round(commit_wall_s, 6),
                "breakdown": breakdown,
            }
            if blk is not None:
                blk.attrs.update(breakdown)
            mx.flight(
                "block.commit", block=block.number,
                txs=[r.anchor for r in requests],
                traces=[s.trace.trace_id if s.trace else None for s in fresh],
                **breakdown,
            )
        # error-budget bookkeeping (throttled internally): breaches must
        # surface during load even when nothing polls `health()`
        slo.ENGINE.tick()
        # snapshot compaction: still under the orderer's commit lock (the
        # only WAL writer), outside the ledger lock (snapshot() retakes
        # it). The block is already durable in the journal by now, so a
        # compaction failure must never poison its acknowledgement — the
        # journal just keeps growing until a later compaction succeeds.
        if (
            self._wal is not None
            and self.snapshot_every > 0
            and len(self._blocks) % self.snapshot_every == 0
        ):
            try:
                self._compact()
            except Exception:
                mx.counter("wal.snapshot_failures").inc()
                logger.exception(
                    "ledger: snapshot compaction failed; journal keeps growing"
                )
        # listeners run outside the ledger lock; resolve afterwards so a
        # submitter returning from submit() sees vault/db effects applied
        for event, request in zip(events, requests):
            if not event.transient:
                self._notify(event, request)
        for sub, event in zip(fresh, events):
            sub._resolve(event)
            for dup in dup_of.get(event.tx_id, ()):
                dup._resolve(event)

    def _validate_tx(self, request: TokenRequest, view: _BlockView,
                     commit_time: float,
                     proofs: Optional[Dict[int, bool]],
                     sigs: Optional[Dict[tuple, tuple]] = None,
                     cons: Optional[Dict[int, bool]] = None) -> FinalityEvent:
        tx_id = request.anchor
        try:
            with mx.span("network.validate", tx=tx_id):
                result = self.validator.validate(
                    request, view.resolve, now=commit_time,
                    transfer_proofs=proofs, sig_verified=sigs,
                    conservation=cons,
                )
            view.apply(tx_id, result)
            mx.counter("network.tx.valid").inc()
            return FinalityEvent(tx_id, TxStatus.VALID)
        except ValidationError as e:
            mx.counter("network.tx.invalid").inc()
            return FinalityEvent(tx_id, TxStatus.INVALID, str(e))
        except Exception as e:  # defensive: one bad tx never aborts a block
            logger.exception("ledger: unexpected validation error for %s", tx_id)
            mx.counter("ledger.validate.unexpected_errors").inc()
            mx.counter("network.tx.invalid").inc()
            return FinalityEvent(
                tx_id, TxStatus.INVALID,
                f"internal validation error: {type(e).__name__}: {e}",
                transient=True,
            )

    def _record_block_metrics(self, requests, events, verdicts) -> None:
        mx.counter("ledger.blocks.committed").inc()
        mx.histogram(
            "ledger.block.size", buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256)
        ).observe(len(requests))
        batched = sum(len(v) for v in verdicts.values())
        transfers = sum(len(r.transfers) for r in requests)
        mx.counter("ledger.validate.batched").inc(batched)
        mx.counter("ledger.validate.host").inc(transfers - batched)
        if transfers:
            mx.histogram(
                "ledger.block.batched_frac",
                buckets=(0.0, 0.25, 0.5, 0.75, 0.9, 1.0),
            ).observe(batched / transfers)
        mx.gauge("network.height").set(len(self._blocks))

    # ------------------------------------------------------------ durability

    def _wal_record(self, requests, events, view: _BlockView,
                    commit_time: float) -> bytes:
        """One journal record = one cut block: the raw request bytes (for
        audit/replay), the per-tx verdicts, and the exact durable state
        delta the merge will apply. Replay applies the delta — it never
        re-validates, so recovery is deterministic and cheap regardless
        of how expensive the original proofs were. Transient (internal-
        fault) events leave no durable trace here either."""
        from ...crypto.serialization import dumps

        return dumps(
            {
                "height": len(self._blocks),
                "ts": commit_time,
                # wire_bytes: the exact bytes each request was parsed
                # from when unmodified since (skips a full re-serialize
                # on this hot path); replay decodes both forms identically
                "requests": [r.wire_bytes() for r in requests],
                "txs": [
                    [e.tx_id, e.status.value, e.message]
                    for e in events if not e.transient
                ],
                "consumed": sorted(view._consumed),
                "outputs": dict(view._new),
            }
        )

    def _compact(self) -> None:
        """Write a full snapshot (atomic tmp+rename, fsync'd — including
        the DIRECTORY, so the rename is durable before the truncate can
        be) and only then truncate the journal. A crash in between
        leaves snapshot AND journal, whose replayed prefix is skipped by
        height."""
        from .wal import fsync_dir

        raw = self.snapshot()
        tmp = f"{self._snapshot_path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as fh:
            fh.write(raw)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._snapshot_path)
        if self._wal.sync:
            fsync_dir(self._snapshot_path)
        self._wal.reset()
        mx.counter("wal.snapshots").inc()

    # ---------------------------------------------------------- replication

    def _apply_wal_record(self, d: dict) -> Block:
        """Apply one decoded WAL record's durable delta to the in-memory
        maps — the no-reverify replay path shared by crash recovery and
        follower delta apply. The record IS the verdict: state delta and
        per-tx statuses are applied as journaled, never re-validated.
        Caller owns locking and height sequencing."""
        for key in d["consumed"]:
            self._state.pop(key, None)
            self._spent.add(key)
        self._state.update(d["outputs"])
        txs = []
        for tx_id, status, message in d["txs"]:
            self._status[tx_id] = FinalityEvent(tx_id, TxStatus(status), message)
            txs.append(tx_id)
        block = Block(d["height"], txs, d["ts"])
        self._blocks.append(block)
        return block

    def apply_delta(self, record: bytes) -> int:
        """Follower-side replication apply: journal one shipped WAL
        record to this node's OWN journal, then apply it through the
        no-reverify replay path. Idempotent below the current height
        (re-shipped records are skipped, not re-applied); a height GAP
        raises `WALError` — the follower missed records and must be
        re-bootstrapped, never guess-merged. Returns the new height."""
        from ...crypto.serialization import loads

        faults.fire("repl.apply")
        d = loads(record)
        height = d["height"]
        with self._lock:
            if height < len(self._blocks):
                mx.counter("repl.apply.skipped").inc()
                return len(self._blocks)
            if height > len(self._blocks):
                raise WALError(
                    f"replication gap: shipped record at height {height} "
                    f"but follower holds {len(self._blocks)} blocks "
                    "(re-bootstrap required)"
                )
            if self._wal is not None:
                # journal-first, same as the leader: a follower that
                # crashes after this fsync recovers the block
                self._wal.append(record)
            self._apply_wal_record(d)
            new_height = len(self._blocks)
        mx.counter("repl.applied.records").inc()
        mx.gauge("network.height").set(new_height)
        # follower-side snapshot compaction, same cadence as the leader
        # (degrade-only: a failure just means the journal keeps growing)
        if (
            self._wal is not None
            and self.snapshot_every > 0
            and new_height % self.snapshot_every == 0
        ):
            try:
                self._compact()
            except Exception:
                mx.counter("wal.snapshot_failures").inc()
                logger.exception(
                    "repl: follower compaction failed; journal keeps growing"
                )
        return new_height

    def install_snapshot(self, raw: bytes) -> int:
        """Follower-side bootstrap: replace the live in-memory state with
        the leader's snapshot wholesale, persist it as this node's own
        `<wal>.snap`, and truncate the local journal — the shipped deltas
        that follow build on exactly this base. Returns the new height."""
        from ...crypto.serialization import loads

        d = loads(raw)
        with self._lock:
            self._state = dict(d["state"])
            self._spent = set(d["spent"])
            self._blocks = [Block(*row) for row in d["blocks"]]
            self._status = {
                t: FinalityEvent(t, TxStatus(s), m)
                for t, (s, m) in d["status"].items()
            }
            height = len(self._blocks)
        if self._wal is not None:
            try:
                self._compact()
            except Exception:
                mx.counter("wal.snapshot_failures").inc()
                logger.exception(
                    "repl: bootstrap snapshot persist failed; follower "
                    "holds the state in memory only until the next "
                    "successful compaction"
                )
        mx.counter("repl.bootstraps").inc()
        mx.gauge("network.height").set(height)
        mx.flight("repl.bootstrap", height=height, bytes=len(raw))
        return height

    def _notify(self, event: FinalityEvent, request: TokenRequest) -> None:
        """Per-listener crash isolation: a throwing finality listener is
        counted and logged, never allowed to abort the commit loop."""
        for listener in self._listeners:
            try:
                listener(event, request)
            except Exception:
                mx.counter("ledger.listener.errors").inc()
                logger.exception(
                    "ledger: finality listener failed for tx %s", event.tx_id
                )

    # --------------------------------------------------- checkpoint/resume

    def snapshot(self) -> bytes:
        """Serialize ledger state (checkpoint; reference parity: vault +
        ledger recovery on node restart)."""
        from ...crypto.serialization import dumps

        with self._lock:
            return dumps(
                {
                    "state": dict(self._state),
                    "spent": sorted(self._spent),
                    "blocks": [[b.number, b.txs, b.timestamp] for b in self._blocks],
                    "status": {
                        t: [e.status.value, e.message]
                        for t, e in self._status.items()
                    },
                }
            )

    @classmethod
    def restore(cls, validator: RequestValidator, raw: bytes,
                policy: Optional[BlockPolicy] = None,
                device=None, mesh=None) -> "Network":
        from ...crypto.serialization import loads

        d = loads(raw)
        net = cls(validator, policy=policy, mesh=mesh, device=device)
        net._state = dict(d["state"])
        net._spent = set(d["spent"])
        net._blocks = [Block(*row) for row in d["blocks"]]
        net._status = {
            t: FinalityEvent(t, TxStatus(s), m) for t, (s, m) in d["status"].items()
        }
        return net

    @classmethod
    def recover(cls, validator: RequestValidator, wal_path: str,
                policy: Optional[BlockPolicy] = None,
                snapshot_every: Optional[int] = None,
                device=None, mesh=None) -> "Network":
        """Rebuild a crashed node's ledger: latest snapshot (if any) plus
        a replay of the WAL suffix, then keep journaling to the same
        files. Records at heights the snapshot already covers are skipped
        (the crash-between-snapshot-and-truncate window); a torn final
        record is discarded by `WriteAheadLog.replay`. A height GAP means
        the journal lost acknowledged blocks — that is unrecoverable and
        raises `WALError` rather than resurrecting a forked ledger."""
        from ...crypto.serialization import loads

        snap_path = str(wal_path) + ".snap"
        if os.path.exists(snap_path):
            with open(snap_path, "rb") as fh:
                net = cls.restore(validator, fh.read(), policy=policy,
                                  device=device, mesh=mesh)
        else:
            net = cls(validator, policy=policy, mesh=mesh, device=device)
        wal = WriteAheadLog(wal_path)
        replayed = 0
        records = 0
        # streaming replay (replay_iter): one record in memory at a time,
        # so recovering a multi-GiB journal costs O(largest record) RSS
        for _off, raw in wal.replay_iter():
            records += 1
            d = loads(raw)
            height = d["height"]
            if height < len(net._blocks):
                if replayed:
                    # a low height is only legitimate BEFORE the first
                    # applied record (the snapshot-covered prefix); after
                    # that it means two blocks were journaled at one
                    # height — a forked journal, not a replayable one
                    raise WALError(
                        f"wal {wal_path}: duplicate record at height "
                        f"{height} after replay began"
                    )
                continue  # prefix already captured by the snapshot
            if height > len(net._blocks):
                raise WALError(
                    f"wal {wal_path}: record at height {height} but ledger "
                    f"recovered only {len(net._blocks)} blocks (journal gap)"
                )
            net._apply_wal_record(d)
            replayed += 1
        mx.counter("wal.replayed.records").inc(records)
        net._wal = wal
        net._snapshot_path = snap_path
        if snapshot_every is not None:
            net.snapshot_every = snapshot_every
        mx.counter("wal.recoveries").inc()
        mx.counter("wal.replayed.blocks").inc(replayed)
        mx.flight("wal.recover", blocks=len(net._blocks), replayed=replayed)
        mx.gauge("network.height").set(len(net._blocks))
        logger.info(
            "ledger: recovered %d blocks (%d from wal replay) from %s",
            len(net._blocks), replayed, wal_path,
        )
        return net
