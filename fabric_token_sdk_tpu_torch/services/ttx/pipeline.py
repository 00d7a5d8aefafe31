"""Pipelined client path: prove→submit overlap.

Counterpart of `fabric_token_sdk_tpu/services/ttx/pipeline.py`, by copy. A `DevicePlaneError` from a block on the card is a submission
failure like any other: it stops the pipeline and is re-raised on the
caller's stack.

The reference decouples request assembly from ordering (`token/services/
ttx/ordering.go` runs as its own view); this is the throughput twin of
that split for batch clients. Proof GENERATION is the client's dominant
cost (`BatchedTransferProver` — seconds per group even on device), and a
sequential client alternates: prove group k, submit group k, wait for
server-side validation, prove group k+1... so the client's prove plane
and the server's verify plane each idle while the other works.

`PipelinedSubmitter` overlaps them with one background submit worker and
a depth-1 hand-off queue (double buffer, mirroring the server-side
`PipelinedBlockEngine`): while group k is in flight — on the wire, in
the server's ordering queue, through its batched verify and commit —
the CALLING thread is already proving group k+1. Group order is
preserved (single worker, FIFO hand-off), results come back in builder
order, and the first submission failure is re-raised on the caller's
stack after the worker drains.

Backpressure: a `Backpressure` rejection from the node's admission
control is retried inside the worker with exponential backoff + jitter
(`ttx.pipeline.backpressure`) — the reject happens BEFORE ordering, so
the retry preserves exactly-once.

Overlap accounting mirrors the block engine: `ttx.pipeline.overlap_frac`
is the fraction of total prove wall time that ran while a submission was
in flight — 0 means the pipeline never helped (groups too small or the
server too fast to matter), 1 means proving was fully hidden behind
server-side validation.
"""

from __future__ import annotations

import queue
import random
import threading
import time
from typing import Callable, Iterable, List

from ...utils import metrics as mx
from ..network.orderer import Backpressure
from ..network.pipeline import BusyClock


class PipelinedSubmitter:
    """Submit groups of token requests while proving the next group.

    `network` is any object with the `submit_many(List[bytes])` contract:
    the port's in-process `Network` or its `RemoteNetwork`, whose
    `submit_many` raises the node's `Backpressure` as the same type.
    `retries`/`backoff_s` govern the worker's Backpressure retry loop.
    """

    def __init__(self, network, retries: int = 8, backoff_s: float = 0.05):
        self.network = network
        self.retries = retries
        self.backoff_s = backoff_s
        self._rng = random.Random()  # backoff jitter

    # ------------------------------------------------------------ worker

    def _submit_with_backoff(self, requests: List[bytes]):
        for attempt in range(self.retries + 1):
            try:
                return self.network.submit_many(requests)
            except Backpressure:
                if attempt >= self.retries:
                    raise
                mx.counter("ttx.pipeline.backpressure").inc()
                delay = (
                    self.backoff_s * (2 ** attempt)
                    * (0.5 + self._rng.random())
                )
                time.sleep(min(delay, 2.0))

    # ------------------------------------------------------------ run

    def run(self, builders: Iterable[Callable[[], List[bytes]]]) -> List[list]:
        """Run every builder (the PROVE work — each returns one group's
        request-bytes list) on the calling thread while a worker submits
        completed groups; returns the per-group finality-event lists in
        builder order. The first submission failure aborts the pipeline
        and re-raises after in-flight work settles."""
        handoff: queue.Queue = queue.Queue(maxsize=1)
        results: dict = {}
        failure: List[BaseException] = []
        submit_clock = BusyClock()

        def worker():
            while True:
                item = handoff.get()
                if item is None:
                    return
                if failure:
                    continue  # drain hand-offs so the caller never blocks
                idx, requests = item
                submit_clock.start()
                try:
                    with mx.span("ttx.pipeline.submit", group=idx,
                                 txs=len(requests)):
                        results[idx] = self._submit_with_backoff(requests)
                    mx.counter("ttx.pipeline.groups").inc()
                    mx.counter("ttx.pipeline.txs").inc(len(requests))
                except BaseException as e:  # surfaced on the caller's stack
                    failure.append(e)
                finally:
                    submit_clock.stop()

        t = threading.Thread(
            target=worker, name="fts-ttx-submit", daemon=True
        )
        t.start()
        prove_s = 0.0
        overlap_s = 0.0
        n_groups = 0
        try:
            for idx, build in enumerate(builders):
                t0 = time.monotonic()
                c0 = submit_clock.value()
                requests = build()  # the prove work — overlaps the wire
                prove_s += time.monotonic() - t0
                overlap_s += submit_clock.value() - c0
                n_groups = idx + 1
                if failure:
                    break  # worker died: stop proving, surface below
                handoff.put((idx, requests))
        finally:
            handoff.put(None)
            t.join()
        if prove_s > 0:
            mx.gauge("ttx.pipeline.overlap_frac").set(
                round(min(1.0, overlap_s / prove_s), 6)
            )
        if failure:
            raise failure[0]
        return [results[i] for i in range(n_groups)]


def pipelined_submit(network, builders,
                     retries: int = 8,
                     backoff_s: float = 0.05) -> List[list]:
    """Convenience wrapper: `PipelinedSubmitter(network).run(builders)`."""
    return PipelinedSubmitter(
        network, retries=retries, backoff_s=backoff_s
    ).run(builders)
