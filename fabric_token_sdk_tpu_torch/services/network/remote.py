"""Multi-process network: a fault-tolerant TCP ledger node + thin client.

Counterpart of `fabric_token_sdk_tpu/services/network/remote.py`, with
its wire format: the same length-prefixed JSON frames, ops, fields and
error classes, so a port client talks to a JAX node and the reverse.
The SDK talks to a Fabric network over gRPC
(`token/services/network/fabric`); here a JSON-over-TCP node hosts the
MVCC ledger + validator, and `RemoteNetwork` exposes the same API surface
as the in-process `Network` so parties can live in separate processes.

The node's device: `LedgerServer(validator, device=None)` builds its
ledger on the card, whose batched planes launch the hand-written
kernels; `device="cpu"` runs their plain versions. A block whose plane
fails on the card raises `DevicePlaneError` (`orderer.py`): it reaches
the remote caller typed, as `RemoteError(error_class="DevicePlaneError")`,
is not retried, is no ground to fail over, and nothing of the block
commits.

Fault tolerance (client side):

* **Pooled persistent connection** with automatic reconnect — one socket
  per `RemoteNetwork`, re-dialed lazily after any transport failure (a
  restarted server is picked up transparently).
* **Retries with exponential backoff + jitter** for the idempotent ops
  (`status` / `exists` / `resolve` / `height`), counted under
  `remote.retry.*`.
* **Exactly-once submit**: a connection that dies with a submit in
  flight may or may not have committed server-side. The client NEVER
  resubmits blindly — it consults `status(tx_id)` first and adopts the
  recorded verdict if one exists (`remote.submit.recovered`); only a
  tx the ledger has never seen is resubmitted, and the ledger's
  in-flight dedup is the server half of the guarantee.
* **Typed remote errors**: a server-side failure arrives as
  `RemoteError` carrying the server's exception class
  (`.error_class`), not a blanket "malformed request".

Server side: per-op dispatch errors are logged with traceback and
returned typed (`remote.dispatch.errors.<op>`); inbound frames are
capped (`LedgerServer(max_frame=)`, by default `server_max_frame`: the
reference's 16 MiB, raised to hold a shipped block at the ledger's
`max_block_txs`) so a corrupt or hostile length prefix can never force
an arbitrary-size allocation. The cap is inbound only: the frames on the
wire are the reference's.

The reference's environment knobs are arguments or constants here, with
its defaults: `FTS_REMOTE_ENDPOINTS` is `endpoints=`,
`FTS_REMOTE_TIMEOUT_S`, `FTS_REMOTE_RETRIES` and `FTS_REMOTE_BACKOFF_S`
are `timeout`, `retries` and `backoff_s`, `FTS_REMOTE_MAX_FRAME` is the
server's `max_frame` (default `server_max_frame(policy)`), `FTS_OPS_FLIGHT_N`
is `DEFAULT_FLIGHT_N`.

Live ops plane: the node answers side-effect-free introspection RPCs —
`ops.health` (uptime, height, WAL state, queue depth, in-flight txs,
last-block critical-path breakdown), `ops.metrics` (a full
`Registry.snapshot()` over the wire, latency quantiles included) and
`ops.flight` (live flight-ring tail, `DEFAULT_FLIGHT_N` events unless
the frame names `n`). Each runs on its own handler
thread and never takes the orderer's commit lock, so a minutes-long
device verify cannot block a health probe; clients route them through
`_call_idempotent` (read-only, hence retry/backoff safe). A stopping
node answers in-flight probes with a typed `NodeStopped` error instead
of a silently dropped connection.

Fault injection: the client fires the `remote.send` / `remote.recv`
fault points around its frame I/O (`utils/faults.py`), which is how the
chaos suite proves the retry and exactly-once paths.
"""

from __future__ import annotations

import json
import random
import socket
import socketserver
import threading
import time
from typing import Callable, List, Optional, Tuple

from ...api.driver import ValidationError
from ...api.request import TokenRequest
from ...api.validator import RequestValidator
from ...models.token import ID
from ...utils import faults, profiler
from ...utils import metrics as mx
from ...utils.tracing import logger
from .ledger import FinalityEvent, Network, TxStatus
from .orderer import Backpressure, Submission
from .replication import NotLeader, StaleEpoch

DEFAULT_MAX_FRAME = 16 * 1024 * 1024  # 16 MiB: the client's cap, a server's floor
# a tx's room in a server's inbound cap: a block reaches a follower as one
# `repl.ship` frame, its journal record hex-encoded, ~330 KB a 2-in/2-out
# zkatdlog transfer; 1 MiB a tx leaves room for larger transfers
TX_FRAME_BYTES = 1024 * 1024
DEFAULT_FLIGHT_N = 64  # the ops.flight tail when the frame names no n
DEFAULT_TIMEOUT_S = 30.0
DEFAULT_RETRIES = 4
DEFAULT_BACKOFF_S = 0.05


def server_max_frame(policy) -> int:
    """A node's inbound frame cap: the reference's 16 MiB, raised so that
    the `repl.ship` frame of a block of `policy.max_block_txs` txs fits."""
    return max(DEFAULT_MAX_FRAME, policy.max_block_txs * TX_FRAME_BYTES)


class FrameTooLarge(ValueError):
    """A length prefix exceeded the frame cap (corrupt or hostile)."""


class RemoteError(RuntimeError):
    """A server-side failure, typed: `error_class` is the exception class
    name the server hit (e.g. "KeyError"), never a blanket message."""

    def __init__(self, message: str, error_class: Optional[str] = None):
        super().__init__(message)
        self.error_class = error_class


def _send_msg(sock: socket.socket, obj: dict) -> None:
    raw = json.dumps(obj).encode()
    sock.sendall(len(raw).to_bytes(4, "big") + raw)


def _recv_msg(sock: socket.socket, max_frame: Optional[int] = None) -> Optional[dict]:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    n = int.from_bytes(hdr, "big")
    cap = max_frame if max_frame is not None else DEFAULT_MAX_FRAME
    if n > cap:
        # reject BEFORE allocating: a corrupt/hostile prefix must not
        # drive an arbitrary-size allocation
        raise FrameTooLarge(f"frame of {n} bytes exceeds cap of {cap}")
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(min(65536, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return json.loads(buf.decode())


class LedgerServer:
    """Hosts a Network (orderer + endorser + committer) over TCP.

    Pass `network=` to serve a pre-built ledger (a `Network.restore` or
    `Network.recover` result — node-restart parity), which keeps its own
    device, or `validator=` to build a fresh one on `device` (None: the
    card, raising where there is no CUDA; "cpu": the kernels' plain
    versions); `wal_path` makes the fresh ledger journaled.
    `max_frame` caps an inbound frame (the reference's
    `FTS_REMOTE_MAX_FRAME`); by default `server_max_frame(policy)`, which
    holds a shipped block at the ledger's `max_block_txs` (64 MiB at 64
    txs, where a block of 2-in/2-out zkatdlog transfers ships as ~21 MB).
    `allow_reuse_address` lets a restarted node rebind its old port.
    """

    def __init__(self, validator: Optional[RequestValidator] = None,
                 host: str = "127.0.0.1", port: int = 0, policy=None,
                 network: Optional[Network] = None,
                 wal_path: Optional[str] = None, device=None,
                 max_frame: Optional[int] = None):
        # concurrent client submits land in the node's ordering queue and
        # group-commit into shared blocks (policy: orderer.BlockPolicy)
        if network is None:
            if validator is None:
                raise ValueError("LedgerServer needs a validator or a network")
            network = Network(validator, policy=policy, wal_path=wal_path, device=device)
        self.network = network
        self.max_frame = (max_frame if max_frame is not None
                          else server_max_frame(network.policy))
        self._started_unix = time.time()
        self._stopping = threading.Event()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # profile role: connection threads collapse under
                # `remote-handler` in the flamegraph export
                profiler.set_thread_role("remote-handler")
                with outer._conns_lock:
                    outer._conns.add(self.request)
                try:
                    self._serve()
                finally:
                    with outer._conns_lock:
                        outer._conns.discard(self.request)

            def _serve(self):
                while True:
                    try:
                        msg = _recv_msg(self.request, outer.max_frame)
                    except FrameTooLarge as e:
                        mx.counter("remote.frames.rejected").inc()
                        logger.warning("ledger server: %s", e)
                        try:
                            _send_msg(self.request, {
                                "ok": False, "error": str(e),
                                "error_class": "FrameTooLarge",
                            })
                        except OSError:
                            pass
                        return  # stream is desynced: drop the connection
                    except OSError:
                        return  # client reset mid-frame
                    if msg is None:
                        return
                    try:
                        _send_msg(self.request, outer._dispatch(msg))
                    except OSError:
                        return  # client went away before the response

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True  # restarted nodes rebind their port
            daemon_threads = True

        self._server = _Server((host, port), Handler)
        self.address: Tuple[str, int] = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    def start(self) -> "LedgerServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        # flag first: a probe racing the shutdown gets a typed
        # `NodeStopped` answer instead of a silently severed connection
        self._stopping.set()
        self._server.shutdown()
        self._server.server_close()
        # sever live client connections BEFORE tearing replication down:
        # once the shipper stops, an in-flight submit could still commit
        # locally without ever reaching a follower — if its ack escaped
        # to the client, that would be an acked tx a promoted follower
        # does not hold (acked-loss). Severed first, the ack cannot
        # flush; the client observes a dead node and resubmits through
        # its exactly-once path on the new leader.
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        # now the replication plane: the leader's links stop shipping, a
        # follower's watchdog stops (it must not promote during an
        # orderly stop)
        repl = getattr(self.network, "repl", None)
        if repl is not None:
            repl.close()

    def _dispatch(self, msg: dict) -> dict:
        op = msg.get("op", "?") if isinstance(msg, dict) else "?"
        if self._stopping.is_set():
            # typed shutdown answer for requests already in flight when
            # stop() began — clients can tell "node going away" from a
            # transport fault and react without a blind retry storm
            mx.counter("remote.dispatch.stopped").inc()
            return {"ok": False, "error": "ledger node is stopping",
                    "error_class": "NodeStopped"}
        # trace extraction: adopt the client's trace context so server
        # spans (dispatch, orderer, validate, WAL) stitch into ONE trace
        ctx = (
            mx.TraceContext.from_wire(msg.get("trace"))
            if isinstance(msg, dict) else None
        )
        try:
            with mx.use_trace(ctx):
                with mx.span("remote.server.dispatch", op=op):
                    return self._dispatch_op(op, msg)
        except ValidationError as e:
            return {"ok": False, "validation_error": str(e)}
        except Backpressure as e:
            # expected load shedding, not a server fault: no traceback,
            # typed so the client can back off and retry (the submission
            # never entered ordering — a retry is exactly-once safe)
            mx.counter("remote.dispatch.backpressure").inc()
            return {"ok": False, "error": str(e),
                    "error_class": "Backpressure"}
        except NotLeader as e:
            # expected replication answer, not a server fault: the client
            # fails over to the current leader (`_rediscover`)
            mx.counter("remote.dispatch.not_leader").inc()
            return {"ok": False, "error": str(e),
                    "error_class": "NotLeader"}
        except StaleEpoch as e:
            # fencing verdict for a zombie ex-leader: typed so its
            # shipper demotes itself instead of retrying (already counted
            # under `repl.stale_rejected` at the fence). The fencer's
            # ACTUAL epoch rides along so the zombie adopts it exactly —
            # a guessed demotion epoch could later collide with the real
            # leader's.
            return {"ok": False, "error": str(e),
                    "error_class": "StaleEpoch",
                    "epoch": getattr(e, "epoch", 0)}
        except Exception as e:  # defensive: never kill the server loop —
            # but never mask the failure either: log the traceback
            # server-side and hand the client the typed exception
            mx.counter(f"remote.dispatch.errors.{op}").inc()
            logger.exception("ledger server: op %s failed", op)
            return {"ok": False, "error": f"{type(e).__name__}: {e}",
                    "error_class": type(e).__name__}

    def _dispatch_op(self, op: str, msg: dict) -> dict:
        repl = getattr(self.network, "repl", None)
        if repl is not None and repl.role != "leader" and op in (
            "submit", "submit_many"
        ):
            # a follower (or a fenced ex-leader) must never take writes:
            # the client gets a typed answer and fails over to the leader
            raise NotLeader(
                f"node is a {repl.role} at epoch {repl.epoch}; "
                "submit to the current leader"
            )
        # ---- replication plane (services/network/replication.py): the
        # leader's shipper and the operator's promotion drive these; a
        # node without an attached ReplicaState answers typed instead of
        # guessing. NodeStopped still wins (checked in _dispatch), so a
        # follower mid-bootstrap observes a stopping node cleanly.
        if (op == "promote" or op == "repl.state" or op == "repl.bootstrap"
                or op == "repl.ship" or op == "repl.heartbeat"):
            if repl is None:
                return {"ok": False,
                        "error": "replication not enabled on this node",
                        "error_class": "ReplicationDisabled"}
            return repl.handle(op, msg)
        if op == "submit":
            ev = self.network.submit(bytes.fromhex(msg["request"]))
            # `transient` must cross the wire: a transient internal
            # fault is retry-safe (the ledger records no verdict), a
            # real rejection is final — remote callers need the same
            # distinction local ones get
            return {"ok": True, "status": ev.status.value, "message": ev.message,
                    "tx_id": ev.tx_id, "transient": ev.transient}
        if op == "submit_many":
            # deterministic multi-tx blocks over the wire: enqueue every
            # request (each under ITS OWN extracted trace context), then
            # cut + commit in arrival order — server half of
            # `RemoteNetwork.submit_many`
            # decode EVERY request before enqueuing ANY: a malformed
            # entry must fail the whole batch up front — enqueue-then-
            # fail would strand already-accepted txs in the ordering
            # queue (silently committed by later traffic, or never)
            # while the client was told the batch failed. The parsed
            # requests are handed straight to the ledger (no re-parse).
            parsed = [
                TokenRequest.from_bytes(bytes.fromhex(h))
                for h in msg["requests"]
            ]
            # pad/truncate the trace list to the request list: a length
            # mismatch from a buggy client must never drop requests
            # (zip would silently truncate the batch)
            traces = list(msg.get("traces") or ())[: len(parsed)]
            traces += [None] * (len(parsed) - len(traces))
            subs = []
            for request, wire in zip(parsed, traces):
                with mx.use_trace(mx.TraceContext.from_wire(wire)):
                    # cooperative under a bounded ordering queue — same
                    # contract (and helper) as Network.submit_many
                    subs.append(
                        self.network.submit_request_cooperative(request)
                    )
            self.network.flush()
            events = [s.result() for s in subs]
            return {"ok": True, "events": [
                {"tx_id": e.tx_id, "status": e.status.value,
                 "message": e.message, "transient": e.transient}
                for e in events
            ]}
        if op == "resolve":
            raw = self.network.resolve_input(ID(msg["tx_id"], msg["index"]))
            return {"ok": True, "output": raw.hex()}
        if op == "exists":
            return {"ok": True, "exists": self.network.exists(ID(msg["tx_id"], msg["index"]))}
        if op == "status":
            ev = self.network.status(msg["tx_id"])
            if ev is None:
                return {"ok": True, "status": None}
            return {"ok": True, "status": ev.status.value, "message": ev.message}
        if op == "height":
            return {"ok": True, "height": self.network.height()}
        # ---- live ops plane: side-effect-free introspection RPCs.
        # These run on the connection's own handler thread and never
        # touch the orderer's commit lock (see Network.health), so they
        # answer DURING a long device verify, not after it.
        if op == "ops.health":
            try:
                # refresh the memory gauges so the probe (and the
                # ops.metrics snapshot a live view fetches next) reports
                # CURRENT footprint, not the last data-plane sample
                from ...utils import sysmon

                sysmon.sample()
            except Exception:
                pass
            h = self.network.health()
            h["uptime_s"] = round(time.time() - self._started_unix, 3)
            h["started_unix"] = round(self._started_unix, 3)
            return {"ok": True, "health": h}
        if op == "ops.metrics":
            from ...ops._build import ALL_KERNELS

            from ...utils import devobs

            devobs.resolve()  # the finished dispatches' device times, into their histograms
            snap = mx.REGISTRY.snapshot()
            # each kernel's launch count (`Kernel.launches`), as counters
            snap["counters"].update({f"kernel.launches.{k.name}": k.launches
                                     for k in ALL_KERNELS if k.launches})
            return {"ok": True, "snapshot": snap}
        if op == "ops.flight":
            n = msg.get("n") or DEFAULT_FLIGHT_N
            return {"ok": True, "events": mx.FLIGHT.tail(max(1, int(n)))}
        return {"ok": False, "error": f"unknown op [{op}]",
                "error_class": "UnknownOp"}


class RemoteNetwork:
    """Client-side Network facade over a LedgerServer.

    Note: finality events are delivered on submit responses (poll-based),
    so each party process drives its own vault via `apply_finality`.
    """

    def __init__(self, address: Optional[Tuple[str, int]] = None,
                 timeout: float = DEFAULT_TIMEOUT_S,
                 retries: int = DEFAULT_RETRIES,
                 backoff_s: float = DEFAULT_BACKOFF_S,
                 endpoints: Optional[List[Tuple[str, int]]] = None):
        # failover: `endpoints` lists every node of a replicated cluster;
        # `address` stays the single-node form and, when given, is the
        # preferred first endpoint. `_rediscover()` re-probes the list
        # when the current node dies or answers NotLeader/NodeStopped.
        endpoints = [(str(h), int(p)) for h, p in (endpoints or ())]
        if address is not None:
            addr = (str(address[0]), int(address[1]))
            if addr not in endpoints:
                endpoints = [addr] + endpoints
        if not endpoints:
            raise ValueError("RemoteNetwork needs an address or endpoints=")
        self.endpoints: List[Tuple[str, int]] = endpoints
        self.address = endpoints[0]
        self.timeout = timeout
        self.retries = retries
        self.backoff_s = backoff_s
        self._listeners: List[Callable] = []
        self._lock = threading.Lock()  # guards the pooled socket
        self._sock: Optional[socket.socket] = None
        self._rng = random.Random()  # backoff jitter (decorrelates clients)

    # ------------------------------------------------------- transport

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _connect_locked(self) -> None:
        if self._sock is None:
            self._sock = socket.create_connection(self.address, timeout=self.timeout)
            mx.counter("remote.connects").inc()

    def _call(self, msg: dict) -> dict:
        """One request/response over the pooled connection. Any transport
        failure closes the socket (the next call re-dials) and raises
        ConnectionError/OSError; server-side failures raise typed
        ValidationError/RemoteError and keep the connection. The active
        trace context is injected into the request frame so server-side
        spans stitch into the caller's trace."""
        ctx = mx.current_trace()
        if ctx is not None:
            msg["trace"] = ctx.to_wire()
        with self._lock:
            self._connect_locked()
            # timed INSIDE the lock: the pooled connection serializes
            # callers, and waiting for another thread's in-flight call is
            # contention, not wire latency — only send→recv is observed
            t0 = time.monotonic()
            try:
                faults.fire("remote.send")
                _send_msg(self._sock, msg)
                faults.fire("remote.recv")
                resp = _recv_msg(self._sock)
            except (OSError, FrameTooLarge):
                # FaultConnectionDrop is a ConnectionError, hence OSError
                self._close_locked()
                raise
            if resp is None:
                self._close_locked()
                raise ConnectionError("ledger server closed the connection")
            elapsed = time.monotonic() - t0
        # transport round-trip latency, always on (completed exchanges
        # only — failed transports raise above): the remote leg of the
        # live ops plane's quantile set
        mx.histogram("remote.call.seconds").observe(elapsed)
        if not resp.get("ok"):
            if "validation_error" in resp:
                raise ValidationError(resp["validation_error"])
            if resp.get("error_class") == "Backpressure":
                # the server's admission control rejected the submission
                # BEFORE ordering: typed, retry-safe, exactly-once intact
                raise Backpressure(resp.get("error", "ordering queue full"))
            raise RemoteError(resp.get("error", "remote error"),
                              error_class=resp.get("error_class"))
        return resp

    def _backoff(self, attempt: int) -> None:
        delay = self.backoff_s * (2 ** attempt) * (0.5 + self._rng.random())
        time.sleep(min(delay, 2.0))

    # ------------------------------------------------------- failover

    def _probe_endpoint(self, addr: Tuple[str, int]) -> Optional[Tuple[str, int]]:
        """One fresh short-lived `ops.health` probe: returns (role,
        epoch) — a node with no repl section is a standalone leader at
        epoch -1 — or None for a dead/stopping node."""
        try:
            with socket.create_connection(
                addr, timeout=min(self.timeout, 2.0)
            ) as sock:
                sock.settimeout(min(self.timeout, 2.0))
                _send_msg(sock, {"op": "ops.health"})
                resp = _recv_msg(sock)
        except (OSError, FrameTooLarge, ValueError):
            return None
        if not resp or not resp.get("ok"):
            return None
        repl = (resp.get("health") or {}).get("repl")
        if repl is None:
            return ("leader", -1)
        return (str(repl.get("role")), int(repl.get("epoch", 0)))

    def _rediscover(self) -> bool:
        """Find the current leader: probe every configured endpoint and
        adopt the one claiming leadership, highest fencing epoch first
        (two nodes can both claim it across a failover — the zombie's
        epoch is strictly lower). Returns True when the pooled
        connection was re-pointed at a NEW address."""
        if len(self.endpoints) <= 1:
            return False
        best: Optional[Tuple[Tuple[str, int], int]] = None
        for addr in self.endpoints:
            info = self._probe_endpoint(addr)
            if info is None:
                continue
            role, epoch = info
            if role == "leader" and (best is None or epoch > best[1]):
                best = (addr, epoch)
        if best is None or best[0] == self.address:
            return False
        with self._lock:
            old, self.address = self.address, best[0]
            self._close_locked()
        mx.counter("remote.failover.switches").inc()
        mx.flight("failover", old=f"{old[0]}:{old[1]}",
                  new=f"{best[0][0]}:{best[0][1]}", epoch=best[1])
        logger.warning(
            "remote: failed over %s:%d -> %s:%d (epoch %d)",
            old[0], old[1], best[0][0], best[0][1], best[1],
        )
        return True

    @staticmethod
    def _failover_error(e: BaseException) -> bool:
        """A typed answer that means 'this node cannot take writes' —
        grounds to rediscover, exactly like a dead connection. A
        `DevicePlaneError` is not: the node is the leader and its card
        failed the block, which another node would not undo."""
        return isinstance(e, RemoteError) and e.error_class in (
            "NotLeader", "NodeStopped"
        )

    def _call_idempotent(self, msg: dict) -> dict:
        """Retry transport failures with exponential backoff + jitter —
        ONLY safe for ops that do not mutate ledger state."""
        op = msg.get("op")
        last: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            try:
                return self._call(msg)
            except (ConnectionError, OSError, RemoteError) as e:
                if isinstance(e, RemoteError) and not self._failover_error(e):
                    raise  # a real server-side failure: not retryable
                last = e
                if attempt < self.retries:
                    mx.counter(f"remote.retry.{op}").inc()
                    mx.counter("remote.retry.attempts").inc()
                    mx.flight("retry", op=op, attempt=attempt)
                    self._backoff(attempt)
                    # a dead/stopping/demoted node: look for the leader
                    # before the next attempt (no-op for single-endpoint
                    # clients)
                    self._rediscover()
        mx.counter("remote.retry.exhausted").inc()
        if isinstance(last, RemoteError):
            # exhausted on a TYPED refusal (NodeStopped/NotLeader with no
            # reachable leader): surface it typed, not as transport noise
            raise last
        raise ConnectionError(
            f"remote {op} failed after {self.retries + 1} attempts: {last}"
        ) from last

    # ------------------------------------------------------- Network API

    def subscribe(self, listener) -> None:
        self._listeners.append(listener)

    def submit(self, request_bytes: bytes) -> FinalityEvent:
        request = TokenRequest.from_bytes(request_bytes)
        # client half of the distributed trace: join the caller's trace
        # (ttx) or start one, and carry it across the wire in the frame
        ctx = mx.current_trace() or mx.new_trace()
        with mx.use_trace(ctx):
            with mx.span("remote.submit", tx=request.anchor):
                mx.flight("submit", tx=request.anchor, remote=True)
                event = self._submit_exactly_once(request.anchor, request_bytes)
        if not event.trace_id:
            event.trace_id = ctx.trace_id
        self._notify(event, request)
        return event

    def _submit_exactly_once(self, tx_id: str, request_bytes: bytes) -> FinalityEvent:
        """Submit with at-most-once commit semantics across retries: on a
        dropped connection, consult `status(tx_id)` BEFORE resubmitting —
        the commit may have raced the disconnect. The ledger's in-flight
        dedup covers the residual window where status is still empty.
        Each wire attempt and each status-recovery probe is a child span
        of the caller's `remote.submit`, so retries are visible in the
        tx's stitched trace."""
        msg = {"op": "submit", "request": request_bytes.hex()}
        last: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            try:
                with mx.span("remote.submit.attempt", attempt=attempt):
                    resp = self._call(msg)
                return FinalityEvent(
                    resp["tx_id"], TxStatus(resp["status"]), resp["message"],
                    transient=resp.get("transient", False),
                )
            except Backpressure as e:
                # rejected BEFORE ordering: a plain resubmit after backoff
                # is exactly-once safe by construction — no status probe
                # needed (the ledger never saw the tx)
                last = e
                if attempt >= self.retries:
                    raise
                mx.counter("remote.retry.backpressure").inc()
                mx.counter("remote.retry.attempts").inc()
                mx.flight("retry", op="submit", attempt=attempt, tx=tx_id,
                          backpressure=True)
                self._backoff(attempt)
                continue
            except (ConnectionError, OSError, RemoteError) as e:
                # a typed NotLeader/NodeStopped answer means the node
                # cannot take this write — treated exactly like a dead
                # connection: rediscover the leader, then ride the same
                # status-probe exactly-once machinery (an acked tx is
                # never lost or doubled across the switch)
                if isinstance(e, RemoteError) and not self._failover_error(e):
                    raise
                last = e
                if attempt >= self.retries:
                    break
                # counted only when actually retried (same accounting as
                # _call_idempotent)
                mx.counter("remote.retry.submit").inc()
                mx.counter("remote.retry.attempts").inc()
                mx.flight("retry", op="submit", attempt=attempt, tx=tx_id)
                self._backoff(attempt)
                self._rediscover()
                try:
                    with mx.span("remote.submit.recover", attempt=attempt):
                        known = self.status(tx_id)
                except (ConnectionError, OSError) as e2:
                    last = e2
                    continue
                if known is not None:
                    mx.counter("remote.submit.recovered").inc()
                    mx.flight("submit.recovered", tx=tx_id)
                    return known
                # the ledger has never recorded this tx: resubmitting is
                # safe (and dedup'd server-side regardless)
        mx.counter("remote.retry.exhausted").inc()
        if isinstance(last, RemoteError):
            # exhausted on a TYPED refusal (follower with no reachable
            # leader to fail over to): surface it typed
            raise last
        raise ConnectionError(
            f"submit of {tx_id} failed after {self.retries + 1} attempts: {last}"
        ) from last

    def submit_async(self, request_bytes: bytes) -> Submission:
        """API parity with the in-process `Network`: the wire protocol is
        request/response, so ordering happens server-side (the node's own
        Orderer batches concurrent submitters) and the handle returned
        here is already resolved."""
        event = self.submit(request_bytes)
        sub = Submission(None, TokenRequest.from_bytes(request_bytes))
        sub._resolve(event)
        return sub

    def submit_many(self, requests_bytes: List[bytes]) -> List[FinalityEvent]:
        """API parity with `Network.submit_many`: ship the whole batch in
        ONE wire call; the server enqueues everything and cuts
        deterministic blocks (`max_block_txs` txs each). Every request
        gets its OWN trace context, injected alongside the batch
        (`traces` field), so each tx's client leg, server orderer leg,
        batched verify, WAL append and finality stitch into one
        per-transaction trace. NOT retried on transport failure — a
        multi-tx batch is not idempotent; callers needing exactly-once
        semantics should use per-tx `submit`."""
        requests = [TokenRequest.from_bytes(rb) for rb in requests_bytes]
        ctxs = [mx.new_trace() for _ in requests]
        for req, ctx in zip(requests, ctxs):
            mx.flight("submit", trace=ctx, tx=req.anchor, remote=True)
        t0 = time.time()
        with mx.span("remote.submit_many", txs=len(requests)):
            resp = self._call({
                "op": "submit_many",
                "requests": [rb.hex() for rb in requests_bytes],
                "traces": [c.to_wire() for c in ctxs],
            })
        t1 = time.time()
        rows = resp["events"]
        if len(rows) != len(requests):
            # a short (or long) reply means txs lost finality silently —
            # surface the protocol violation instead of zip-truncating
            raise RemoteError(
                f"submit_many returned {len(rows)} events for "
                f"{len(requests)} requests",
                error_class="ProtocolError",
            )
        events: List[FinalityEvent] = []
        for req, ctx, row in zip(requests, ctxs, rows):
            event = FinalityEvent(
                row["tx_id"], TxStatus(row["status"]), row.get("message", ""),
                transient=row.get("transient", False),
                trace_id=ctx.trace_id,
            )
            # per-tx client leg: each tx spent the whole batched wire
            # call waiting client-side — record it in the tx's trace
            mx.record_span("remote.submit", t0, t1, trace=ctx, tx=req.anchor)
            self._notify(event, req)
            events.append(event)
        return events

    def resolve_input(self, token_id: ID) -> bytes:
        resp = self._call_idempotent(
            {"op": "resolve", "tx_id": token_id.tx_id, "index": token_id.index}
        )
        return bytes.fromhex(resp["output"])

    def exists(self, token_id: ID) -> bool:
        return self._call_idempotent(
            {"op": "exists", "tx_id": token_id.tx_id, "index": token_id.index}
        )["exists"]

    def status(self, tx_id: str) -> Optional[FinalityEvent]:
        resp = self._call_idempotent({"op": "status", "tx_id": tx_id})
        if resp["status"] is None:
            return None
        return FinalityEvent(tx_id, TxStatus(resp["status"]), resp.get("message", ""))

    def height(self) -> int:
        return self._call_idempotent({"op": "height"})["height"]

    # ------------------------------------------------------- ops plane

    def ops_health(self) -> dict:
        """Live node introspection (`ops.health`): uptime, height, WAL
        state, queue depth, in-flight txs, last-block critical-path
        breakdown. Read-only, so retried like the other idempotent ops."""
        return self._call_idempotent({"op": "ops.health"})["health"]

    def ops_metrics(self) -> dict:
        """The node's full `Registry.snapshot()` over the wire (counters,
        gauges, histograms WITH p50/p95/p99, span summary, phases)."""
        return self._call_idempotent({"op": "ops.metrics"})["snapshot"]

    def promote(self) -> int:
        """Explicit follower promotion (`promote` RPC) — the operator /
        chaos-harness entry point. Idempotent server-side (a leader
        answers with its current epoch), hence retry-safe. Returns the
        node's fencing epoch after promotion."""
        return int(self._call_idempotent({"op": "promote"})["epoch"])

    def ops_flight(self, n: Optional[int] = None) -> List[dict]:
        """Tail of the node's live flight-recorder ring (default
        `DEFAULT_FLIGHT_N` events) — the crash trail, without the crash."""
        msg: dict = {"op": "ops.flight"}
        if n is not None:
            msg["n"] = int(n)
        return self._call_idempotent(msg)["events"]

    def apply_finality(self, request_bytes: bytes) -> Optional[FinalityEvent]:
        """Receiver-side sync: given a request distributed off-band (the
        reference's recipient/ttx views), look up its final status on the
        ledger and replay it into local listeners (vault, ttxdb)."""
        request = TokenRequest.from_bytes(request_bytes)
        event = self.status(request.anchor)
        if event is not None:
            self._notify(event, request)
        return event

    def _notify(self, event: FinalityEvent, request: TokenRequest) -> None:
        """Per-listener crash isolation, mirroring the in-process ledger:
        a throwing finality listener is counted and logged, and the
        remaining listeners still run."""
        for listener in self._listeners:
            try:
                listener(event, request)
            except Exception:
                mx.counter("remote.listener.errors").inc()
                logger.exception(
                    "remote: finality listener failed for tx %s", event.tx_id
                )
