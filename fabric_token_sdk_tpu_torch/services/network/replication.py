"""Replicated ledger plane: WAL shipping, promotion, fencing epochs.

Counterpart of `fabric_token_sdk_tpu/services/network/replication.py`,
with the same frames, epoch file and counters: a port follower
replicates a JAX leader and the reverse. Every robustness layer of a
node (WAL and recovery, breakers) hardens ONE node; a dead leader still
takes the service down. This module turns "replay after death" into
"replay continuously, then promote":

* **Leader**: a `Shipper` with one link (thread + bounded queue) per
  follower. `Network._commit_block_inner` hands every journaled WAL
  record to `ReplicaState.on_commit` right after the fsync'd append and
  BEFORE submitters are resolved, so an acknowledged tx is replicated
  first. The wait is bounded (`ship_timeout_s`) and the plane is
  degrade-only: a slow/hung/dead follower is dropped LOUDLY
  (`repl.ship.dropped` / `repl.ship.ack_timeouts`, per-link circuit
  breaker gating reconnects) and never stalls the leader's commit. With
  zero followers nothing attaches and the commit path is byte-identical
  to a standalone node; a node that wants no replication does not
  attach.
* **Follower**: a `LedgerServer` whose network carries a follower
  `ReplicaState`. New framed ops: `repl.state` (height/epoch/role),
  `repl.bootstrap` (full snapshot install), `repl.ship` (one WAL record,
  applied through the SAME no-reverify replay path recovery uses and
  journaled to the follower's own WAL: it re-verifies nothing and
  launches no kernel), `repl.heartbeat` (lease +
  lag), and `promote`. Submits sent to a follower get a typed
  `NotLeader` answer, so a failing-over client never forks the ledger.
* **Catch-up**: on every (re)connect the link asks `repl.state`, sends a
  full snapshot if the leader's journal no longer covers the follower's
  height (compaction), then streams the journal suffix via
  `WriteAheadLog.replay_iter` — O(one record) memory, and records the
  follower already holds are skipped idempotently by height.
* **Fencing**: the promotion epoch is persisted next to the journal
  (`<wal>.epoch`, fsync'd). `promote` bumps it; every `repl.*` message
  carries the sender's epoch and a receiver at a HIGHER epoch rejects it
  with a typed `StaleEpoch` (`repl.stale_rejected`) — a zombie
  ex-leader's stale appends are rejected, never merged, and the zombie
  demotes itself (`repl.demotions`) the moment it learns of the newer
  epoch. A message at a higher epoch is adopted (and demotes a leader).
* **Promotion**: explicit (`promote` RPC, e.g. from an operator or the
  chaos harness) or automatic: `attach_follower(auto_promote=True)`
  arms a lease watchdog that promotes the follower after `lease_s`
  seconds of heartbeat silence.

The reference's environment knobs are arguments here, with its defaults
(`DEFAULT_*` below): `FTS_REPL_LEASE_S` is `lease_s`,
`FTS_REPL_SHIP_TIMEOUT_S`, `FTS_REPL_QUEUE_MAX` and
`FTS_REPL_HEARTBEAT_S` are the shipper's `ship_timeout_s`, `queue_max`
and `heartbeat_s`, `FTS_REPL_AUTO_PROMOTE` is `auto_promote`; `FTS_REPL`
has no counterpart.

Fault sites (`utils/faults.py`): `repl.ship` and
`repl.heartbeat` fire on the link thread around sends (so error/drop/
delay/hang degrade ONE link, never the commit path), `repl.apply` fires
in `Network.apply_delta` on the follower.

Client failover lives in `remote.RemoteNetwork` (`endpoints=`): on a dead connection or a typed `NotLeader` /
`NodeStopped` answer it re-probes every endpoint's `ops.health`, adopts
the leader with the highest epoch (`remote.failover.switches`), and the
existing status-probe exactly-once machinery guarantees an acknowledged
tx is never lost or doubled across the switch.
"""

from __future__ import annotations

import os
import queue
import socket
import threading
import time
from typing import List, Optional, Tuple

from ...utils import faults, profiler
from ...utils import metrics as mx
from ...utils import resilience
from ...utils.tracing import logger
from .wal import fsync_dir

DEFAULT_SHIP_TIMEOUT_S = 5.0
DEFAULT_QUEUE_MAX = 128
DEFAULT_HEARTBEAT_S = 0.5
DEFAULT_LEASE_S = 3.0


class ReplicationError(RuntimeError):
    """A replication-protocol violation (unknown op, bad role)."""


class NotLeader(ReplicationError):
    """A mutating op was sent to a follower — clients must fail over."""


class StaleEpoch(ReplicationError):
    """A fenced-off message from a stale epoch (zombie ex-leader).

    Carries the rejecting node's epoch so the zombie can demote to the
    fencer's ACTUAL epoch — guessing (e.g. `own epoch + 1`) could leave
    a later re-promotion at an epoch equal to the real leader's, and two
    leaders must never share an epoch."""

    def __init__(self, message: str, epoch: int = 0):
        super().__init__(message)
        self.epoch = epoch


# ------------------------------------------------------------ epoch file


def _load_epoch(path: Optional[str]) -> int:
    if not path:
        return 0
    try:
        with open(path) as fh:
            return int(fh.read().strip() or 0)
    except (OSError, ValueError):
        return 0


def _store_epoch(path: Optional[str], epoch: int) -> None:
    """Persist the fencing epoch durably (atomic tmp+rename, fsync'd
    including the directory): a node restarting after a crash must come
    back at the epoch it last held, or fencing would not survive the
    exact failure it exists for."""
    if not path:
        return
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        fh.write(str(epoch))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    fsync_dir(path)


# ------------------------------------------------------------ state


class ReplicaState:
    """Per-node replication state: role, fencing epoch, and (on the
    leader) the shipper. Attached to a `Network` as `network.repl` by
    `attach_leader` / `attach_follower`; `Network.health()` publishes
    `health_section()` so lag and role ride the existing `ops.health`
    RPC (the `repl=` column of `ftstop top`). A follower promotes itself
    after `lease_s` seconds of heartbeat silence when its watchdog runs."""

    def __init__(self, network, role: str, epoch_path: Optional[str] = None,
                 lease_s: float = DEFAULT_LEASE_S):
        self.network = network
        self.role = role
        self.epoch_path = epoch_path
        self.epoch = _load_epoch(epoch_path)
        self.shipper: Optional[Shipper] = None
        self.leader_height = network.height()
        self.last_heartbeat = time.monotonic()
        self.lease_s = lease_s
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None

    # ------------------------------------------------------ introspection

    def health_section(self) -> dict:
        with self._lock:
            section = {"role": self.role, "epoch": self.epoch}
            if self.shipper is not None:
                links = self.shipper.link_states()
                section["followers"] = links
                lags = [l["lag"] for l in links if l["lag"] is not None]
                section["lag"] = max(lags) if lags else 0
            else:
                lag = max(0, self.leader_height - self.network.height())
                section["lag"] = lag
                section["leader_height"] = self.leader_height
                section["heartbeat_age_s"] = round(
                    time.monotonic() - self.last_heartbeat, 3
                )
        return section

    # ------------------------------------------------------ role changes

    def promote(self, reason: str = "rpc") -> int:
        """Become the leader: bump + persist the fencing epoch FIRST (a
        crash right after must come back fenced-high), then flip the
        role. Idempotent on an existing leader."""
        with self._lock:
            if self.role == "leader":
                return self.epoch
            self.epoch += 1
            _store_epoch(self.epoch_path, self.epoch)
            self.role = "leader"
            epoch = self.epoch
        mx.counter("repl.promotions").inc()
        mx.flight(
            "repl.promote", epoch=epoch, reason=reason,
            height=self.network.height(),
        )
        logger.warning(
            "repl: promoted to leader at epoch %d height %d (%s)",
            epoch, self.network.height(), reason,
        )
        return epoch

    def demote(self, peer_epoch: int, why: str) -> None:
        """Step down: a higher epoch exists somewhere — this node's
        writes are fenced off, so it must stop acting as a leader (a
        demoted node answers submits with `NotLeader`)."""
        with self._lock:
            if peer_epoch > self.epoch:
                self.epoch = peer_epoch
                _store_epoch(self.epoch_path, self.epoch)
            if self.role != "leader":
                return
            self.role = "follower"
            self.last_heartbeat = time.monotonic()
        mx.counter("repl.demotions").inc()
        mx.flight("repl.demoted", epoch=peer_epoch, why=why)
        logger.warning("repl: demoted to follower (%s, epoch %d)", why,
                       peer_epoch)

    def _fence(self, msg_epoch: int, op: str) -> None:
        """Reject lower epochs (typed `StaleEpoch`), adopt higher ones —
        adopting demotes a leader. A LEADER also rejects its own epoch:
        promotion always bumps, so an equal-epoch `repl.*` frame arriving
        at a leader can only mean a second leader (split brain) — refuse
        it rather than fork-merge."""
        with self._lock:
            if msg_epoch < self.epoch or (
                msg_epoch == self.epoch and self.role == "leader"
            ):
                mx.counter("repl.stale_rejected").inc()
                mx.flight("repl.fenced", op=op, msg_epoch=msg_epoch,
                          epoch=self.epoch)
                raise StaleEpoch(
                    f"{op} from epoch {msg_epoch} rejected: this node is "
                    f"a {self.role} fenced at epoch {self.epoch}",
                    epoch=self.epoch,
                )
        if msg_epoch > self.epoch:
            self.demote(msg_epoch, f"{op} at higher epoch")

    # ------------------------------------------------------ server side

    def handle(self, op: str, msg: dict) -> dict:
        """Server half of the replication protocol — dispatched by
        `LedgerServer._dispatch_op` for `repl.*` and `promote` frames."""
        if op == "promote":
            epoch = self.promote()
            return {"ok": True, "role": self.role, "epoch": epoch,
                    "height": self.network.height()}
        if op == "repl.state":
            with self._lock:
                return {"ok": True, "role": self.role, "epoch": self.epoch,
                        "height": self.network.height()}
        if op == "repl.bootstrap":
            self._fence(int(msg.get("epoch", 0)), op)
            height = self.network.install_snapshot(
                bytes.fromhex(msg["snapshot"])
            )
            with self._lock:
                self.leader_height = max(self.leader_height, height)
                self.last_heartbeat = time.monotonic()
            return {"ok": True, "height": height}
        if op == "repl.ship":
            self._fence(int(msg.get("epoch", 0)), op)
            height = self.network.apply_delta(bytes.fromhex(msg["record"]))
            with self._lock:
                self.leader_height = max(self.leader_height, height)
                self.last_heartbeat = time.monotonic()
            return {"ok": True, "height": height}
        if op == "repl.heartbeat":
            self._fence(int(msg.get("epoch", 0)), op)
            with self._lock:
                self.last_heartbeat = time.monotonic()
                self.leader_height = int(msg.get("height", 0))
            return {"ok": True, "height": self.network.height()}
        raise ReplicationError(f"unknown replication op [{op}]")

    # ------------------------------------------------------ leader side

    def on_commit(self, height: int, record: bytes) -> None:
        """Commit-path hook (`_commit_block_inner`, right after the WAL
        append): hand the journaled record to the shipper. Bounded and
        degrade-only by construction — see `Shipper.ship`."""
        if self.shipper is not None and self.role == "leader":
            self.shipper.ship(height, record)

    # ------------------------------------------------------ lease watchdog

    def start_watchdog(self) -> None:
        """Auto-promotion: a follower that hears no leader heartbeat for
        a full lease promotes itself (`attach_follower(auto_promote=True)`)."""
        if self._watchdog is not None:
            return
        self._watchdog = threading.Thread(
            target=self._watch, name="fts-repl-watchdog", daemon=True
        )
        self._watchdog.start()

    def _watch(self) -> None:
        profiler.set_thread_role("repl-watchdog")
        poll = max(0.05, min(self.lease_s / 4.0, 0.5))
        while not self._stop.wait(poll):
            with self._lock:
                if self.role != "follower":
                    return
                age = time.monotonic() - self.last_heartbeat
            if age >= self.lease_s:
                self.promote(reason=f"lease expired ({age:.2f}s silent)")
                return

    def close(self) -> None:
        self._stop.set()
        if self.shipper is not None:
            self.shipper.stop()
        if self._watchdog is not None and self._watchdog.is_alive():
            self._watchdog.join(timeout=2.0)


# ------------------------------------------------------------ shipper


class _LinkStopped(Exception):
    """Internal: the link terminated cleanly (NodeStopped / fenced)."""


class _NeedBootstrap(Exception):
    """Internal: the follower reported a journal gap — re-sync via a
    full snapshot instead of retrying the same doomed delta."""


class _FollowerLink:
    """One follower: a daemon thread owning the socket, a bounded ship
    queue, and an ack watermark. All failure handling lives HERE, off
    the commit path: reconnect backoff is gated by a per-link circuit
    breaker, a typed `NodeStopped` answer ends the link cleanly (a
    stopping node is a demotion, not a retry storm), and a `StaleEpoch`
    answer fences the WHOLE leader (it demotes itself)."""

    def __init__(self, state: ReplicaState, address: Tuple[str, int],
                 ship_timeout_s: float, queue_max: int, heartbeat_s: float):
        self.state = state
        self.address = (str(address[0]), int(address[1]))
        self.ship_timeout_s = ship_timeout_s
        self.heartbeat_s = heartbeat_s
        self.follower_height: Optional[int] = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, queue_max))
        # guards link_state AND follower_height: the commit path reads
        # both (ship's wait loop) while the link thread mutates them, so
        # every transition notifies waiters through this one condition
        self._ack = threading.Condition()
        self.link_state = "connecting"
        self._stop = threading.Event()
        self._dropping = False  # throttles the drop flight event
        self._breaker = resilience.CircuitBreaker(
            f"repl.{self.address[0]}:{self.address[1]}"
        )
        self._thread = threading.Thread(
            target=self._run, name=f"fts-repl-{self.address[1]}", daemon=True
        )

    # ---------------------------------------------- commit-path interface

    def enqueue(self, height: int, record: bytes) -> bool:
        """Non-blocking: a full queue (slow follower) DROPS the record
        loudly — the next reconnect re-syncs from the journal, so a drop
        costs catch-up work, never correctness."""
        with self._ack:
            if self.link_state in ("stopped", "fenced"):
                return False
        try:
            self._queue.put_nowait((height, record))
            return True
        except queue.Full:
            mx.counter("repl.ship.dropped").inc()
            if not self._dropping:
                self._dropping = True
                mx.flight("repl.ship.drop", addr=self._addr_str(),
                          height=height)
            return False

    def wait_acked(self, height: int, deadline: float) -> str:
        """Bounded wait for the follower's ack watermark to reach
        `height` — the follower's POST-apply height, i.e. `block index
        + 1` for the record just shipped. Returns `"acked"`,
        `"timeout"` (deadline expired on a streaming link — the caller
        counts it and moves on, degrade-only), or `"unsynced"` (the
        link is not streaming — connecting, syncing, breaker-open,
        stopped, or fenced — so this record rides the journal re-sync
        instead of the queue; counted by the caller so degraded
        shipping is always visible)."""
        with self._ack:
            while True:
                acked = (
                    -1 if self.follower_height is None
                    else self.follower_height
                )
                if acked >= height:
                    return "acked"
                if self.link_state != "streaming":
                    return "unsynced"
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return "timeout"
                self._ack.wait(timeout=min(remaining, 0.05))

    def _addr_str(self) -> str:
        return f"{self.address[0]}:{self.address[1]}"

    def _set_follower_height(self, height: int) -> None:
        with self._ack:
            self.follower_height = height
            self._ack.notify_all()

    def _set_link_state(self, state: str) -> None:
        with self._ack:
            self.link_state = state
            self._ack.notify_all()

    # ---------------------------------------------- link thread

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._ack:
            self._ack.notify_all()
        try:  # unblock a queue.get in progress
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        profiler.set_thread_role("repl-shipper")
        backoff = 0.05
        while not self._stop.is_set():
            if not self._breaker.allow():
                self._set_link_state("breaker_open")
                self._stop.wait(0.2)
                continue
            sock = None
            try:
                self._set_link_state("connecting")
                sock = socket.create_connection(
                    self.address, timeout=self.ship_timeout_s
                )
                sock.settimeout(self.ship_timeout_s)
                self._catch_up(sock)
                self._breaker.record_success()
                backoff = 0.05
                self._set_link_state("streaming")
                self._dropping = False
                self._stream(sock)
            except _LinkStopped:
                return
            except _NeedBootstrap:
                continue  # reconnect immediately; catch-up will snapshot
            except Exception as e:
                self._breaker.record_failure()
                mx.counter("repl.link.errors").inc()
                self._set_link_state("reconnecting")
                logger.warning(
                    "repl: link to %s failed (%s: %s); reconnecting",
                    self._addr_str(), type(e).__name__, e,
                )
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 2.0)
            finally:
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass

    def _rpc(self, sock: socket.socket, msg: dict) -> dict:
        from .remote import RemoteError, _recv_msg, _send_msg

        _send_msg(sock, msg)
        resp = _recv_msg(sock)
        if resp is None:
            raise ConnectionError(
                f"follower {self._addr_str()} closed the connection"
            )
        if resp.get("ok"):
            return resp
        klass = resp.get("error_class")
        if klass == "NodeStopped":
            # the follower is shutting down on purpose: log the clean
            # demotion and end the link — no retry storm against a
            # stopping node
            mx.counter("repl.link.node_stopped").inc()
            mx.flight("repl.link.stopped", addr=self._addr_str())
            logger.info(
                "repl: follower %s is stopping; link demoted cleanly",
                self._addr_str(),
            )
            self._set_link_state("stopped")
            raise _LinkStopped()
        if klass == "StaleEpoch":
            # WE are the zombie: a promoted node fenced us off. Demote
            # the whole leader to the fencer's ACTUAL epoch (it rides
            # the typed answer) — never a guessed `epoch + 1`, which a
            # later re-promotion could land EQUAL to the real leader's
            # epoch (and equal-epoch leaders would merge each other's
            # frames). `epoch + 1` survives only as the fallback for a
            # peer that omits the field.
            self._set_link_state("fenced")
            fencer_epoch = int(resp.get("epoch") or 0)
            self.state.demote(
                fencer_epoch if fencer_epoch else self.state.epoch + 1,
                "fenced by follower",
            )
            logger.warning(
                "repl: follower %s fenced this leader off (%s)",
                self._addr_str(), resp.get("error"),
            )
            raise _LinkStopped()
        if klass == "WALError":
            raise _NeedBootstrap()
        raise RemoteError(resp.get("error", "replication error"),
                          error_class=klass)

    def _catch_up(self, sock: socket.socket) -> None:
        """Bring the follower to the leader's journal frontier: drain the
        (stale) queue, snapshot-bootstrap if the journal no longer covers
        the follower's height, then stream the journal suffix. Records
        committed DURING catch-up are both in the journal scan and the
        queue — the follower skips re-applies by height, so the overlap
        is idempotent, and a gap is impossible."""
        from ...crypto.serialization import loads

        self._set_link_state("syncing")
        st = self._rpc(sock, {"op": "repl.state"})
        if int(st.get("epoch", 0)) > self.state.epoch:
            self._set_link_state("fenced")
            self.state.demote(int(st["epoch"]), "follower at higher epoch")
            raise _LinkStopped()
        follower_h = int(st.get("height", 0))
        self._set_follower_height(follower_h)
        while True:  # drop whatever queued while the link was down
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        wal = getattr(self.state.network, "_wal", None)
        first = next(wal.replay_iter(), None) if wal is not None else None
        journal_base = loads(first[1])["height"] if first else None
        if follower_h < self.state.network.height() and (
            journal_base is None or journal_base > follower_h
        ):
            snap = self.state.network.snapshot()
            resp = self._rpc(sock, {
                "op": "repl.bootstrap", "snapshot": snap.hex(),
                "epoch": self.state.epoch,
            })
            self._set_follower_height(int(resp["height"]))
            mx.counter("repl.bootstraps.sent").inc()
        if wal is not None:
            for _off, payload in wal.replay_iter():
                if self._stop.is_set():
                    return
                resp = self._rpc(sock, {
                    "op": "repl.ship", "record": payload.hex(),
                    "epoch": self.state.epoch,
                })
                self._set_follower_height(int(resp["height"]))

    def _stream(self, sock: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=self.heartbeat_s)
            except queue.Empty:
                self._heartbeat(sock)
                continue
            if item is None:
                return  # stop sentinel
            _height, record = item
            faults.fire("repl.ship")
            resp = self._rpc(sock, {
                "op": "repl.ship", "record": record.hex(),
                "epoch": self.state.epoch,
            })
            self._set_follower_height(int(resp["height"]))
            mx.counter("repl.shipped.records").inc()

    def _heartbeat(self, sock: socket.socket) -> None:
        faults.fire("repl.heartbeat")
        resp = self._rpc(sock, {
            "op": "repl.heartbeat", "epoch": self.state.epoch,
            "height": self.state.network.height(),
        })
        self._set_follower_height(int(resp["height"]))
        mx.counter("repl.heartbeats").inc()


class Shipper:
    """Leader-side fan-out of journaled WAL records to follower links."""

    def __init__(self, state: ReplicaState,
                 followers: List[Tuple[str, int]],
                 ship_timeout_s: float = DEFAULT_SHIP_TIMEOUT_S,
                 queue_max: int = DEFAULT_QUEUE_MAX,
                 heartbeat_s: float = DEFAULT_HEARTBEAT_S):
        self.state = state
        self.ship_timeout_s = ship_timeout_s
        self._links = [
            _FollowerLink(state, addr, ship_timeout_s, queue_max, heartbeat_s)
            for addr in followers
        ]

    def start(self) -> None:
        for link in self._links:
            link.start()

    def stop(self) -> None:
        for link in self._links:
            link.stop()

    def ship(self, height: int, record: bytes) -> None:
        """Commit-path entry: enqueue to every live link, then wait —
        bounded by `ship_timeout_s` — for the streaming links to ack.
        A healthy loopback follower acks in well under a millisecond, so
        an acknowledged tx is replicated before its submitter resolves;
        a sick one times out, is counted, and the commit proceeds.

        `height` is the record's block INDEX (the leader ships before
        its own merge), so the ack target is `height + 1` — the
        follower's post-apply height. Waiting for `height` itself would
        be satisfied by a follower merely caught up through the
        PREVIOUS record, i.e. every commit would only confirm its
        predecessor's replication. Links that are not streaming
        (connecting/syncing/breaker-open/stopped/fenced — including one
        that flips mid-wait) are counted `repl.ship.unsynced`, never
        waited on: their records ride the journal re-sync, and degraded
        shipping stays visible."""
        t0 = time.monotonic()
        for link in self._links:
            link.enqueue(height, record)
        deadline = t0 + self.ship_timeout_s
        target = height + 1
        for link in self._links:
            verdict = link.wait_acked(target, deadline)
            if verdict == "timeout":
                mx.counter("repl.ship.ack_timeouts").inc()
            elif verdict == "unsynced":
                mx.counter("repl.ship.unsynced").inc()
        mx.histogram("repl.ship.wait.seconds").observe(
            time.monotonic() - t0
        )

    def link_states(self) -> List[dict]:
        leader_h = self.state.network.height()
        rows = []
        for link in self._links:
            with link._ack:  # consistent (state, height) snapshot
                fh = link.follower_height
                state = link.link_state
            rows.append({
                "addr": link._addr_str(),
                "state": state,
                "height": fh,
                "lag": (leader_h - fh) if fh is not None else None,
            })
        return rows


# ------------------------------------------------------------ attachment


def _epoch_path(network, explicit: Optional[str]) -> Optional[str]:
    if explicit:
        return explicit
    wal = getattr(network, "_wal", None)
    return (wal.path + ".epoch") if wal is not None else None


def attach_leader(network, followers: List[Tuple[str, int]],
                  epoch_path: Optional[str] = None,
                  **shipper_opts) -> Optional[ReplicaState]:
    """Make a journaled `Network` the replication leader for `followers`
    (a list of `(host, port)` follower `LedgerServer` addresses);
    `shipper_opts` are `Shipper`'s `ship_timeout_s`, `queue_max` and
    `heartbeat_s`. Returns None, leaving the commit path byte-identical
    to a standalone node, when the follower list is empty."""
    if not followers:
        return None
    if getattr(network, "_wal", None) is None:
        raise ReplicationError(
            "replication leader needs a journaled network (wal_path=...)"
        )
    state = ReplicaState(network, "leader",
                         epoch_path=_epoch_path(network, epoch_path))
    state.shipper = Shipper(state, followers, **shipper_opts)
    network.repl = state
    state.shipper.start()
    logger.info(
        "repl: leader at epoch %d shipping to %d follower(s)",
        state.epoch, len(followers),
    )
    return state


def attach_follower(network, epoch_path: Optional[str] = None,
                    auto_promote: bool = False,
                    lease_s: float = DEFAULT_LEASE_S) -> ReplicaState:
    """Make a `Network` a replication follower: it answers `repl.*`
    frames, rejects submits with `NotLeader`, and (with
    `auto_promote=True`) promotes itself after `lease_s` seconds of
    heartbeat silence."""
    resolved = _epoch_path(network, epoch_path)
    if resolved is None:
        # same refusal as attach_leader: without a durable epoch file a
        # restarted follower comes back at epoch 0, so fencing would not
        # survive exactly the crash it exists for
        raise ReplicationError(
            "replication follower needs a journaled network (wal_path=...)"
            " or an explicit epoch_path: the fencing epoch must survive a"
            " restart"
        )
    state = ReplicaState(network, "follower", epoch_path=resolved, lease_s=lease_s)
    network.repl = state
    if auto_promote:
        state.start_watchdog()
    logger.info("repl: follower at epoch %d height %d", state.epoch,
                network.height())
    return state
