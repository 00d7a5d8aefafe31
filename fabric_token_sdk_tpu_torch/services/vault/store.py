"""Pluggable token-store backends for the vault (the client state plane).

Counterpart of `fabric_token_sdk_tpu/services/vault/store.py`, by copy:
the journal records and snapshots are the same bytes (the port's
`WriteAheadLog` framing and `serialization.dumps`), so a vault journal
written by either package recovers in the other. The environment knob
`FTS_VAULT_SNAPSHOT_EVERY` is not ported: `snapshot_every` is an
argument of `PersistentTokenStore` (256 by default, and for a recovered
store), and the journal always fsyncs (the reference's `sync` option is
not ported).

Reference: `token/services/vault/*` — the Go SDK keeps owned tokens in a
DB-backed token store behind a query engine; here the same split lives as
a small SPI (`TokenStore`) with two implementations:

* `InMemoryTokenStore` — the historical behavior (everything in dicts),
  now with a selection index: tokens are bucketed by
  ``(token_type, owner)`` and each bucket keeps its candidates
  quantity-DESCENDING, so `Selector.select` walks only the tokens of the
  requested type (largest first — fewest locks to reach an amount)
  instead of scanning the whole vault per retry.
* `PersistentTokenStore` — the crash-safe backend: every applied
  `VaultDelta` (one acknowledged finality event: spent-deletes +
  stored-outputs + certifications) is appended to the same CRC-framed
  fsync'd journal the ledger uses (`services/network/wal.py`) BEFORE it
  mutates the in-memory view, with atomic snapshot compaction
  (tmp+rename+fsync, directory fsync'd before the journal truncate) every
  `snapshot_every` events. `PersistentTokenStore.recover` =
  snapshot + journal replay with torn-tail truncation — a client process
  SIGKILLed mid-workload restarts with exactly the acknowledged state.

Recovery invariants (vs the ledger WAL, whose records are height-chained):
vault deltas are IDEMPOTENT — stores set unique keys, spends delete keys
— and the journal is only ever truncated as a whole after a snapshot is
durably on disk, so the crash-between-snapshot-and-truncate window
replays the complete since-last-reset history on top of the snapshot and
converges to the same state (no heights needed). Causality is preserved
without a global append+apply lock because an event spending a token can
only be constructed AFTER the event storing it was fully applied (and
therefore journaled) — journal order can never spend-before-store.

A FAILED journal append degrades LOUDLY, never corruptingly: the counter
`vault.append_failures` + a `vault.append_failed` flight event fire, the
in-memory view still applies (this process keeps working), only the
durability promise is degraded until the journal heals.
"""

from __future__ import annotations

import heapq
import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from ...models.token import ID, UnspentToken
from ...utils import faults
from ...utils import metrics as mx
from ...utils.tracing import logger
from ..network.wal import WriteAheadLog, fsync_dir


@dataclass
class StoredToken:
    id: ID
    output: bytes
    metadata: Optional[bytes]
    decoded: Optional[UnspentToken] = None  # cached opening (immutable)


@dataclass
class VaultDelta:
    """The vault-state change of ONE acknowledged finality event — the
    unit of atomicity (and, in the persistent store, of journaling)."""

    tx_id: str = ""
    spends: List[str] = field(default_factory=list)  # token keys deleted
    stores: List[StoredToken] = field(default_factory=list)
    certs: List[Tuple[str, bytes]] = field(default_factory=list)


class _Bucket:
    """Quantity-descending candidate set of one (type, owner) bucket.

    Mutation-cheap and iteration-lazy: `add` appends to a pending list,
    `discard` only counts a tombstone, and `merged()` (called under the
    store lock at selection time) folds pending entries into the sorted
    list — building a NEW list whenever it changes, so an iterator handed
    out earlier keeps walking its own consistent snapshot. Two
    compaction mechanisms keep selection cost bounded under sustained
    select+spend load: the DEAD PREFIX is trimmed on every `merged()`
    (selection picks largest-first, so spent tokens pile up exactly at
    the front — each trimmed entry is examined once, amortized O(1) per
    spend), and a full rebuild fires once mid-list tombstones outnumber
    the live entries. A million appends cost one O(n log n) sort at the
    next selection, not a million O(n) insorts.
    """

    __slots__ = ("_sorted", "_pending", "_live", "_stale")

    def __init__(self):
        self._sorted: List[Tuple[int, str]] = []  # (-quantity, key)
        self._pending: List[Tuple[int, str]] = []
        self._live: Dict[str, int] = {}  # key -> quantity (the truth)
        self._stale = 0

    def add(self, key: str, quantity: int) -> None:
        self._live[key] = quantity
        self._pending.append((-quantity, key))

    def discard(self, key: str) -> None:
        if self._live.pop(key, None) is not None:
            self._stale += 1

    def __len__(self) -> int:
        return len(self._live)

    def merged(self) -> List[Tuple[int, str]]:
        """The sorted candidate list (may contain tombstones — callers
        re-check liveness per key). Call under the owning store's lock."""
        live = self._live
        if self._pending or self._stale > len(live):
            self._sorted = sorted(
                e for e in self._sorted + self._pending if e[1] in live
            )
            self._pending = []
            self._stale = 0
        elif self._stale:
            # trim the dead PREFIX (a new list: snapshots stay immutable)
            lst = self._sorted
            i = 0
            while i < len(lst) and lst[i][1] not in live:
                i += 1
            if i:
                self._sorted = lst[i:]
                self._stale -= i
        return self._sorted


class TokenStore:
    """SPI of the vault's storage plane. Implementations must make
    `apply` atomic with respect to every reader."""

    def apply(self, delta: VaultDelta) -> Dict[str, int]:
        """Apply one finality event's delta; returns counts
        (`spent`/`stored`/`certs_dropped`) for the vault's metrics."""
        raise NotImplementedError

    def get(self, key: str) -> Optional[StoredToken]:
        raise NotImplementedError

    def tokens(self) -> List[StoredToken]:
        """Every stored token, insertion-ordered (API-compat with the
        pre-SPI vault, which several suites rely on)."""
        raise NotImplementedError

    def candidates(self, token_type: str,
                   owner: Optional[bytes] = None) -> Iterator[Tuple[int, str]]:
        """(quantity, key) pairs of one type (optionally one owner),
        quantity-descending. Entries may be stale — re-check via
        `get`."""
        raise NotImplementedError

    def certification(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryTokenStore(TokenStore):
    def __init__(self):
        self._lock = threading.Lock()
        self._tokens: Dict[str, StoredToken] = {}  # insertion-ordered
        self._certs: Dict[str, bytes] = {}
        # token_type -> owner bytes -> quantity-ordered bucket
        self._index: Dict[str, Dict[bytes, _Bucket]] = {}

    # ------------------------------------------------------------ writes

    def apply(self, delta: VaultDelta) -> Dict[str, int]:
        with self._lock:
            return self._apply_locked(delta)

    def _apply_locked(self, delta: VaultDelta) -> Dict[str, int]:
        spent = certs_dropped = stored = 0
        for key in delta.spends:
            st = self._tokens.pop(key, None)
            if st is None:
                continue
            spent += 1
            self._unindex(st)
            # certifications die with their token — an unbounded cert map
            # for spent tokens is a leak, not a feature
            if self._certs.pop(key, None) is not None:
                certs_dropped += 1
        for st in delta.stores:
            self._tokens[st.id.key()] = st
            self._index_add(st)
            stored += 1
        for key, cert in delta.certs:
            self._certs[key] = cert
        return {"spent": spent, "stored": stored, "certs_dropped": certs_dropped}

    def _index_add(self, st: StoredToken) -> None:
        ut = st.decoded
        if ut is None:
            return  # unopenable tokens are held but never selectable
        bucket = self._index.setdefault(ut.type, {}).setdefault(
            ut.owner.raw, _Bucket()
        )
        bucket.add(st.id.key(), int(ut.quantity))

    def _unindex(self, st: StoredToken) -> None:
        ut = st.decoded
        if ut is None:
            return
        owners = self._index.get(ut.type)
        if owners is not None:
            bucket = owners.get(ut.owner.raw)
            if bucket is not None:
                bucket.discard(st.id.key())

    # ------------------------------------------------------------ reads

    def get(self, key: str) -> Optional[StoredToken]:
        with self._lock:
            return self._tokens.get(key)

    def tokens(self) -> List[StoredToken]:
        with self._lock:
            return list(self._tokens.values())

    def candidates(self, token_type: str,
                   owner: Optional[bytes] = None) -> Iterator[Tuple[int, str]]:
        with self._lock:
            owners = self._index.get(token_type)
            if not owners:
                return iter(())
            if owner is not None:
                bucket = owners.get(owner)
                lists = [bucket.merged()] if bucket is not None else []
            else:
                lists = [b.merged() for b in owners.values()]
        if not lists:
            return iter(())
        # merged() snapshots are never mutated in place, so iterating
        # them outside the lock is safe; stale keys filter at the caller
        it = iter(lists[0]) if len(lists) == 1 else heapq.merge(*lists)
        return ((-neg_q, key) for neg_q, key in it)

    def certification(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._certs.get(key)

    def cert_count(self) -> int:
        with self._lock:
            return len(self._certs)

    def __len__(self) -> int:
        with self._lock:
            return len(self._tokens)


def decoded_token(decode: Callable[[ID, bytes, Optional[bytes]], UnspentToken],
                  token_id: ID, output: bytes,
                  metadata: Optional[bytes]) -> StoredToken:
    """Build a StoredToken, tolerating (and counting) opening failures —
    a token whose metadata rotted is held raw, flagged, never selectable."""
    try:
        decoded = decode(token_id, output, metadata)
    except Exception as e:
        logger.warning("vault: cannot open token %s: %s", token_id, e)
        mx.counter("vault.tokens.open_failures").inc()
        decoded = None
    return StoredToken(token_id, output, metadata, decoded)


class PersistentTokenStore(InMemoryTokenStore):
    """Crash-safe vault backend: journal-then-apply per finality event,
    atomic snapshot compaction, recovery = snapshot + delta replay.

    Constructing on an EXISTING journal path keeps appending after
    whatever is already there — rebuild state first via
    `PersistentTokenStore.recover(...)` (or `Vault.recover`), exactly
    like `Network.recover` vs `Network(wal_path=...)`.
    """

    def __init__(self, path: str, snapshot_every: int = 256):
        super().__init__()
        self.path = str(path)
        self.snapshot_path = self.path + ".snap"
        self.snapshot_every = snapshot_every
        self._wal = WriteAheadLog(self.path)
        # serializes journal+apply against compaction, so a snapshot can
        # never miss an event whose journal record it is about to erase;
        # readers only ever contend on the (brief) in-memory lock
        self._io_lock = threading.Lock()
        self._events = 0

    # ------------------------------------------------------------ writes

    def apply(self, delta: VaultDelta) -> Dict[str, int]:
        record = self._record(delta)
        with self._io_lock:
            try:
                faults.fire("vault.append")
                self._wal.append(record)
                mx.counter("vault.appends").inc()
            except Exception:
                # durability degraded, view intact: LOUD, not corrupting
                mx.counter("vault.append_failures").inc()
                mx.flight("vault.append_failed", tx=delta.tx_id)
                logger.exception(
                    "vault: journal append failed for %r (in-memory view "
                    "unaffected; durability degraded until the journal "
                    "heals)", delta.tx_id,
                )
            with self._lock:
                stats = self._apply_locked(delta)
            self._events += 1
            due = (
                self.snapshot_every > 0
                and self._events % self.snapshot_every == 0
            )
        if due:
            try:
                self.compact()
            except Exception:
                # the event is already durable in the journal; a failed
                # compaction only means the journal keeps growing
                mx.counter("vault.snapshot_failures").inc()
                logger.exception(
                    "vault: snapshot compaction failed; journal keeps growing"
                )
        return stats

    def compact(self) -> None:
        """Write a full snapshot (atomic tmp+rename+fsync, dir fsync'd
        BEFORE the journal truncate — power loss can never persist the
        truncate but lose the rename), then reset the journal."""
        with self._io_lock:
            faults.fire("vault.snapshot")
            raw = self._snapshot_bytes()
            tmp = f"{self.snapshot_path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as fh:
                fh.write(raw)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.snapshot_path)
            fsync_dir(self.snapshot_path)
            self._wal.reset()
        mx.counter("vault.snapshots").inc()

    def close(self) -> None:
        self._wal.close()

    # ------------------------------------------------------------ format

    @staticmethod
    def _rows(stored: List[StoredToken]) -> list:
        return [[st.id.tx_id, st.id.index, st.output, st.metadata]
                for st in stored]

    def _record(self, delta: VaultDelta) -> bytes:
        from ...crypto.serialization import dumps

        return dumps({
            "tx": delta.tx_id,
            "spends": list(delta.spends),
            "stores": self._rows(delta.stores),
            "certs": [[k, c] for k, c in delta.certs],
        })

    def _snapshot_bytes(self) -> bytes:
        from ...crypto.serialization import dumps

        with self._lock:
            return dumps({
                "tokens": self._rows(list(self._tokens.values())),
                "certs": [[k, c] for k, c in self._certs.items()],
            })

    # ------------------------------------------------------------ recover

    @classmethod
    def recover(cls, path: str,
                decode: Callable[[ID, bytes, Optional[bytes]], UnspentToken]
                ) -> "PersistentTokenStore":
        """Rebuild a crashed client's store: latest snapshot (if any)
        plus a replay of the journal suffix (torn tail truncated by
        `WriteAheadLog.replay`), then keep journaling to the same files.
        `decode` re-opens each token (driver-backed in `Vault.recover`);
        opening failures are tolerated per token, never fatal."""
        faults.fire("vault.recover")
        from ...crypto.serialization import loads

        store = cls(path)
        if os.path.exists(store.snapshot_path):
            with open(store.snapshot_path, "rb") as fh:
                d = loads(fh.read())
            snap = VaultDelta(
                stores=[
                    decoded_token(decode, ID(t, i), o, m)
                    for t, i, o, m in d["tokens"]
                ],
                certs=[(k, c) for k, c in d["certs"]],
            )
            with store._lock:
                store._apply_locked(snap)
        replayed = 0
        for raw in store._wal.replay():
            d = loads(raw)
            delta = VaultDelta(
                tx_id=d["tx"],
                spends=list(d["spends"]),
                stores=[
                    decoded_token(decode, ID(t, i), o, m)
                    for t, i, o, m in d["stores"]
                ],
                certs=[(k, c) for k, c in d["certs"]],
            )
            with store._lock:
                store._apply_locked(delta)
            replayed += 1
        mx.counter("vault.recoveries").inc()
        mx.counter("vault.replayed.events").inc(replayed)
        mx.flight("vault.recover", tokens=len(store), replayed=replayed)
        logger.info(
            "vault: recovered %d tokens (%d journal events replayed) from %s",
            len(store), replayed, path,
        )
        return store
