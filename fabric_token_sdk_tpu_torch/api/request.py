"""TokenRequest: the unit a transaction carries to the ledger.

Reference: `token/request.go` — a request aggregates issue/transfer
actions, collects owner/issuer/auditor signatures, and carries per-output
metadata off-chain (`token/metadata.go`).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..crypto.serialization import dumps, loads
from ..models.token import ID
from ..utils import metrics as mx
from ..utils import profiler


@dataclass
class IssueRecord:
    action: bytes
    issuer: bytes
    outputs_metadata: List[bytes] = field(default_factory=list)
    receivers: List[bytes] = field(default_factory=list)
    signature: bytes = b""


@dataclass
class TransferRecord:
    action: bytes
    input_ids: List[ID] = field(default_factory=list)
    senders: List[bytes] = field(default_factory=list)
    outputs_metadata: List[bytes] = field(default_factory=list)
    receivers: List[bytes] = field(default_factory=list)
    signatures: List[bytes] = field(default_factory=list)


@dataclass
class RequestMetadata:
    """Off-chain opening metadata + application metadata."""

    application: Dict[str, bytes] = field(default_factory=dict)


@dataclass
class TokenRequest:
    anchor: str  # tx id this request is bound to
    issues: List[IssueRecord] = field(default_factory=list)
    transfers: List[TransferRecord] = field(default_factory=list)
    auditor_signature: bytes = b""
    metadata: RequestMetadata = field(default_factory=RequestMetadata)

    # Private memo fields (never dataclass fields): `_wire_raw` is the
    # exact bytes this instance was parsed from, `_sign_memo`/`_audit_memo`
    # the marshal outputs keyed by `_memo_key`. Reassigning any PUBLIC
    # field drops all three (see `__setattr__`); nested record-level
    # mutation of a parsed request is not a supported pattern — parsed
    # requests are read-only below the top-level fields.

    def __setattr__(self, name, value):
        if not name.startswith("_"):
            d = self.__dict__
            d.pop("_wire_raw", None)
            d.pop("_sign_memo", None)
            d.pop("_audit_memo", None)
        object.__setattr__(self, name, value)

    def _memo_key(self) -> tuple:
        # actions are append-only in every assembly flow (api/tms.py), so
        # the record counts + anchor pin the marshal memos; signatures and
        # receivers mutate freely without touching the signed byte string
        return (self.anchor, len(self.issues), len(self.transfers))

    def _clone(self) -> "TokenRequest":
        """Structural copy: fresh records and fresh lists, immutable
        leaves (bytes, IDs) shared. Cache hits hand these out so the
        cached canonical never escapes to mutating callers."""
        c = TokenRequest(anchor=self.anchor)
        c.issues = [
            IssueRecord(
                action=r.action, issuer=r.issuer,
                outputs_metadata=list(r.outputs_metadata),
                receivers=list(r.receivers), signature=r.signature,
            )
            for r in self.issues
        ]
        c.transfers = [
            TransferRecord(
                action=r.action, input_ids=list(r.input_ids),
                senders=list(r.senders),
                outputs_metadata=list(r.outputs_metadata),
                receivers=list(r.receivers), signatures=list(r.signatures),
            )
            for r in self.transfers
        ]
        c.auditor_signature = self.auditor_signature
        c.metadata.application = dict(self.metadata.application)
        raw = self.__dict__.get("_wire_raw")
        if raw is not None:
            object.__setattr__(c, "_wire_raw", raw)
        return c

    # ------------------------------------------------------------ marshal

    def _actions_dict(self) -> dict:
        return {
            "anchor": self.anchor,
            "issues": [
                {"a": r.action, "i": r.issuer} for r in self.issues
            ],
            "transfers": [
                {
                    "a": r.action,
                    "ids": [[i.tx_id, i.index] for i in r.input_ids],
                    "s": r.senders,
                }
                for r in self.transfers
            ],
        }

    def marshal_to_sign(self) -> bytes:
        """Byte string signed by owners/issuers (reference request.go:655).

        Memoized per instance: block validation marshals the same request
        once in the sign-obligation collector and once per validate, and
        the actions dict is append-only — the memo key catches appends,
        `__setattr__` catches field replacement.
        """
        with profiler.leg("unmarshal"):
            key = self._memo_key()
            memo = self.__dict__.get("_sign_memo")
            if memo is not None and memo[0] == key:
                return memo[1]
            raw = dumps(self._actions_dict())
            object.__setattr__(self, "_sign_memo", (key, raw))
            return raw

    def marshal_to_audit(self) -> bytes:
        """Byte string signed by the auditor (reference request.go:643):
        actions + metadata binding. Memoized like `marshal_to_sign`."""
        with profiler.leg("unmarshal"):
            key = self._memo_key()
            memo = self.__dict__.get("_audit_memo")
            if memo is not None and memo[0] == key:
                return memo[1]
            d = self._actions_dict()
            d["meta"] = {
                "issues": [r.outputs_metadata for r in self.issues],
                "transfers": [r.outputs_metadata for r in self.transfers],
            }
            raw = dumps(d)
            object.__setattr__(self, "_audit_memo", (key, raw))
            return raw

    def to_bytes(self) -> bytes:
        return dumps(
            {
                "anchor": self.anchor,
                "issues": [
                    {
                        "a": r.action,
                        "i": r.issuer,
                        "m": r.outputs_metadata,
                        "r": r.receivers,
                        "sig": r.signature,
                    }
                    for r in self.issues
                ],
                "transfers": [
                    {
                        "a": r.action,
                        "ids": [[i.tx_id, i.index] for i in r.input_ids],
                        "s": r.senders,
                        "m": r.outputs_metadata,
                        "r": r.receivers,
                        "sigs": r.signatures,
                    }
                    for r in self.transfers
                ],
                "asig": self.auditor_signature,
                "app": self.metadata.application,
            }
        )

    def wire_bytes(self) -> bytes:
        """The request's wire encoding for durable storage: the exact
        bytes it was parsed from when no field has been reassigned since
        (skipping a full re-serialization on the WAL path), else a fresh
        `to_bytes()`. Replay decodes both forms identically."""
        raw = self.__dict__.get("_wire_raw")
        return raw if raw is not None else self.to_bytes()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "TokenRequest":
        with profiler.leg("unmarshal"):
            req = _CACHE.lookup(raw)
            if req is not None:
                return req
            req = cls._from_bytes_inner(raw)
            object.__setattr__(req, "_wire_raw", raw)
            _CACHE.store(raw, req._clone())
            return req

    @classmethod
    def _from_bytes_inner(cls, raw: bytes) -> "TokenRequest":
        d = loads(raw)
        req = cls(anchor=d["anchor"])
        for r in d["issues"]:
            req.issues.append(
                IssueRecord(
                    action=r["a"], issuer=r["i"], outputs_metadata=r["m"],
                    receivers=r["r"], signature=r["sig"],
                )
            )
        for r in d["transfers"]:
            req.transfers.append(
                TransferRecord(
                    action=r["a"],
                    input_ids=[ID(t, i) for t, i in r["ids"]],
                    senders=r["s"],
                    outputs_metadata=r["m"],
                    receivers=r["r"],
                    signatures=r["sigs"],
                )
            )
        req.auditor_signature = d["asig"]
        req.metadata.application = d["app"]
        return req

    # ------------------------------------------------------------ helpers

    def set_application_metadata(self, k: str, v: bytes) -> None:
        self.metadata.application[k] = v

    def application_metadata(self, k: str) -> Optional[bytes]:
        return self.metadata.application.get(k)


# ------------------------------------------------------------ parse cache


class _RequestCache:
    """Bounded LRU: raw request bytes -> parsed canonical `TokenRequest`,
    mirroring `drivers.identity._IdentityCache` — re-validated and
    resubmitted requests skip unmarshal entirely.

    The canonical entry never escapes: hits (and the miss that populates
    an entry) hand out `_clone()` copies, so a caller mutating its parse
    can never corrupt later lookups. Parse failures are never cached.
    Cache-pressure evictions are counted and surfaced on the flight
    recorder (throttled: the first eviction and every `_FLIGHT_EVERY`-th
    after it, so a thrashing cache cannot flood the ring)."""

    _FLIGHT_EVERY = 512

    def __init__(self, capacity: Optional[int] = None):
        # an explicit capacity is fixed; otherwise FTS_REQUEST_CACHE is
        # resolved lazily on FIRST USE (not at import) and re-resolved
        # after clear(), so tests/operators configuring the env after
        # the SDK imported still take effect
        self._from_env = capacity is None
        self._capacity = max(0, capacity) if capacity is not None else None
        self._entries: "OrderedDict[bytes, TokenRequest]" = OrderedDict()
        self._evictions = 0
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        if self._capacity is None:
            try:
                self._capacity = max(
                    0, int(os.environ.get("FTS_REQUEST_CACHE", "4096"))
                )
            except ValueError:
                self._capacity = 4096
        return self._capacity

    def lookup(self, raw: bytes) -> Optional["TokenRequest"]:
        if self.capacity == 0:  # disabled: no storage, no counters
            return None
        with self._lock:
            entry = self._entries.get(raw)
            if entry is not None:
                self._entries.move_to_end(raw)
        if entry is None:
            mx.counter("request.cache.misses").inc()
            return None
        mx.counter("request.cache.hits").inc()
        return entry._clone()

    def store(self, raw: bytes, req: "TokenRequest") -> None:
        if self.capacity == 0:
            return
        evicted = 0
        with self._lock:
            self._entries[raw] = req
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                evicted += 1
                self._evictions += 1
            total, size = self._evictions, len(self._entries)
        if evicted:
            mx.counter("request.cache.evictions").inc(evicted)
            if total == evicted or (total // self._FLIGHT_EVERY) > (
                (total - evicted) // self._FLIGHT_EVERY
            ):
                mx.flight(
                    "request.cache.evict", evicted=total, size=size,
                    capacity=self.capacity,
                )

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._evictions = 0
            if self._from_env:
                self._capacity = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_CACHE = _RequestCache()


def cache_clear() -> None:
    """Drop every cached parsed request (tests; also on memory pressure)."""
    _CACHE.clear()


def cache_len() -> int:
    return len(_CACHE)
