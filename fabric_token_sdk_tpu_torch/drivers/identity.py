"""Identity encoding shared by drivers.

Owner identities are tagged wire blobs so validators can dispatch:
  pk    — long-term Schnorr public key (fabtoken owners, issuers, auditors)
  nym   — pseudonym commitment (zkatdlog owners)
  htlc  — hash-time-locked-contract script (interop; see services/interop)

Reference: `token/core/identity/*`, `token/services/interop/htlc`.

Parse cache: wallet workloads repeat owners heavily — the same auditor /
issuer / owner identity arrives with every tx — so `verify_signature`
and the batched signature plane share one bounded LRU keyed by the RAW
identity bytes that holds the decoded blob and (for `pk` identities) the
constructed `PublicKey` (`g1_from_bytes` incl. the on-curve check runs
ONCE per distinct identity, not once per verify). `FTS_IDENTITY_CACHE`
sizes it (default 4096; 0 disables); `identity.cache.hits/misses` are
the observability counters. `parse()` stays uncached on purpose: it
returns a caller-owned dict (callers may mutate it), while cache entries
are shared and must never be written to.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional, Tuple

from ..crypto import hostmath as hm, nym as nym_mod, sign
from ..crypto.serialization import dumps, loads
from ..utils import metrics as mx
from ..utils import profiler


def pk_identity(public: sign.PublicKey) -> bytes:
    return dumps({"t": "pk", "pk": public.to_bytes()})


def nym_identity(nym_point) -> bytes:
    return dumps({"t": "nym", "nym": nym_point})


def htlc_identity(script: dict) -> bytes:
    return dumps({"t": "htlc", "script": script})


def parse(raw: bytes) -> dict:
    d = loads(raw)
    if not isinstance(d, dict) or "t" not in d:
        raise ValueError("invalid identity encoding")
    return d


def identity_kind(raw: bytes) -> str:
    return parse(raw)["t"]


# ------------------------------------------------------------ parse cache


class _IdentityCache:
    """Bounded LRU: raw identity bytes -> (kind, PublicKey|None, parsed
    dict). Shared by the host verify dispatch and the batched signature
    plane's obligation collector. Parse/decode FAILURES are never cached
    (they re-raise on every lookup, exactly like the uncached path)."""

    def __init__(self, capacity: Optional[int] = None):
        # an explicit capacity is fixed; otherwise FTS_IDENTITY_CACHE is
        # resolved lazily on FIRST USE (not at import) and re-resolved
        # after clear(), so tests/operators configuring the env after
        # the SDK imported still take effect
        self._from_env = capacity is None
        self._capacity = max(0, capacity) if capacity is not None else None
        self._entries: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        if self._capacity is None:
            try:
                self._capacity = max(
                    0, int(os.environ.get("FTS_IDENTITY_CACHE", "4096"))
                )
            except ValueError:
                self._capacity = 4096
        return self._capacity

    def lookup(self, raw: bytes) -> Tuple[str, Optional[sign.PublicKey], dict]:
        if self.capacity == 0:  # disabled: no storage, no counters
            d = parse(raw)
            kind = d["t"]
            pk = sign.PublicKey.from_bytes(d["pk"]) if kind == "pk" else None
            return kind, pk, d
        with self._lock:
            entry = self._entries.get(raw)
            if entry is not None:
                self._entries.move_to_end(raw)
        if entry is not None:
            mx.counter("identity.cache.hits").inc()
            return entry
        mx.counter("identity.cache.misses").inc()
        d = parse(raw)  # may raise ValueError — not cached
        kind = d["t"]
        pk = sign.PublicKey.from_bytes(d["pk"]) if kind == "pk" else None
        entry = (kind, pk, d)
        with self._lock:
            self._entries[raw] = entry
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return entry

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            if self._from_env:
                # env-derived capacity re-resolves on next use; an
                # explicitly constructed capacity stays pinned
                self._capacity = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_CACHE = _IdentityCache()


def cache_clear() -> None:
    """Drop every cached identity (tests; also after key rotation)."""
    _CACHE.clear()


def cache_len() -> int:
    return len(_CACHE)


def public_key(raw: bytes) -> Optional[sign.PublicKey]:
    """The cached `PublicKey` of a `pk`-kind identity, or None for every
    other kind AND for malformed blobs (the batched plane's collector
    must never raise — the host path re-parses and reports the precise
    error)."""
    try:
        kind, pk, _ = _CACHE.lookup(raw)
    except Exception:
        return None
    return pk if kind == "pk" else None


def verify_signature(identity: bytes, message: bytes, signature: bytes,
                     nym_params=None, now=None) -> None:
    """Dispatch signature verification on the identity kind."""
    with profiler.leg("sig_verify"):
        kind, pk, d = _CACHE.lookup(identity)
        if kind == "pk":
            pk.verify(message, signature)
        elif kind == "nym":
            if nym_params is None:
                raise ValueError("nym verification requires nym parameters")
            nym_mod.NymVerifier(d["nym"], list(nym_params)).verify(
                message, signature
            )
        elif kind == "htlc":
            # hash-time-locked script: claim/reclaim rules (lazy import
            # to avoid a services <-> drivers cycle)
            from ..services.interop.htlc import verify_htlc_spend

            verify_htlc_spend(identity, message, signature, nym_params,
                              now=now)
        else:
            raise ValueError(
                f"cannot verify signature for identity kind [{kind}]"
            )
