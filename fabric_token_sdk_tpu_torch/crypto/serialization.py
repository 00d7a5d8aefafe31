"""Canonical serialization for Fiat-Shamir transcripts and wire formats.

Mirrors the role of reference `crypto/common/array.go` (GetG1Array/Bytes):
deterministic byte strings fed to the challenge hash. JSON-with-hex is the
wire format for proofs/params (reference uses encoding/json of mathlib
types; ours is a cleaner explicit codec, not a byte-compatible one).
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

from . import hostmath as hm


def g1s_bytes(*groups) -> bytes:
    """Concatenate canonical encodings of G1 points from several iterables."""
    out = bytearray()
    for group in groups:
        for pt in group:
            out += hm.g1_to_bytes(pt)
    return bytes(out)


def g2s_bytes(*groups) -> bytes:
    out = bytearray()
    for group in groups:
        for pt in group:
            out += hm.g2_to_bytes(pt)
    return bytes(out)


def zrs_bytes(*groups) -> bytes:
    out = bytearray()
    for group in groups:
        for z in group:
            out += hm.zr_to_bytes(z)
    return bytes(out)


# ------------------------------------------------------------ JSON wire fmt

def _enc(v: Any) -> Any:
    if v is None:
        return None
    if isinstance(v, bool):
        return v
    if isinstance(v, int):
        return hex(v)
    if isinstance(v, float):
        return {"f": repr(v)}
    if isinstance(v, bytes):
        return {"b": v.hex()}
    if isinstance(v, tuple):  # G1/G2 points or fp2 pairs, nested ints
        return {"t": [_enc(x) for x in v]}
    if isinstance(v, list):
        return [_enc(x) for x in v]
    if isinstance(v, dict):
        return {k: _enc(x) for k, x in v.items()}
    if isinstance(v, str):
        # wrapped so user strings can never be confused with hex ints
        return {"s": v}
    raise TypeError(f"cannot encode {type(v)}")


def _dec(v: Any) -> Any:
    if v is None:
        return None
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return int(v, 16)
    if isinstance(v, dict):
        if set(v) == {"b"}:
            return bytes.fromhex(v["b"])
        if set(v) == {"s"}:
            return v["s"]
        if set(v) == {"f"}:
            return float(v["f"])
        if set(v) == {"t"}:
            return tuple(_dec(x) for x in v["t"])
        return {k: _dec(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_dec(x) for x in v]
    return v


class MalformedProof(ValueError):
    """Raised when attacker-supplied bytes fail to parse as a valid proof."""


def guard(fn):
    """Decorator for verifier entry points: any structural error from
    malformed input becomes a ValueError (never a crash)."""

    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except ValueError:
            raise
        except Exception as e:  # TypeError/KeyError/IndexError from bad bytes
            raise MalformedProof(f"malformed proof: {type(e).__name__}: {e}") from e

    wrapped.__name__ = fn.__name__
    wrapped.__doc__ = fn.__doc__
    return wrapped


def dumps(obj: dict) -> bytes:
    return json.dumps(_enc(obj), sort_keys=True, separators=(",", ":")).encode()


def loads(raw: bytes) -> dict:
    return _dec(json.loads(raw.decode()))


# ------------------------------------------------------------ parse caches

_BYTES_CACHES: list = []


class BytesCache:
    """Bounded LRU raw-bytes -> parsed object for hot READ-ONLY decode
    paths (serialized actions, tokens): block validation decodes the same
    bytes several times per tx (plan hooks + validate), and chained
    transfers re-decode the previous tx's outputs as inputs.

    Cached objects are shared between callers — only use this for decodes
    whose consumers never mutate the result. Parse failures re-raise on
    every lookup and are never cached. Every instance shares the
    `parse.cache.{hits,misses}` counter family; capacity comes lazily
    from FTS_PARSE_CACHE (default 8192, 0 disables storage and counters)
    and re-resolves after `clear()`.
    """

    def __init__(self, parse: Callable[[bytes], Any],
                 capacity: Optional[int] = None):
        self._parse = parse
        self._from_env = capacity is None
        self._capacity = max(0, capacity) if capacity is not None else None
        self._entries: "OrderedDict[bytes, Any]" = OrderedDict()
        self._lock = threading.Lock()
        _BYTES_CACHES.append(self)

    @property
    def capacity(self) -> int:
        if self._capacity is None:
            try:
                self._capacity = max(
                    0, int(os.environ.get("FTS_PARSE_CACHE", "8192"))
                )
            except ValueError:
                self._capacity = 8192
        return self._capacity

    def lookup(self, raw: bytes) -> Any:
        if self.capacity == 0:  # disabled: no storage, no counters
            return self._parse(raw)
        from ..utils import metrics as _mx

        with self._lock:
            if raw in self._entries:
                self._entries.move_to_end(raw)
                entry = self._entries[raw]
                hit = True
            else:
                hit = False
        if hit:
            _mx.counter("parse.cache.hits").inc()
            return entry
        _mx.counter("parse.cache.misses").inc()
        entry = self._parse(raw)  # may raise — never cached
        with self._lock:
            self._entries[raw] = entry
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return entry

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            if self._from_env:
                self._capacity = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def parse_caches_clear() -> None:
    """Drop every registered bytes-parse cache (tests)."""
    for c in _BYTES_CACHES:
        c.clear()


_LOADS_CACHE = BytesCache(loads)


def loads_cached(raw: bytes) -> dict:
    """`loads` through the bounded parse cache — READ-ONLY results."""
    return _LOADS_CACHE.lookup(raw)
