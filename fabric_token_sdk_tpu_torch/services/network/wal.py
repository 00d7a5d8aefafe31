"""Crash-safe write-ahead log for the ledger's block stream.

Counterpart of `fabric_token_sdk_tpu/services/network/wal.py`, by copy:
the framing and the records are the same bytes, so a journal written by
either package recovers in the other.

Reference parity: the SDK recovers vault + ledger state on node restart
from the committed block stream (`token/services/network/*`,
`token/services/vault/*`); here the durable artifact is an fsync'd,
CRC-framed journal of cut blocks. `Network._commit_block` appends each
block *before* the atomic in-memory merge, so any block a submitter ever
saw finality for is on disk; `Network.recover` replays the journal on
top of the latest snapshot (`<wal>.snap`, written every
`FTS_WAL_SNAPSHOT_EVERY` blocks as the compaction mechanism).

Record framing (all big-endian):

    [4-byte payload length][4-byte CRC32 of payload][payload]

Torn-tail semantics: a crash mid-append (or mid-fsync) leaves a partial
or CRC-broken final record. `replay()` scans records sequentially and
treats the FIRST bad frame — short header, short payload, or CRC
mismatch — as the torn tail: everything before it is returned, the file
is truncated back to the last good record boundary (so later appends
produce a clean journal), and `wal.torn_tails` is incremented. This is
standard redo-log behavior: bytes after a torn record were never
acknowledged to any client, so discarding them loses nothing that was
promised. No record, torn or whole, is ever fatal to recovery.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Iterator, List, Tuple

from ...utils import faults
from ...utils import metrics as mx
from ...utils.tracing import logger

_HDR = struct.Struct(">II")  # payload length, CRC32(payload)


class WALError(RuntimeError):
    """Unrecoverable journal problem (e.g. a height gap on replay)."""


def fsync_dir(path: str) -> None:
    """fsync the directory containing `path`: file creates/renames are
    only durable once the DIRECTORY entry is — without this, a power
    loss can persist a later truncate while losing an earlier rename
    (exactly the snapshot-then-truncate-journal compaction ordering)."""
    dirname = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return  # platform/filesystem without dir-open semantics
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class WriteAheadLog:
    """Append-only journal of serialized block records.

    `sync=True` (the default) fsyncs every
    append — that is what makes the finality a submitter observes
    durable. Thread-safety: appends/replays/resets serialize on one
    lock; in the ledger they additionally run under the orderer's commit
    lock, which is what orders records correctly.
    """

    def __init__(self, path: str, sync: bool = True):
        self.path = str(path)
        self.sync = sync
        self.poisoned = False  # set when the on-disk state is unknowable
        self._lock = threading.Lock()
        # bumped on every truncation (`_reopen`): record boundaries
        # before and after a truncate are unrelated, so a replay scan
        # started under an older generation must never act on the file
        self._generation = 0
        self._fh = open(self.path, "ab")
        if self.sync:
            fsync_dir(self.path)  # the journal's dir entry must survive too

    # ------------------------------------------------------------ write

    def append(self, payload: bytes) -> None:
        faults.fire("wal.append")
        with self._lock, mx.timed("wal.append.seconds"):
            if self.poisoned:
                raise WALError(
                    f"wal {self.path}: poisoned by an earlier append failure "
                    "(on-disk state unknown; recover the node)"
                )
            start = os.path.getsize(self.path)  # buffer is empty between appends
            try:
                self._fh.write(
                    _HDR.pack(len(payload), zlib.crc32(payload)) + payload
                )
                self._fh.flush()
                if self.sync:
                    os.fsync(self._fh.fileno())
            except Exception:
                # Roll the journal back to the pre-append boundary: a
                # FAILED append must never leave a (possibly durable)
                # record behind, or the next successful commit would
                # journal a second record at the same height and recovery
                # would resurrect the aborted block in its place.
                mx.counter("wal.append_failures").inc()
                try:
                    self._reopen(start)
                except OSError:
                    # can't even truncate: fail-stop — refuse appends
                    # until the node is recovered from disk
                    self.poisoned = True
                    logger.exception(
                        "wal: append failed AND rollback failed; %s is "
                        "poisoned (fail-stop)", self.path,
                    )
                raise
            size = self._fh.tell()
        mx.counter("wal.appends").inc()
        mx.gauge("wal.bytes").set(size)

    def reset(self) -> None:
        """Truncate the journal to empty — called after a snapshot has
        durably captured everything the journal held (compaction)."""
        with self._lock:
            self._reopen(0)
        mx.counter("wal.resets").inc()
        mx.gauge("wal.bytes").set(0)

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.close()
            except OSError:
                pass

    def _reopen(self, size: int) -> None:
        self._generation += 1
        self._fh.close()
        os.truncate(self.path, size)
        self._fh = open(self.path, "ab")

    # ------------------------------------------------------------ read

    def replay_iter(self, from_offset: int = 0) -> Iterator[Tuple[int, bytes]]:
        """Stream complete records from `from_offset` (a record boundary),
        yielding `(next_offset, payload)` pairs oldest first.

        The journal is read one frame at a time — never materialized
        whole — so replaying a multi-GiB journal costs O(largest record)
        memory, and a follower tail can resume from the last offset it
        applied. The scan is bounded by the file size observed under the
        lock at entry, so records appended concurrently (a live leader
        shipping while committing) are simply not part of this pass; the
        tailer re-enters with the last yielded offset to pick them up.

        Torn-tail semantics match `replay()`: the first bad frame within
        the scanned span — short header, short payload, CRC mismatch —
        ends the stream, and the file is truncated back to the last good
        boundary after re-verifying under the lock that (a) the journal
        has not been truncated/compacted since this scan began (the
        generation guard — post-compaction boundaries are unrelated to
        this scan's offsets, so a stale verdict must be a no-op, never a
        mid-record truncation of live fsync'd records) and (b) no
        complete record landed at the boundary in the meantime (so a
        concurrent append can never be destroyed either).
        """
        with self._lock:
            self._fh.flush()
            size = os.path.getsize(self.path)
            generation = self._generation
        good = from_offset
        yielded = 0
        with open(self.path, "rb") as fh:
            fh.seek(good)
            while good + _HDR.size <= size:
                hdr = fh.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    break  # short header: torn tail
                n, crc = _HDR.unpack(hdr)
                end = good + _HDR.size + n
                if end > size:
                    break  # partial payload: torn tail
                payload = fh.read(n)
                if len(payload) < n or zlib.crc32(payload) != crc:
                    break  # corrupt frame: treat as torn tail
                good = end
                yielded += 1
                yield good, payload
        if good < size:
            self._truncate_torn(good, yielded, generation)

    def _truncate_torn(self, good: int, records: int,
                       generation: int) -> None:
        """Truncate a torn tail back to the record boundary `good`,
        unless the journal was truncated/compacted since the scan began
        (`generation` mismatch: `good` is an offset into a file that no
        longer exists — acting on it would cut a LIVE record in half) or
        a complete record has landed at the boundary in the meantime (a
        concurrent append on a live journal must never be destroyed)."""
        with self._lock:
            if self._generation != generation:
                return  # stale scan: boundaries have moved under it
            self._fh.flush()
            size = os.path.getsize(self.path)
            if size <= good:
                return
            with open(self.path, "rb") as fh:
                fh.seek(good)
                hdr = fh.read(_HDR.size)
                if len(hdr) == _HDR.size:
                    n, crc = _HDR.unpack(hdr)
                    payload = fh.read(n)
                    if len(payload) == n and zlib.crc32(payload) == crc:
                        return  # a whole record landed here: not torn
            mx.counter("wal.torn_tails").inc()
            mx.flight("wal.torn_tail", bytes=size - good, records=records)
            logger.warning(
                "wal: discarding %d-byte torn tail of %s after %d good "
                "records", size - good, self.path, records,
            )
            self._reopen(good)

    def replay(self) -> List[bytes]:
        """Return every complete record, oldest first; truncate any torn
        tail back to the last good record boundary."""
        out = [payload for _off, payload in self.replay_iter()]
        mx.counter("wal.replayed.records").inc(len(out))
        return out
