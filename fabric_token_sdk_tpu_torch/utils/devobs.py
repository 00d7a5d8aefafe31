"""Device-plane dispatch ledger: rows, padding, device time and build
attribution of every kernel launch.

Counterpart of `fabric_token_sdk_tpu/utils/devobs.py`. Every kernel
wrapper of `ops/stages.py` (and through them the staged and fused
pairing products of `ops/pairing.py`, the batched verifiers, signer and
prover, warmup) opens a `dispatch(...)` frame named by its kernel, and
the mesh plane (`parallel/sharding.py`) one a mesh call. A frame records
requested and padded rows, the dp/mp placement and the dispatch's time,
under the plane the caller tagged (`plane("verify")`, `"sign"`,
`"prove"`; `"stages"` untagged), and feeds the metrics registry under
the reference's names:

  * ``device.dispatch.seconds``            all dispatches, one histogram
  * ``device.dispatch.<program>.seconds``  a program's dispatch times
  * ``device.<plane>.occupancy``           rows / (rows + padding)
  * ``device.<program>.padded_rows``       cumulative padding

The two time histograms take `TIME_BUCKETS`, not the registry's default
(from 1 ms): bounds in steps of 1.2x from 10 us to 25 ms, a kernel's
range, so that a bucket's midpoint lies within 10% of any time inside
it, then coarse steps up to 120 s for the plain versions. A p50 is
then not an artifact of interpolating inside a wide bucket.

The port launches once over all rows, so its kernel frames carry no
padding; the mesh plane's carry the dp padding of `shard_rows`.

Time. On the card a wrapper returns once its kernel is queued, so a
host clock would time the enqueue. A frame on a CUDA device therefore
records a pair of timing events (pooled `torch.cuda.Event`s) on the
current stream of that device, the stream the launch uses, around its
body. Nothing on the dispatch path synchronizes: the pairs wait in a
pending list and are resolved by `query()` when the ledger is read
(`snapshot`, `health_section`, `section`, `resolve`), or when the list
grows past `RESOLVE_AT`; only then are their times observed into the
histograms and `wall_s`. A pair still running at a read is resolved at
a later read, never dropped. A mesh frame takes the longest of its devices' pairs. A
pair measures its stream between its two events: work another thread
queued on the same stream in between is inside it. So a frame whose pair
was open on a stream while another thread's pair was open there counts
as overlapped (`overlapped` in its program's `snapshot()` entry,
`dispatch_overlapped` beside the p50 in `section()`, the counter
`device.dispatch.overlapped`): its time may hold
the other thread's kernels. A frame nested in another on the same thread
(a mesh frame around its kernels' frames) is not an overlap. On the CPU
a frame times its body (the plain version) by the host clock.

Builds and loads. `ops/_build.build_all` reports each `nvcc` build
(`note_compile(seconds)` and a cache miss) and each load of an existing
library (a cache hit) against the active frame: the program whose launch
needed the libraries, or warmup's `attribute` frame. The fields keep the
reference's names (`compiles`, `compile_s`, `cache_hits`,
`cache_misses`).

Degrade decisions (the fused pairing product's `K % mp` bailout) land in
the same entry through `note_degrade`.

A frame records only a body that returned: a launch that raised counts
no dispatch, as it counts no `Kernel.launches`.

The ledger is on by default; `enable(False)` turns every entry point
into a passthrough that touches neither the ledger nor the registry. On
or off it only observes: no result depends on it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import metrics as mx

__all__ = [
    "enable",
    "enabled",
    "dispatch",
    "plane",
    "current_plane",
    "attribute",
    "current_program",
    "note_compile",
    "note_cache",
    "note_degrade",
    "resolve",
    "snapshot",
    "reset",
    "health_section",
    "section",
]

UNATTRIBUTED = "(unattributed)"
DEFAULT_PLANE = "stages"
# pending event pairs past which a dispatch resolves the finished ones
# itself (by `query()`, no synchronize), so an unread ledger stays bounded
RESOLVE_AT = 64

# occupancy lives in (0, 1]; the default latency buckets would collapse
# it into two bins
_OCC_BUCKETS = tuple(i / 10.0 for i in range(1, 11))
# dispatch times run from microseconds (a small kernel on the card) to
# seconds (a plain version on the CPU): steps of 1.2x from 10 us to 25 ms,
# where a bucket's midpoint is within 10% of any time inside it, then the
# coarse steps of the plain versions
TIME_BUCKETS = tuple(float(f"{1e-5 * 1.2 ** k:.4g}") for k in range(43)) + (
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

_enabled = True
_tl = threading.local()
_lock = threading.Lock()
# (plane, program) -> aggregate dict
_programs: Dict[Tuple[str, str], dict] = {}
# the fallback frame for build events outside any frame of this thread
_last_frame: Optional[Tuple[str, str]] = None
# dispatches on the card whose event pairs are not resolved yet:
# (frame, program, [(start, end), ...] one pair a device)
_pending: List[tuple] = []
# free timing events, by the device they were first recorded on
_free_events: Dict[str, list] = {}
# event pairs open on each stream: key -> {token: (thread ident, [overlapped])}
_open: Dict[str, Dict[int, tuple]] = {}
_tokens = itertools.count()


def enable(flag: bool = True) -> None:
    """Turn the ledger on or off (on by default)."""
    global _enabled
    _enabled = bool(flag)


def enabled() -> bool:
    return _enabled


def _entry(frame: Tuple[str, str]) -> dict:
    e = _programs.get(frame)
    if e is None:
        e = _programs[frame] = {
            "dispatches": 0,
            "rows": 0,
            "padded_rows": 0,
            "wall_s": 0.0,
            "dp": 1,
            "mp": 1,
            "compiles": 0,
            "compile_s": 0.0,
            "cache_hits": 0,
            "cache_misses": 0,
            "overlapped": 0,
            "degrades": {},
        }
    return e


def current_plane() -> str:
    return getattr(_tl, "plane", None) or DEFAULT_PLANE


@contextlib.contextmanager
def plane(name: str):
    """Tag dispatches in this block with a logical plane (verify, sign,
    prove, ...). Passthrough when the ledger is off."""
    if not _enabled:
        yield
        return
    prev = getattr(_tl, "plane", None)
    _tl.plane = name
    try:
        yield
    finally:
        _tl.plane = prev


@contextlib.contextmanager
def attribute(program: str, plane_name: Optional[str] = None):
    """Attribute build and load events in this block to `program`
    without recording a dispatch: warmup's frame."""
    if not _enabled:
        yield
        return
    global _last_frame
    frame = (plane_name or current_plane(), program)
    prev = getattr(_tl, "frame", None)
    _tl.frame = frame
    _last_frame = frame
    try:
        yield
    finally:
        _tl.frame = prev


def _streams(device) -> list:
    """The current streams of the CUDA devices among `device` (one
    torch.device, or a sequence of them), one a device."""
    if device is None:
        return []
    import torch

    devices = [device] if isinstance(device, (str, torch.device)) else list(device)
    out, seen = [], set()
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            continue
        s = torch.cuda.current_stream(d)
        key = str(s.device)
        if key not in seen:
            seen.add(key)
            out.append((key, s))
    return out


def _open_pairs(keys) -> tuple:
    """Register a frame's event pairs as open on the streams `keys`. A pair
    that another thread holds open on one of them overlaps this one, and
    both are marked. Returns (token, mark) for `_close_pairs`."""
    me = threading.get_ident()
    token, mark = next(_tokens), [False]
    with _lock:
        for key in keys:
            frames = _open.setdefault(key, {})
            for ident, other in frames.values():
                if ident != me:
                    other[0] = mark[0] = True
            frames[token] = (me, mark)
    return token, mark


def _close_pairs(token: int, keys) -> None:
    """The frame's pairs are closed: no later pair can overlap them."""
    with _lock:
        for key in keys:
            _open.get(key, {}).pop(token, None)


def _event(key: str):
    with _lock:
        free = _free_events.get(key)
        if free:
            return free.pop()
    import torch

    return torch.cuda.Event(enable_timing=True)


def _release(key: str, *events) -> None:
    with _lock:
        _free_events.setdefault(key, []).extend(events)


@contextlib.contextmanager
def dispatch(
    program: str,
    *,
    rows: int,
    padded_rows: int = 0,
    dp: int = 1,
    mp: int = 1,
    plane: Optional[str] = None,
    device=None,
):
    """Record one dispatch of `program`: requested and padded rows, dp/mp
    placement, and its time, by timing events on `device`'s current
    stream where it is a CUDA device (a sequence: each device's stream,
    the longest pair), else by the host clock. Passthrough when off."""
    if not _enabled:
        yield
        return
    global _last_frame
    pl = plane or current_plane()
    frame = (pl, program)
    prev = getattr(_tl, "frame", None)
    _tl.frame = frame
    _last_frame = frame
    starts = []
    for key, s in _streams(device):
        ev = _event(key)
        ev.record(s)
        starts.append((key, s, ev))
    keys = [key for key, _s, _ev in starts]
    token, overlap = _open_pairs(keys) if keys else (None, [False])
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        _close_pairs(token, keys)
        for key, _s, ev in starts:
            _release(key, ev)
        raise
    finally:
        _tl.frame = prev
    wall = None if starts else time.perf_counter() - t0
    pairs = []
    for key, s, start in starts:
        end = _event(key)
        end.record(s)
        pairs.append((key, start, end))
    _close_pairs(token, keys)
    if overlap[0]:
        mx.counter("device.dispatch.overlapped").inc()
    with _lock:
        e = _entry(frame)
        e["dispatches"] += 1
        e["overlapped"] += int(overlap[0])
        e["rows"] += rows
        e["padded_rows"] += padded_rows
        e["dp"] = dp
        e["mp"] = mp
        if wall is not None:
            e["wall_s"] += wall
        else:
            _pending.append((frame, program, pairs))
        crowded = len(_pending) >= RESOLVE_AT
    if wall is not None:
        _observe(program, wall)
    elif crowded:
        resolve()
    total = rows + padded_rows
    if total:
        mx.histogram(f"device.{pl}.occupancy", buckets=_OCC_BUCKETS).observe(rows / total)
    if padded_rows:
        mx.counter(f"device.{program}.padded_rows").inc(padded_rows)


def _time_hist(name: str):
    return mx.histogram(name, buckets=TIME_BUCKETS)


def _observe(program: str, seconds: float) -> None:
    _time_hist("device.dispatch.seconds").observe(seconds)
    _time_hist(f"device.dispatch.{program}.seconds").observe(seconds)


def resolve() -> None:
    """Observe every pending dispatch whose events have all completed
    (`query()`, which never blocks); the rest stay pending. The ledger's
    reads call it; so does the node's `ops.metrics`, whose histograms it
    fills."""
    done = []
    with _lock:
        keep = []
        for frame, program, pairs in _pending:
            if all(end.query() for _key, _start, end in pairs):
                wall = max(start.elapsed_time(end) for _key, start, end in pairs) / 1e3
                _entry(frame)["wall_s"] += wall
                done.append((program, wall))
                for key, start, end in pairs:
                    _free_events.setdefault(key, []).extend((start, end))
            else:
                keep.append((frame, program, pairs))
        _pending[:] = keep
    for program, wall in done:
        _observe(program, wall)


def _active_frame() -> Tuple[str, str]:
    f = getattr(_tl, "frame", None)
    return f or _last_frame or (DEFAULT_PLANE, UNATTRIBUTED)


def current_program() -> Optional[str]:
    """The program of the innermost dispatch/attribute frame (this
    thread first, then the process-wide last frame), else None."""
    f = getattr(_tl, "frame", None) or _last_frame
    return f[1] if f else None


def note_compile(seconds: float) -> None:
    """One `nvcc` build of a kernel source, its wall seconds, against the
    active program."""
    if not _enabled:
        return
    frame = _active_frame()
    with _lock:
        e = _entry(frame)
        e["compiles"] += 1
        e["compile_s"] += seconds


def note_cache(event: str) -> None:
    """A library load against the active program: `...cache_hits` for a
    library `_build/` already held, `...cache_misses` for one just
    built."""
    if not _enabled:
        return
    if event.endswith("cache_hits"):
        key = "cache_hits"
    elif event.endswith("cache_misses"):
        key = "cache_misses"
    else:
        return
    frame = _active_frame()
    with _lock:
        _entry(frame)[key] += 1


def note_degrade(reason: str, program: Optional[str] = None, plane: Optional[str] = None) -> None:
    """Record a degrade decision (the fused pairing product's shape
    bailout) against the active, or the named, program."""
    if not _enabled:
        return
    if program is not None:
        frame = (plane or current_plane(), program)
    else:
        frame = _active_frame()
    with _lock:
        degrades = _entry(frame)["degrades"]
        degrades[reason] = degrades.get(reason, 0) + 1


def snapshot() -> Dict[Tuple[str, str], dict]:
    """Per-(plane, program) aggregates, the finished event pairs
    resolved first; values are copies."""
    resolve()
    with _lock:
        return {frame: dict(e, degrades=dict(e["degrades"])) for frame, e in _programs.items()}


def reset() -> None:
    """Drop all ledger state, pending pairs included (registry metrics
    are untouched)."""
    global _last_frame
    with _lock:
        _programs.clear()
        _pending.clear()
        _open.clear()
    _last_frame = None


def _occ(rows: int, padded: int) -> Optional[float]:
    total = rows + padded
    return round(rows / total, 4) if total else None


def _waste(rows: int, padded: int) -> Optional[float]:
    total = rows + padded
    return round(padded / total, 4) if total else None


def health_section() -> dict:
    """The `device` block of `Network.health()` / the `ops.health` RPC:
    per-plane occupancy plus the full per-program ledger."""
    snap = snapshot()
    programs: Dict[str, dict] = {}
    planes: Dict[str, dict] = {}
    for (pl, prog), e in sorted(snap.items()):
        q = _time_hist(f"device.dispatch.{prog}.seconds")
        p50 = q.quantile(0.5)
        p99 = q.quantile(0.99)
        programs[f"{pl}:{prog}"] = {
            "plane": pl,
            "program": prog,
            "dispatches": e["dispatches"],
            "rows": e["rows"],
            "padded_rows": e["padded_rows"],
            "occupancy": _occ(e["rows"], e["padded_rows"]),
            "waste_frac": _waste(e["rows"], e["padded_rows"]),
            "wall_s": round(e["wall_s"], 6),
            "p50_s": round(p50, 6) if p50 is not None else None,
            "p99_s": round(p99, 6) if p99 is not None else None,
            "dp": e["dp"],
            "mp": e["mp"],
            "compiles": e["compiles"],
            "compile_s": round(e["compile_s"], 3),
            "cache_hits": e["cache_hits"],
            "cache_misses": e["cache_misses"],
            "degrades": sum(e["degrades"].values()),
            "degrade_reasons": dict(e["degrades"]),
        }
        agg = planes.setdefault(pl, {"dispatches": 0, "rows": 0, "padded_rows": 0})
        agg["dispatches"] += e["dispatches"]
        agg["rows"] += e["rows"]
        agg["padded_rows"] += e["padded_rows"]
    for agg in planes.values():
        agg["occupancy"] = _occ(agg["rows"], agg["padded_rows"])
        agg["waste_frac"] = _waste(agg["rows"], agg["padded_rows"])
    return {"enabled": _enabled, "planes": planes, "programs": programs}


def section() -> dict:
    """The schema-validated `device` section of a bench result
    (`utils/benchschema.py`): the top-level scalars the `ftstop compare
    --device` gate reads, plus the per-plane / per-program breakdown."""
    h = health_section()
    progs = h["programs"].values()
    rows = sum(e["rows"] for e in progs)
    padded = sum(e["padded_rows"] for e in progs)
    agg = _time_hist("device.dispatch.seconds")
    p50 = agg.quantile(0.5)
    p99 = agg.quantile(0.99)
    with _lock:
        overlapped = sum(e["overlapped"] for e in _programs.values())
    return {
        "dispatches": sum(e["dispatches"] for e in progs),
        "rows": rows,
        "padded_rows": padded,
        "occupancy": _occ(rows, padded),
        "waste_frac": _waste(rows, padded),
        "dispatch_p50_s": round(p50, 6) if p50 is not None else None,
        "dispatch_p99_s": round(p99, 6) if p99 is not None else None,
        # frames whose event pair shared its stream with another thread's
        "dispatch_overlapped": overlapped,
        "compiles": sum(e["compiles"] for e in progs),
        "compile_s": round(sum(e["compile_s"] for e in progs), 3),
        "cache_hits": sum(e["cache_hits"] for e in progs),
        "cache_misses": sum(e["cache_misses"] for e in progs),
        "degrades": sum(e["degrades"] for e in progs),
        "planes": h["planes"],
        "programs": h["programs"],
    }
