"""Device-plane dispatch ledger: requested and padded rows of every mesh
dispatch, and its degrade decisions.

Host-only copy of the part of the JAX package's `utils/devobs.py` that
the port's mesh plane (`parallel/sharding.py`) calls. Each dispatch over
a mesh opens a `dispatch(...)` frame naming its program; when the frame
completes, the ledger adds its requested and padded rows and keeps its
dp/mp placement. Degrade decisions (the fused pairing product's
`K % mp` bailout) land in the same per-program entry through
`note_degrade`. It only observes: no result depends on it.

`health_section()` is the `device` section of `Network.health()`: each
program's dispatches, rows, padding and occupancy, and their totals.

Not ported: the reference's wall-time and occupancy histograms (on the
card a wrapper returns once its kernel is queued, so a host clock around
it times the enqueue, not the device), its plane tags and its
compile-cache attribution (the port builds its kernels once, outside any
dispatch, `ops/_build.py`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

_lock = threading.Lock()
_programs: Dict[str, dict] = {}


def _entry(program: str) -> dict:
    e = _programs.get(program)
    if e is None:
        e = _programs[program] = {"dispatches": 0, "rows": 0, "padded_rows": 0, "dp": 1,
                                  "mp": 1, "degrades": {}}
    return e


@contextlib.contextmanager
def dispatch(program: str, *, rows: int, padded_rows: int = 0, dp: int = 1, mp: int = 1):
    """Record one dispatch of `program` over a (dp, mp) mesh: requested
    and padded rows, counted when the block completes."""
    yield
    with _lock:
        e = _entry(program)
        e["dispatches"] += 1
        e["rows"] += rows
        e["padded_rows"] += padded_rows
        e["dp"], e["mp"] = dp, mp


def note_degrade(reason: str, program: str) -> None:
    """Record a degrade decision against `program`."""
    with _lock:
        degrades = _entry(program)["degrades"]
        degrades[reason] = degrades.get(reason, 0) + 1


def snapshot() -> Dict[str, dict]:
    """Per-program aggregates; values are copies."""
    with _lock:
        return {p: dict(e, degrades=dict(e["degrades"])) for p, e in _programs.items()}


def reset() -> None:
    """Drop all ledger state (registry metrics are untouched)."""
    with _lock:
        _programs.clear()


def _occ(rows: int, padded: int) -> Optional[float]:
    total = rows + padded
    return round(rows / total, 4) if total else None


def health_section() -> dict:
    """The `device` section of `Network.health()`: per program its
    dispatches, rows, padded rows, occupancy (rows over rows plus
    padding), placement and degrades, and the totals over programs."""
    programs = {}
    for prog, e in sorted(snapshot().items()):
        programs[prog] = {
            "dispatches": e["dispatches"],
            "rows": e["rows"],
            "padded_rows": e["padded_rows"],
            "occupancy": _occ(e["rows"], e["padded_rows"]),
            "dp": e["dp"],
            "mp": e["mp"],
            "degrades": sum(e["degrades"].values()),
            "degrade_reasons": e["degrades"],
        }
    rows = sum(e["rows"] for e in programs.values())
    padded = sum(e["padded_rows"] for e in programs.values())
    return {
        "dispatches": sum(e["dispatches"] for e in programs.values()),
        "rows": rows,
        "padded_rows": padded,
        "occupancy": _occ(rows, padded),
        "programs": programs,
    }
