"""Kernel warmup: build and load every extension, then launch each kernel once.

Counterpart of `fabric_token_sdk_tpu/ops/warmup.py`. The reference
compiles its canonical XLA programs ahead of time into the persistent
cache; here every device program is a hand-written CUDA kernel
(`csrc/`), so warming a node means building or loading each kernel's
shared library (`_build.build_all`: `nvcc` only where `_build/` holds no
library for the current source) and launching each kernel once on the
card, at a few rows, through the `ops/stages.py` entry points the
verify, prove and mesh paths call. A node that is to take over a ledger
then pays no build and no first launch at failover.

The inventory (`all_programs`) is the port's kernel table, PERF.md
section 6 rows B4-B16: one program a row and entry point, each with the
kernel it launches. `PROVER_ONLY_PROGRAMS` keeps the reference's meaning:
programs only the batched prover launches.

Entry points:
  * `warmup()`                  the library call (a ledger node at start)
  * `python -m fabric_token_sdk_tpu_torch.cmd.ftswarmup`   the CLI
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from . import _build, curve as cv, curve2 as cv2, pairing as pr, stages as st
from ..crypto import hostmath as hm
from ..utils import devobs
from ..utils import metrics as mx

ROWS = 2  # rows a warmup launch


class Program(NamedTuple):
    name: str
    row: str  # the kernel table's row (PERF.md section 6)
    kernel: _build.Kernel
    pairing: bool  # left out by include_pairing=False
    run: Callable[[dict], object]


def _inputs(device: torch.device) -> dict:
    """Valid operands of every entry point at `ROWS` rows, from a fixed
    seed: G1/G2 points, scalars, a one-base fixed-base table, affine legs
    and Miller values."""
    rng = random.Random(0xF75)
    g1 = [hm.rand_g1(rng) for _ in range(ROWS)]
    g2 = [hm.rand_g2(rng) for _ in range(ROWS)]
    ks = [hm.rand_zr(rng) for _ in range(ROWS)]
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    legs = 4 * ROWS  # K = 4 a row covers K = 2 too
    P = t(pr.encode_g1([g1[i % ROWS] for i in range(legs)]))
    Q = t(pr.encode_g2([g2[i % ROWS] for i in range(legs)]))
    return {
        "table": cv.FixedBaseTable(g1[:1]).table.to(device),
        "scalars": t(cv.encode_scalars(ks)),
        "g1": t(cv.encode_points(g1)),
        "g2": t(cv2.encode_points(g2)),
        "P": P, "Q": Q,
    }


def _miller(x: dict, k: int) -> torch.Tensor:
    """Miller values (ROWS, k, 6, 2, 8), from one launch kept apart."""
    if "f4" not in x:
        x["f4"] = st.miller_rows(x["P"], x["Q"]).reshape((ROWS, 4) + st._FP12_SHAPE)
    return x["f4"][:, :k].contiguous()


def _programs() -> List[Program]:
    legs = lambda x, k: (  # noqa: E731
        x["P"].reshape(ROWS, 4, 2, 8)[:, :k].contiguous(),
        x["Q"].reshape(ROWS, 4, 2, 2, 8)[:, :k].contiguous())
    return [
        Program("g1_msm", "B4", _build.G1_MSM, False,
                lambda x: st.g1_msm_rows(x["table"], x["scalars"][:, None])),
        Program("g1_msm_select", "B4 (select)", _build.G1_MSM_SELECT, False,
                lambda x: st.g1_msm_select_rows(x["table"], x["scalars"][:, None])),
        Program("g1_mul", "B5", _build.G1_MUL, False,
                lambda x: st.g1_mul_rows(x["g1"], x["scalars"])),
        Program("g1_sub", "B6", _build.G1_ADDSUB, False,
                lambda x: st.g1_sub_rows(x["g1"], x["g1"].flip(0).contiguous())),
        Program("g1_to_affine", "B7", _build.G1_TO_AFFINE, False,
                lambda x: st.g1_to_affine_rows(x["g1"])),
        Program("g2_mul", "B8", _build.G2_MUL, False,
                lambda x: st.g2_mul_rows(x["g2"], x["scalars"])),
        Program("g2_add", "B9", _build.G2_ADD, False,
                lambda x: st.g2_add_rows(x["g2"], x["g2"].flip(0).contiguous())),
        Program("g2_to_affine", "B10", _build.G2_TO_AFFINE, False,
                lambda x: st.g2_to_affine_rows(x["g2"])),
        Program("miller", "B11", _build.MILLER, True, lambda x: _miller(x, 4)),
        Program("gt_product_k4", "B12", _build.GT_PRODUCT, True,
                lambda x: st.gt_product_rows(_miller(x, 4))),
        Program("final_exp", "B13", _build.FINAL_EXP, True,
                lambda x: st.final_exp_rows(_miller(x, 1)[:, 0].contiguous())),
        Program("g1_add", "B14", _build.G1_ADDSUB, False,
                lambda x: st.g1_add_rows(x["g1"], x["g1"].flip(0).contiguous())),
        Program("gt_product_k2", "B15", _build.GT_PRODUCT, True,
                lambda x: st.gt_product_rows(_miller(x, 2))),
        Program("pairing_product", "B16", _build.PAIRING_PRODUCT, True,
                lambda x: st.pairing_product_rows(*legs(x, 2))),
        Program("gt_product_final_exp", "B16", _build.GT_PRODUCT_FINAL_EXP, True,
                lambda x: st.gt_product_final_exp_rows(_miller(x, 2))),
    ]


# Which plane launches a program: the batched prover (`crypto/batch_prove.py`)
# composes the verify plane's kernels, and only its select multiexp (the
# openings are secret) and the signature-obfuscation add are its own.
PROVER_PROGRAMS = frozenset({
    "g1_msm_select", "g1_mul", "g1_add", "g2_mul", "g2_add", "g2_to_affine", "miller",
    "gt_product_k2", "final_exp",
})
PROVER_ONLY_PROGRAMS = frozenset({"g1_msm_select", "g1_add"})


def program_planes(name: str) -> str:
    """'verify', 'prove', or 'verify+prove' for a program."""
    if name in PROVER_ONLY_PROGRAMS:
        return "prove"
    return "verify+prove" if name in PROVER_PROGRAMS else "verify"


def all_programs(include_pairing: bool = True, include_prover: bool = True) -> List[Program]:
    return [p for p in _programs()
            if (include_pairing or not p.pairing)
            and (include_prover or p.name not in PROVER_ONLY_PROGRAMS)]


def build_extensions() -> Dict[str, List[str]]:
    """Build (where `_build/` holds no current library) and load every
    kernel source: `{"built": sources compiled now, "loaded": every
    source loaded}`. Raises on a failed build."""
    before = set(_build.BUILD_SECONDS)
    libs = _build.build_all()
    return {"built": sorted(set(_build.BUILD_SECONDS) - before), "loaded": sorted(libs)}


def warmup(device=None, include_pairing: bool = True, include_prover: bool = True,
           progress: Optional[Callable[[str, float], None]] = None) -> dict:
    """Build and load every extension, then launch each program's kernel
    once on `device` (None: the card, raising where there is no CUDA;
    "cpu" runs the plain versions and builds nothing, for tests).
    Returns `programs`, `seconds`, `per_program` and the extensions
    `built` and `loaded`."""
    from ..crypto.batch import resolve_device

    dev = resolve_device(device)
    t_total = time.time()
    progs = all_programs(include_pairing, include_prover)
    # the build and load of the extensions, attributed in the dispatch
    # ledger to the first program, whose launch needs them
    with devobs.attribute(progs[0].name):
        ext = build_extensions() if dev.type == "cuda" else {"built": [], "loaded": []}
    programs = []
    with mx.span("warmup.launch", include_pairing=include_pairing):
        x = _inputs(dev)
        for prog in progs:
            t0 = time.time()
            with devobs.attribute(prog.name):
                prog.run(x)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.time() - t0
            mx.counter("warmup.programs").inc()
            mx.histogram("warmup.program.seconds").observe(dt)
            programs.append({"name": prog.name, "kernel": prog.kernel.name,
                             "seconds": round(dt, 3)})
            if progress is not None:
                progress(prog.name, dt)
    total = time.time() - t_total
    mx.gauge("warmup.seconds").set(round(total, 3))
    return {"programs": len(programs), "seconds": round(total, 3),
            "built": len(ext["built"]), "loaded": len(ext["loaded"]),
            "per_program": programs}
