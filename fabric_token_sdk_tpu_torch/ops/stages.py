"""Row-batched G1 stages of the verify plane: CUDA kernels and plain versions.

Counterpart of `fabric_token_sdk_tpu/ops/stages.py`. Each `g1_*_rows`
function takes int32 tensors of flat rows and issues ONE launch over all
N rows; the reference's ROW_TILE padding existed to keep XLA compiles
small and does not carry over.

Where the tensors lie decides the route: on a CUDA device the wrapper
launches its hand-written kernel (`csrc/`, built by `ops/_build.py`) or
raises; on the CPU it runs the kernel's plain torch version, defined
beside it here. `chip_smoke.py` holds each kernel against its plain
version on the card.

Layouts: points (N, 3, 8) Montgomery Jacobian words, scalars canonical
words, fixed-base tables (nbases*64, 16, 3, 8); outputs are canonical.
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve as cv, limbs as lb
from ._build import G1_ADDSUB, G1_MSM, G1_MUL, check_cuda_tensor
from .field import FP
from ..utils import metrics as mx


def _route(kernel_name: str, *tensors: torch.Tensor) -> bool:
    """True to launch the CUDA kernel, False for the plain version; raises
    on an empty batch or on tensors spread over devices."""
    n = tensors[-1].shape[0]
    if n == 0:
        raise ValueError(f"{kernel_name}: empty row batch (caller must guard)")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel_name}: tensors on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    mx.counter("stages.calls").inc()
    mx.counter("stages.rows").inc(n)
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{kernel_name}: unsupported device {dev}")


# ------------------------------------------------------------------ g1_msm

def g1_msm_plain(table: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Plain version of the g1_msm kernel."""
    return cv.from_half3(cv.msm(table, scalars))


def g1_msm_rows(table: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """(N, nbases, 8) canonical scalars x fixed-base table -> (N, 3, 8)."""
    nbases = scalars.shape[1]
    if table.shape[0] != nbases * cv.DIGITS_PER_SCALAR:
        raise ValueError(f"g1_msm: table of {table.shape[0] // cv.DIGITS_PER_SCALAR} "
                         f"bases for {nbases} scalars a row")
    if not _route("g1_msm", table, scalars):
        return g1_msm_plain(table, scalars)
    n = scalars.shape[0]
    check_cuda_tensor("g1_msm table", table, (nbases * cv.DIGITS_PER_SCALAR, cv.WINDOW_SIZE, 3, lb.NWORDS))
    check_cuda_tensor("g1_msm scalars", scalars, (n, nbases, lb.NWORDS))
    out = torch.empty((n, 3, lb.NWORDS), dtype=torch.int32, device=scalars.device)
    with mx.span("stages.run", kernel="g1_msm", rows=n):
        G1_MSM.launch(scalars.device, table.data_ptr(), scalars.data_ptr(), out.data_ptr(), n, nbases)
    return out


# ------------------------------------------------------------------ g1_mul

def g1_mul_plain(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Plain version of the g1_mul kernel."""
    return cv.from_half3(cv.scalar_mul(cv.to_half3(points), scalars))


def g1_mul_rows(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Variable-base scalar mul: (N, 3, 8) x (N, 8) canonical -> (N, 3, 8)."""
    if not _route("g1_mul", points, scalars):
        return g1_mul_plain(points, scalars)
    n = scalars.shape[0]
    check_cuda_tensor("g1_mul points", points, (n, 3, lb.NWORDS))
    check_cuda_tensor("g1_mul scalars", scalars, (n, lb.NWORDS))
    out = torch.empty((n, 3, lb.NWORDS), dtype=torch.int32, device=points.device)
    with mx.span("stages.run", kernel="g1_mul", rows=n):
        G1_MUL.launch(points.device, points.data_ptr(), scalars.data_ptr(), out.data_ptr(), n)
    return out


# ------------------------------------------------------------------ g1_addsub

def g1_addsub_plain(a: torch.Tensor, b: torch.Tensor, negate_b: bool) -> torch.Tensor:
    """Plain version of the g1_addsub kernel."""
    q = cv.to_half3(b)
    return cv.from_half3(cv.add(cv.to_half3(a), cv.neg(q) if negate_b else q))


def _addsub_rows(a: torch.Tensor, b: torch.Tensor, negate_b: bool) -> torch.Tensor:
    if not _route("g1_addsub", a, b):
        return g1_addsub_plain(a, b, negate_b)
    n = a.shape[0]
    check_cuda_tensor("g1_addsub a", a, (n, 3, lb.NWORDS))
    check_cuda_tensor("g1_addsub b", b, (n, 3, lb.NWORDS))
    out = torch.empty((n, 3, lb.NWORDS), dtype=torch.int32, device=a.device)
    with mx.span("stages.run", kernel="g1_addsub", rows=n):
        G1_ADDSUB.launch(a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, int(negate_b))
    return out


def g1_add_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b on (N, 3, 8) Jacobian rows."""
    return _addsub_rows(a, b, negate_b=False)


def g1_sub_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b on (N, 3, 8) Jacobian rows (commitment minus statement)."""
    return _addsub_rows(a, b, negate_b=True)


# ------------------------------------------------------------------ host glue

def affine_to_jac_np(p: np.ndarray) -> np.ndarray:
    """Host glue: (..., 2, 8) Montgomery affine -> (..., 3, 8) Jacobian
    with Z = 1 (pure numpy)."""
    one = np.broadcast_to(FP.one_mont.astype(np.int32), p[..., 0, :].shape)
    return np.concatenate([p, one[..., None, :]], axis=-2)
