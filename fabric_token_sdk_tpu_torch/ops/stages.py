"""Row-batched stages of the verify and prove planes: CUDA kernels and plain versions.

Counterpart of `fabric_token_sdk_tpu/ops/stages.py`. Each `g1_*_rows`
function takes int32 tensors of flat rows and issues ONE launch over all
N rows; the reference's ROW_TILE padding existed to keep XLA compiles
small and does not carry over.

Where the tensors lie decides the route: on a CUDA device the wrapper
launches its hand-written kernel (`csrc/`, built by `ops/_build.py`) or
raises; on the CPU it runs the kernel's plain torch version, defined
beside it here. `chip_smoke.py` holds each kernel against its plain
version on the card. Either route runs inside a dispatch frame of the
ledger (`utils/devobs.py`) named by the kernel: one dispatch a launch,
its rows, its plane, and on the card its time by CUDA events.

Layouts: G1 points (N, 3, 8) Montgomery Jacobian words, G1 affine
(N, 2, 8); G2 points (N, 3, 2, 8), G2 affine (N, 2, 2, 8); Fp12/GT
(N, 6, 2, 8); scalars canonical words (N, 8); fixed-base tables
(nbases*64, 16, 3, 8). Outputs are canonical.
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve as cv, curve2 as cv2, limbs as lb, pairing as pr, tower as tw
from ._build import (
    FINAL_EXP, G1_ADDSUB, G1_MSM, G1_MSM_SELECT, G1_MUL, G1_TO_AFFINE, G2_ADD, G2_MUL,
    G2_TO_AFFINE, GT_PRODUCT, GT_PRODUCT_FINAL_EXP, MILLER, PAIRING_PRODUCT, check_cuda_tensor,
)
from .field import FP, half_to_words, words_to_half
from ..utils import devobs, metrics as mx, sysmon


def _route(kernel_name: str, *tensors: torch.Tensor) -> bool:
    """True to launch the CUDA kernel, False for the plain version; raises
    on an empty batch or on tensors spread over devices. The caller then
    runs either inside a `devobs.dispatch` frame named by its kernel, on
    the tensors' device."""
    n = tensors[-1].shape[0]
    if n == 0:
        raise ValueError(f"{kernel_name}: empty row batch (caller must guard)")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel_name}: tensors on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    mx.counter("stages.calls").inc()
    mx.counter("stages.rows").inc(n)
    sysmon.sample_stages()  # throttled: the stages.mem.* high-water gauges
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{kernel_name}: unsupported device {dev}")


# ------------------------------------------------------------------ g1_msm

def g1_msm_plain(table: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Plain version of the g1_msm kernel."""
    return cv.from_half3(cv.msm(table, scalars))


def g1_msm_select_plain(table: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Plain version of the g1_msm_select kernel: the one-hot select."""
    return cv.from_half3(cv.msm(table, scalars, select=True))


def _msm_rows(kernel, plain, table: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    nbases = scalars.shape[1]
    if table.shape[0] != nbases * cv.DIGITS_PER_SCALAR:
        raise ValueError(f"{kernel.name}: table of {table.shape[0] // cv.DIGITS_PER_SCALAR} "
                         f"bases for {nbases} scalars a row")
    n = scalars.shape[0]
    card = _route(kernel.name, table, scalars)
    with devobs.dispatch(kernel.name, rows=n, device=scalars.device):
        if not card:
            return plain(table, scalars)
        check_cuda_tensor(f"{kernel.name} table", table,
                          (nbases * cv.DIGITS_PER_SCALAR, cv.WINDOW_SIZE, 3, lb.NWORDS))
        check_cuda_tensor(f"{kernel.name} scalars", scalars, (n, nbases, lb.NWORDS))
        out = torch.empty((n, 3, lb.NWORDS), dtype=torch.int32, device=scalars.device)
        with mx.span("stages.run", kernel=kernel.name, rows=n):
            kernel.launch(scalars.device, table.data_ptr(), scalars.data_ptr(), out.data_ptr(),
                          n, nbases)
    return out


def g1_msm_rows(table: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """(N, nbases, 8) canonical scalars x fixed-base table -> (N, 3, 8).
    The window entry is gathered by the digit: public scalars only."""
    return _msm_rows(G1_MSM, g1_msm_plain, table, scalars)


def g1_msm_select_rows(table: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """As `g1_msm_rows`, for secret scalars: every window reads all 16
    entries and keeps the digit's by a mask, so no load and no branch
    depends on a scalar."""
    return _msm_rows(G1_MSM_SELECT, g1_msm_select_plain, table, scalars)


# ------------------------------------------------------------------ g1_mul

def g1_mul_plain(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Plain version of the g1_mul kernel."""
    return cv.from_half3(cv.scalar_mul(cv.to_half3(points), scalars))


def g1_mul_rows(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Variable-base scalar mul: (N, 3, 8) x (N, 8) canonical -> (N, 3, 8)."""
    n = scalars.shape[0]
    card = _route("g1_mul", points, scalars)
    with devobs.dispatch("g1_mul", rows=n, device=points.device):
        if not card:
            return g1_mul_plain(points, scalars)
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
    n = a.shape[0]
    card = _route("g1_addsub", a, b)
    with devobs.dispatch("g1_addsub", rows=n, device=a.device):
        if not card:
            return g1_addsub_plain(a, b, negate_b)
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


# ------------------------------------------------------------------ g1_to_affine

def g1_to_affine_plain(points: torch.Tensor) -> torch.Tensor:
    """Plain version of the g1_to_affine kernel."""
    x, y, z = cv.to_half3(points)
    zi = FP.inv(z)
    zi2 = FP.mul(zi, zi)
    ax, ay = FP.mul(torch.stack([x, y], dim=-1), zi2.unsqueeze(-1)).unbind(-1)
    return half_to_words(FP.canon(torch.stack([ax, FP.mul(ay, zi)], dim=-1)))


def g1_to_affine_rows(points: torch.Tensor) -> torch.Tensor:
    """(N, 3, 8) Jacobian -> (N, 2, 8) affine; infinity -> (0, 0)."""
    n = points.shape[0]
    card = _route("g1_to_affine", points)
    with devobs.dispatch("g1_to_affine", rows=n, device=points.device):
        if not card:
            return g1_to_affine_plain(points)
        check_cuda_tensor("g1_to_affine points", points, (n, 3, lb.NWORDS))
        out = torch.empty((n, 2, lb.NWORDS), dtype=torch.int32, device=points.device)
        with mx.span("stages.run", kernel="g1_to_affine", rows=n):
            G1_TO_AFFINE.launch(points.device, points.data_ptr(), out.data_ptr(), n)
    return out


# ------------------------------------------------------------------ g2

_G2_SHAPE = (3, 2, lb.NWORDS)


def g2_mul_plain(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Plain version of the g2_mul kernel."""
    return cv2.from_half3(cv2.scalar_mul(cv2.to_half3(points), scalars))


def g2_mul_rows(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """[k]Q on G2: (N, 3, 2, 8) x (N, 8) canonical -> (N, 3, 2, 8)."""
    n = scalars.shape[0]
    card = _route("g2_mul", points, scalars)
    with devobs.dispatch("g2_mul", rows=n, device=points.device):
        if not card:
            return g2_mul_plain(points, scalars)
        check_cuda_tensor("g2_mul points", points, (n,) + _G2_SHAPE)
        check_cuda_tensor("g2_mul scalars", scalars, (n, lb.NWORDS))
        out = torch.empty((n,) + _G2_SHAPE, dtype=torch.int32, device=points.device)
        with mx.span("stages.run", kernel="g2_mul", rows=n):
            G2_MUL.launch(points.device, points.data_ptr(), scalars.data_ptr(), out.data_ptr(), n)
    return out


def g2_add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the g2_add kernel."""
    return cv2.from_half3(cv2.add(cv2.to_half3(a), cv2.to_half3(b)))


def g2_add_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b on (N, 3, 2, 8) G2 Jacobian rows."""
    n = a.shape[0]
    card = _route("g2_add", a, b)
    with devobs.dispatch("g2_add", rows=n, device=a.device):
        if not card:
            return g2_add_plain(a, b)
        check_cuda_tensor("g2_add a", a, (n,) + _G2_SHAPE)
        check_cuda_tensor("g2_add b", b, (n,) + _G2_SHAPE)
        out = torch.empty((n,) + _G2_SHAPE, dtype=torch.int32, device=a.device)
        with mx.span("stages.run", kernel="g2_add", rows=n):
            G2_ADD.launch(a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), n)
    return out


def g2_to_affine_plain(points: torch.Tensor) -> torch.Tensor:
    """Plain version of the g2_to_affine kernel."""
    ax, ay = cv2.to_affine(cv2.to_half3(points))
    return half_to_words(FP.canon(torch.stack([ax, ay], dim=-2)))


def g2_to_affine_rows(points: torch.Tensor) -> torch.Tensor:
    """(N, 3, 2, 8) Jacobian -> (N, 2, 2, 8) affine; infinity -> (0, 0)."""
    n = points.shape[0]
    card = _route("g2_to_affine", points)
    with devobs.dispatch("g2_to_affine", rows=n, device=points.device):
        if not card:
            return g2_to_affine_plain(points)
        check_cuda_tensor("g2_to_affine points", points, (n,) + _G2_SHAPE)
        out = torch.empty((n, 2, 2, lb.NWORDS), dtype=torch.int32, device=points.device)
        with mx.span("stages.run", kernel="g2_to_affine", rows=n):
            G2_TO_AFFINE.launch(points.device, points.data_ptr(), out.data_ptr(), n)
    return out


def g2_tree_sum_rows(terms: torch.Tensor) -> torch.Tensor:
    """Per-row sum of k G2 terms, (N, k, 3, 2, 8) -> (N, 3, 2, 8): a host
    fold, each level one g2_add_rows over the flattened pairs (legs i
    and i + k/2 first, as the reference)."""
    while terms.shape[1] > 1:
        n, k = terms.shape[0], terms.shape[1]
        half = k // 2
        rest = terms[:, 2 * half :]
        summed = g2_add_rows(
            terms[:, :half].reshape((-1,) + _G2_SHAPE).contiguous(),
            terms[:, half : 2 * half].reshape((-1,) + _G2_SHAPE).contiguous(),
        ).reshape((n, half) + _G2_SHAPE)
        terms = torch.cat([summed, rest], dim=1) if rest.shape[1] else summed
    return terms[:, 0]


# ------------------------------------------------------------------ pairing

_FP12_SHAPE = (6, 2, lb.NWORDS)


def miller_plain(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Plain version of the miller kernel."""
    p, q = words_to_half(P), words_to_half(Q)  # (16, N, 2), (16, N, 2, 2)
    f = pr.miller_loop(p[..., 0], p[..., 1], q[..., 0, :], q[..., 1, :])
    return half_to_words(FP.canon(f))


def miller_rows(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Miller loop a leg: G1 affine (N, 2, 8), G2 affine (N, 2, 2, 8)
    -> (N, 6, 2, 8). No infinity handling: (0, 0) legs run as given."""
    n = P.shape[0]
    card = _route("miller", P, Q)
    with devobs.dispatch("miller", rows=n, device=P.device):
        if not card:
            return miller_plain(P, Q)
        check_cuda_tensor("miller P", P, (n, 2, lb.NWORDS))
        check_cuda_tensor("miller Q", Q, (n, 2, 2, lb.NWORDS))
        out = torch.empty((n,) + _FP12_SHAPE, dtype=torch.int32, device=P.device)
        with mx.span("stages.run", kernel="miller", rows=n):
            MILLER.launch(P.device, P.data_ptr(), Q.data_ptr(), out.data_ptr(), n)
    return out


def gt_product_plain(f: torch.Tensor) -> torch.Tensor:
    """Plain version of the gt_product kernel."""
    return half_to_words(FP.canon(pr.product_rows(words_to_half(f))))


def gt_product_rows(f: torch.Tensor) -> torch.Tensor:
    """Per-row product of K Fp12 values: (N, K, 6, 2, 8) -> (N, 6, 2, 8)."""
    n, k = f.shape[0], f.shape[1]
    card = _route("gt_product", f)
    with devobs.dispatch("gt_product", rows=n, device=f.device):
        if not card:
            return gt_product_plain(f)
        check_cuda_tensor("gt_product f", f, (n, k) + _FP12_SHAPE)
        out = torch.empty((n,) + _FP12_SHAPE, dtype=torch.int32, device=f.device)
        with mx.span("stages.run", kernel="gt_product", rows=n):
            GT_PRODUCT.launch(f.device, f.data_ptr(), out.data_ptr(), n, k)
    return out


def final_exp_plain(f: torch.Tensor) -> torch.Tensor:
    """Plain version of the final_exp kernel."""
    return half_to_words(FP.canon(pr.final_exp(words_to_half(f))))


def final_exp_rows(f: torch.Tensor) -> torch.Tensor:
    """f^((p^12-1)/r) a row: (N, 6, 2, 8) -> (N, 6, 2, 8) GT."""
    n = f.shape[0]
    card = _route("final_exp", f)
    with devobs.dispatch("final_exp", rows=n, device=f.device):
        if not card:
            return final_exp_plain(f)
        check_cuda_tensor("final_exp f", f, (n,) + _FP12_SHAPE)
        out = torch.empty((n,) + _FP12_SHAPE, dtype=torch.int32, device=f.device)
        with mx.span("stages.run", kernel="final_exp", rows=n):
            FINAL_EXP.launch(f.device, f.data_ptr(), out.data_ptr(), n)
    return out


# ------------------------------------------------------------------ fused pairing

def _mask_one(f: torch.Tensor, inf_mask) -> torch.Tensor:
    """Miller values (..., 6, 2, 8) with the legs of `inf_mask` (bool,
    the leading shape) set to GT one."""
    if inf_mask is None:
        return f
    mask = torch.as_tensor(np.asarray(inf_mask, dtype=bool)).to(f.device)
    one = torch.from_numpy(tw.fp12_one_np()).to(f.device)
    return torch.where(mask.reshape(mask.shape + (1, 1, 1)), one, f)


def pairing_product_plain(P: torch.Tensor, Q: torch.Tensor, inf_mask=None) -> torch.Tensor:
    """Plain version of the pairing_product kernel: the staged sequence
    miller -> gt_product -> final_exp of the plain versions."""
    B, K = P.shape[0], P.shape[1]
    f = miller_plain(P.reshape(B * K, 2, lb.NWORDS), Q.reshape(B * K, 2, 2, lb.NWORDS))
    f = _mask_one(f.reshape((B, K) + _FP12_SHAPE), inf_mask)
    return final_exp_plain(gt_product_plain(f))


def gt_product_final_exp_plain(f: torch.Tensor) -> torch.Tensor:
    """Plain version of the gt_product_final_exp kernel."""
    return final_exp_plain(gt_product_plain(f))


def pairing_product_rows(P: torch.Tensor, Q: torch.Tensor, inf_mask=None) -> torch.Tensor:
    """prod_k e(P_k, Q_k) a row in one launch: G1 affine (N, K, 2, 8), G2
    affine (N, K, 2, 2, 8), inf_mask (N, K) bool or None (True legs give
    GT one) -> (N, 6, 2, 8) canonical GT."""
    n, k = P.shape[0], P.shape[1]
    mask = None
    if inf_mask is not None:
        mask = torch.as_tensor(np.asarray(inf_mask, dtype=bool)).to(P.device, torch.uint8)
        mask = mask.reshape(n, k).contiguous()
    card = _route("pairing_product", P, Q, *(() if mask is None else (mask,)))
    with devobs.dispatch("pairing_product", rows=n, device=P.device):
        if not card:
            return pairing_product_plain(P, Q, None if mask is None else mask.bool())
        check_cuda_tensor("pairing_product P", P, (n, k, 2, lb.NWORDS))
        check_cuda_tensor("pairing_product Q", Q, (n, k, 2, 2, lb.NWORDS))
        out = torch.empty((n,) + _FP12_SHAPE, dtype=torch.int32, device=P.device)
        with mx.span("stages.run", kernel="pairing_product", rows=n):
            PAIRING_PRODUCT.launch(P.device, P.data_ptr(), Q.data_ptr(),
                                   None if mask is None else mask.data_ptr(), out.data_ptr(), n, k)
    return out


def gt_product_final_exp_rows(f: torch.Tensor) -> torch.Tensor:
    """The product of K Miller values and one final exponentiation a row,
    in one launch: (N, K, 6, 2, 8) -> (N, 6, 2, 8) canonical GT."""
    n, k = f.shape[0], f.shape[1]
    card = _route("gt_product_final_exp", f)
    with devobs.dispatch("gt_product_final_exp", rows=n, device=f.device):
        if not card:
            return gt_product_final_exp_plain(f)
        check_cuda_tensor("gt_product_final_exp f", f, (n, k) + _FP12_SHAPE)
        out = torch.empty((n,) + _FP12_SHAPE, dtype=torch.int32, device=f.device)
        with mx.span("stages.run", kernel="gt_product_final_exp", rows=n):
            GT_PRODUCT_FINAL_EXP.launch(f.device, f.data_ptr(), out.data_ptr(), n, k)
    return out


# ------------------------------------------------------------------ host glue

def affine_to_jac_np(p: np.ndarray) -> np.ndarray:
    """Host glue: (..., 2, 8) Montgomery affine -> (..., 3, 8) Jacobian
    with Z = 1 (pure numpy)."""
    one = np.broadcast_to(FP.one_mont.astype(np.int32), p[..., 0, :].shape)
    return np.concatenate([p, one[..., None, :]], axis=-2)
