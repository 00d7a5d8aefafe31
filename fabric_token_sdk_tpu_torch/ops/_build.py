"""Build the CUDA kernels at first use and bind them with ctypes.

Each `csrc/*.cu` file is one kernel with a plain C entry point. On first
use every source is compiled by `nvcc` for `sm_90a` into its own shared
library, all `nvcc` processes started together, under `_build/` in this
package (git-ignored). A library's file name carries a hash of its
source, the headers and the flags, so an edited source is rebuilt and a
stale library is never loaded. A missing `nvcc`, a failed build or a
failed launch raises: there is no fallback to the plain torch versions
for tensors on the card.

Each build and each load of an existing library is reported to the
dispatch ledger (`utils/devobs.py`) against the active program.

`Kernel` holds one entry point and its launch count. The count grows by
one per launch and nowhere else, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

import torch

from ..utils import devobs

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = (
    "g1_msm.cu", "g1_mul.cu", "g1_addsub.cu", "fp_ops.cu", "g1_to_affine.cu",
    "g2_mul.cu", "g2_add.cu", "g2_to_affine.cu", "miller.cu", "gt_product.cu",
    "final_exp.cu", "pairing_fused.cu",
)
HEADERS = ("bn254_fp.cuh", "bn254_tower.cuh", "bn254_ladder.cuh", "bn254_gt_coop.cuh",
           "bn254_gt_rows.cuh", "bn254_miller_row.cuh", "bn254_inv.cuh")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}  # source -> ptxas report of its last build
BUILD_SECONDS: Dict[str, float] = {}  # source -> wall seconds of its last build


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(source: str) -> str:
    h = hashlib.sha256()
    for name in (source,) + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{source[:-3]}-{h.hexdigest()[:12]}.so")


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no current library, in parallel,
    and load them all. Raises on any failed build."""
    with _lock:
        todo = [s for s in SOURCES if s not in _libs]
        if not todo:
            return dict(_libs)
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for src in todo:
            path = _lib_path(src)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", tmp, os.path.join(CSRC, src)]
            procs.append((src, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        start = time.perf_counter()

        def wait(src, proc):  # one thread a build: each records its own end
            BUILD_LOG[src] = proc.communicate()[0]
            BUILD_SECONDS[src] = time.perf_counter() - start

        waiters = [threading.Thread(target=wait, args=(src, proc)) for src, _, _, proc in procs]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        failed: List[str] = []
        for src, path, tmp, proc in procs:
            out = BUILD_LOG[src]
            if proc.returncode != 0:
                failed.append(f"{src}:\n{out}")
                if os.path.exists(tmp):
                    os.unlink(tmp)
                continue
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        built = {src for src, _, _, _ in procs}
        for src in todo:
            _libs[src] = ctypes.CDLL(_lib_path(src))
            # the dispatch ledger's compile and cache fields: a build is a
            # compile and a miss, a library _build/ already held a hit
            if src in built:
                devobs.note_compile(BUILD_SECONDS[src])
                devobs.note_cache("cache_misses")
            else:
                devobs.note_cache("cache_hits")
        return dict(_libs)


def build_probe(source: str) -> ctypes.CDLL:
    """Compile a measurement source of `csrc/` that no path launches (a
    `probe_*.cu`, left out of SOURCES) into its own library and load it;
    its ptxas report goes to BUILD_LOG. Raises on a failed build."""
    path = _lib_path(source)
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", tmp,
                               os.path.join(CSRC, source)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        BUILD_LOG[source] = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA probe build failed:\n{source}:\n{proc.stdout}")
        os.replace(tmp, path)
    return ctypes.CDLL(path)


class Kernel:
    """One CUDA entry point: `launch(device, *args)` builds on first use,
    calls it on the device's current stream, raises on a non-zero CUDA
    error, and counts the launch (under a lock: callers may launch from
    several threads)."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._count_lock = threading.Lock()
        self._fn: Optional[ctypes._CFuncPtr] = None

    def _bind(self):
        if self._fn is None:
            fn = getattr(build_all()[self.source], self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]  # + stream
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        fn = self._bind()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {rc}")
        with self._count_lock:
            self.launches += 1


_PTR, _INT = ctypes.c_void_p, ctypes.c_int

G1_MSM = Kernel("g1_msm", "g1_msm.cu", "fts_g1_msm", [_PTR, _PTR, _PTR, _INT, _INT])
G1_MSM_SELECT = Kernel("g1_msm_select", "g1_msm.cu", "fts_g1_msm_select",
                       [_PTR, _PTR, _PTR, _INT, _INT])
G1_MUL = Kernel("g1_mul", "g1_mul.cu", "fts_g1_mul", [_PTR, _PTR, _PTR, _INT])
G1_ADDSUB = Kernel("g1_addsub", "g1_addsub.cu", "fts_g1_addsub", [_PTR, _PTR, _PTR, _INT, _INT])
FP_OPS = Kernel("fp_ops", "fp_ops.cu", "fts_fp_ops", [_PTR, _PTR, _PTR, _INT])
G1_TO_AFFINE = Kernel("g1_to_affine", "g1_to_affine.cu", "fts_g1_to_affine", [_PTR, _PTR, _INT])
G2_MUL = Kernel("g2_mul", "g2_mul.cu", "fts_g2_mul", [_PTR, _PTR, _PTR, _INT])
G2_ADD = Kernel("g2_add", "g2_add.cu", "fts_g2_add", [_PTR, _PTR, _PTR, _INT])
G2_TO_AFFINE = Kernel("g2_to_affine", "g2_to_affine.cu", "fts_g2_to_affine", [_PTR, _PTR, _INT])
MILLER = Kernel("miller", "miller.cu", "fts_miller", [_PTR, _PTR, _PTR, _INT])
GT_PRODUCT = Kernel("gt_product", "gt_product.cu", "fts_gt_product", [_PTR, _PTR, _INT, _INT])
FINAL_EXP = Kernel("final_exp", "final_exp.cu", "fts_final_exp", [_PTR, _PTR, _INT])
PAIRING_PRODUCT = Kernel("pairing_product", "pairing_fused.cu", "fts_pairing_product",
                         [_PTR, _PTR, _PTR, _PTR, _INT, _INT])
GT_PRODUCT_FINAL_EXP = Kernel("gt_product_final_exp", "pairing_fused.cu",
                              "fts_gt_product_final_exp", [_PTR, _PTR, _INT, _INT])

# the kernels of the verify path: the 1-in/1-out transfer runs the first
# three, a transfer with a range proof all ten
PATH_KERNELS = (
    G1_MSM, G1_MUL, G1_ADDSUB, G1_TO_AFFINE, G2_MUL, G2_ADD, G2_TO_AFFINE,
    MILLER, GT_PRODUCT, FINAL_EXP,
)
WF_KERNELS = PATH_KERNELS[:3]
# the kernels of the prove path: every fixed-base multiexp of the prover
# takes the select form (its openings are secret); the 1-in/1-out prove
# runs the first alone, a transfer with a range proof all nine
PROVE_KERNELS = (
    G1_MSM_SELECT, G1_MUL, G1_ADDSUB, G2_MUL, G2_ADD, G2_TO_AFFINE, MILLER, GT_PRODUCT,
    FINAL_EXP,
)
# the fused pairing product of the mesh plane (B16) and of the fused
# entry point `pairing.pairing_product` (B17): the whole product a row,
# and the tail after the Miller values were gathered over mp
MESH_KERNELS = (PAIRING_PRODUCT, GT_PRODUCT_FINAL_EXP)
ALL_KERNELS = PATH_KERNELS + (G1_MSM_SELECT,) + MESH_KERNELS


def check_cuda_tensor(name: str, t: torch.Tensor, shape, dtype=torch.int32) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
