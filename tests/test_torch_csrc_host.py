"""PyTorch port: the CUDA kernels' own arithmetic, compiled for the CPU.

Every `csrc/*.cu` file keeps its per-row work in a `__device__` row
function; built with `-DFTS_HOST_CHECK -include host_check.h` by the
system C++ compiler, it exposes a host loop over rows instead of the
kernel launch. These tests run that code here, where there is no nvcc
and no GPU, and hold it exactly against the plain torch versions and
hostmath. On the card, chip_smoke.py holds the compiled kernels against
the same plain versions."""

import ctypes
import os
import random
import shutil
import subprocess

import pytest
import torch

from fabric_token_sdk_tpu_torch.crypto import hostmath as hm
from fabric_token_sdk_tpu_torch.ops import curve as cv, field as fd, limbs as lb, stages as st

CSRC = os.path.join(os.path.dirname(__file__), "..", "fabric_token_sdk_tpu_torch", "csrc")
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRY = {
    "fp_ops": ("host_fp_ops", [_P, _P, _P, _I]),
    "g1_msm": ("host_g1_msm", [_P, _P, _P, _I, _I]),
    "g1_mul": ("host_g1_mul", [_P, _P, _P, _I]),
    "g1_addsub": ("host_g1_addsub", [_P, _P, _P, _I, _I]),
}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernels' row functions for the CPU")
    out = tmp_path_factory.mktemp("csrc_host")
    fns = {}
    for name, (symbol, argtypes) in ENTRY.items():
        so = str(out / f"{name}.so")
        subprocess.run(
            [cxx, "-x", "c++", "-std=c++17", "-O1", "-DFTS_HOST_CHECK",
             "-include", os.path.join(CSRC, "host_check.h"), "-shared", "-fPIC",
             "-o", so, os.path.join(CSRC, f"{name}.cu")],
            check=True, capture_output=True, timeout=300,
        )
        fn = getattr(ctypes.CDLL(so), symbol)
        fn.argtypes, fn.restype = argtypes, None
        fns[name] = fn
    return fns


def _pts(rng, n):
    return [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(n)]


def test_fp_ops_row_matches_plain(host):
    rng = random.Random(21)
    P = hm.P
    xs = [0, 1, P - 1, P, P + 1, 2 * P - 1] + [rng.randrange(2 * P) for _ in range(40)]
    ys = [2 * P - 1, P, 0, 1, P - 1, P + 3] + [rng.randrange(2 * P) for _ in range(40)]
    a = torch.from_numpy(lb.ints_to_words(xs))
    b = torch.from_numpy(lb.ints_to_words(ys))
    out = torch.empty((len(xs), 4, 8), dtype=torch.int32)
    host["fp_ops"](a.data_ptr(), b.data_ptr(), out.data_ptr(), len(xs))
    assert torch.equal(out, fd.fp_ops_plain(a, b))


@pytest.mark.parametrize("negate_b", [False, True])
def test_g1_addsub_row_matches_plain_and_hostmath(host, negate_b):
    rng = random.Random(22)
    p0, p1, p2 = _pts(rng, 3)
    A = [p0, p0, p0, None, None, p1, p2]
    B = [p0, hm.g1_neg(p0), p1, p2, None, None, p0]
    a = torch.from_numpy(cv.encode_points(A))
    b = torch.from_numpy(cv.encode_points(B))
    out = torch.empty_like(a)
    host["g1_addsub"](a.data_ptr(), b.data_ptr(), out.data_ptr(), len(A), int(negate_b))
    assert torch.equal(out, st.g1_addsub_plain(a, b, negate_b))
    want = [hm.g1_add(x, hm.g1_neg(y) if (negate_b and y) else y) for x, y in zip(A, B)]
    assert cv.decode_points(out) == want


def test_g1_mul_row_matches_plain_and_hostmath(host):
    rng = random.Random(23)
    pts = _pts(rng, 4) + [None]
    ks = [0, 1, hm.R - 1, rng.randrange(hm.R), 12345]
    p = torch.from_numpy(cv.encode_points(pts))
    k = torch.from_numpy(cv.encode_scalars(ks))
    out = torch.empty_like(p)
    host["g1_mul"](p.data_ptr(), k.data_ptr(), out.data_ptr(), len(ks))
    assert torch.equal(out, st.g1_mul_plain(p, k))
    assert cv.decode_points(out) == [hm.g1_mul(q, s) if q else None for q, s in zip(pts, ks)]


@pytest.mark.parametrize("nbases", [1, 3])
def test_g1_msm_row_matches_plain_and_hostmath(host, nbases):
    rng = random.Random(24 + nbases)
    bases = _pts(rng, nbases)
    table = cv.FixedBaseTable(bases)
    rows = [[0] * nbases, [1] * nbases, [hm.R - 1] * nbases] + [
        [rng.randrange(hm.R) for _ in range(nbases)] for _ in range(3)
    ]
    sc = torch.from_numpy(cv.encode_scalars([s for r in rows for s in r]).reshape(len(rows), nbases, 8))
    out = torch.empty((len(rows), 3, 8), dtype=torch.int32)
    host["g1_msm"](table.table.data_ptr(), sc.data_ptr(), out.data_ptr(), len(rows), nbases)
    assert torch.equal(out, st.g1_msm_plain(table.table, sc))
    assert cv.decode_points(out) == [hm.g1_multiexp(bases, r) for r in rows]
