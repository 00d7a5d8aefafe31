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
from fabric_token_sdk_tpu_torch.ops import curve as cv, curve2 as cv2, field as fd, limbs as lb
from fabric_token_sdk_tpu_torch.ops import pairing as pr, stages as st, tower as tw

# The plain versions are many small tensor ops: one intra-op thread runs
# them faster than several and leaves the other test workers their cores.
torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(__file__), "..", "fabric_token_sdk_tpu_torch", "csrc")
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRY = {  # name: (source in csrc/, symbol, argtypes)
    "fp_ops": ("fp_ops", "host_fp_ops", [_P, _P, _P, _I]),
    "g1_msm": ("g1_msm", "host_g1_msm", [_P, _P, _P, _I, _I]),
    "g1_msm_select": ("g1_msm", "host_g1_msm_select", [_P, _P, _P, _I, _I]),
    "g1_mul": ("g1_mul", "host_g1_mul", [_P, _P, _P, _I]),
    "g1_addsub": ("g1_addsub", "host_g1_addsub", [_P, _P, _P, _I, _I]),
    "g1_to_affine": ("g1_to_affine", "host_g1_to_affine", [_P, _P, _I]),
    "g2_mul": ("g2_mul", "host_g2_mul", [_P, _P, _P, _I]),
    "g2_add": ("g2_add", "host_g2_add", [_P, _P, _P, _I]),
    "g2_to_affine": ("g2_to_affine", "host_g2_to_affine", [_P, _P, _I]),
    "miller": ("miller", "host_miller", [_P, _P, _P, _I]),
    "gt_product": ("gt_product", "host_gt_product", [_P, _P, _I, _I]),
    "final_exp": ("final_exp", "host_final_exp", [_P, _P, _I]),
    "pairing_product": ("pairing_fused", "host_pairing_product", [_P, _P, _P, _P, _I, _I]),
    "gt_product_final_exp": ("pairing_fused", "host_gt_product_final_exp", [_P, _P, _I, _I]),
}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernels' row functions for the CPU")
    out = tmp_path_factory.mktemp("csrc_host")
    procs = {}
    for src in {e[0] for e in ENTRY.values()}:  # all sources compile at once
        procs[src] = subprocess.Popen(
            [cxx, "-x", "c++", "-std=c++17", "-O1", "-DFTS_HOST_CHECK",
             "-include", os.path.join(CSRC, "host_check.h"), "-shared", "-fPIC",
             "-o", str(out / f"{src}.so"), os.path.join(CSRC, f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    for src, proc in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{src}.cu: {log}"
    fns = {}
    for name, (src, symbol, argtypes) in ENTRY.items():
        fn = getattr(ctypes.CDLL(str(out / f"{src}.so")), symbol)
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


@pytest.mark.parametrize("nbases", [1, 2, 3])
def test_g1_msm_select_row_matches_plain_and_hostmath(host, nbases):
    """The select form on the scalar edges 0, 1, r-1, all-15 digits
    (2^256 - 1), a single non-zero window and the digits 0..15 in turn
    (0x0123...f, words not reduced: the kernels read them as given),
    against its plain version, the gather kernel's and hostmath."""
    rng = random.Random(34 + nbases)
    bases = _pts(rng, nbases)
    table = cv.FixedBaseTable(bases)
    ks = [0, 1, hm.R - 1, (1 << 256) - 1, 9 << (4 * 21), int("fedcba9876543210" * 4, 16)]
    rows = [[k] * nbases for k in ks] + [[rng.randrange(hm.R) for _ in range(nbases)]]
    words = lb.ints_to_words([s for r in rows for s in r]).reshape(len(rows), nbases, 8)
    sc = torch.from_numpy(words)
    out = torch.empty((len(rows), 3, 8), dtype=torch.int32)
    host["g1_msm_select"](table.table.data_ptr(), sc.data_ptr(), out.data_ptr(), len(rows), nbases)
    assert torch.equal(out, st.g1_msm_select_plain(table.table, sc))
    gathered = torch.empty_like(out)
    host["g1_msm"](table.table.data_ptr(), sc.data_ptr(), gathered.data_ptr(), len(rows), nbases)
    assert torch.equal(out, gathered)
    assert cv.decode_points(out) == [hm.g1_multiexp(bases, [s % hm.R for s in r]) for r in rows]


def _g2pts(rng, n):
    return [hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(n)]


def test_g1_to_affine_row_matches_plain_and_hostmath(host):
    pts = _pts(random.Random(25), 3) + [None]
    p = torch.from_numpy(cv.encode_points(pts))
    out = torch.empty((len(pts), 2, 8), dtype=torch.int32)
    host["g1_to_affine"](p.data_ptr(), out.data_ptr(), len(pts))
    assert torch.equal(out, st.g1_to_affine_plain(p))
    assert torch.equal(out, torch.from_numpy(pr.encode_g1(pts)))  # infinity -> (0, 0)


def test_g2_add_and_to_affine_rows_match_plain_and_hostmath(host):
    q0, q1, q2 = _g2pts(random.Random(26), 3)
    A = [q0, q0, q0, None, None, q1]
    B = [q0, hm.g2_neg(q0), q1, q2, None, None]
    a = torch.from_numpy(cv2.encode_points(A))
    b = torch.from_numpy(cv2.encode_points(B))
    out = torch.empty_like(a)
    host["g2_add"](a.data_ptr(), b.data_ptr(), out.data_ptr(), len(A))
    assert torch.equal(out, st.g2_add_plain(a, b))
    want = [hm.g2_add(x, y) for x, y in zip(A, B)]
    assert cv2.decode_points(out) == want
    aff = torch.empty((len(A), 2, 2, 8), dtype=torch.int32)
    host["g2_to_affine"](out.data_ptr(), aff.data_ptr(), len(A))
    assert torch.equal(aff, st.g2_to_affine_plain(out))
    assert torch.equal(aff, torch.from_numpy(pr.encode_g2(want)))


def test_g2_mul_row_matches_plain_and_hostmath(host):
    rng = random.Random(27)
    pts = _g2pts(rng, 3) + [None]
    ks = [0, 1, hm.R - 1, rng.randrange(hm.R)]
    p = torch.from_numpy(cv2.encode_points(pts))
    k = torch.from_numpy(cv.encode_scalars(ks))
    out = torch.empty_like(p)
    host["g2_mul"](p.data_ptr(), k.data_ptr(), out.data_ptr(), len(ks))
    assert torch.equal(out, st.g2_mul_plain(p, k))
    assert cv2.decode_points(out) == [hm.g2_mul(q, s) if q else None for q, s in zip(pts, ks)]


def test_pairing_rows_match_plain_and_hostmath(host):
    """miller (with a (0, 0) leg), gt_product over K = 3 and final_exp:
    Miller values equal the plain version's exactly; after the final
    exponentiation the finite legs equal hostmath's pairing."""
    rng = random.Random(28)
    Ps = _pts(rng, 2) + [None]
    Qs = _g2pts(rng, 3)
    P = torch.from_numpy(pr.encode_g1(Ps))
    Q = torch.from_numpy(pr.encode_g2(Qs))
    f = torch.empty((3, 6, 2, 8), dtype=torch.int32)
    host["miller"](P.data_ptr(), Q.data_ptr(), f.data_ptr(), 3)
    assert torch.equal(f, st.miller_plain(P, Q))
    g = torch.empty_like(f)
    host["final_exp"](f.data_ptr(), g.data_ptr(), 3)
    assert torch.equal(g, st.final_exp_plain(f))
    assert tw.decode_fp12(g)[:2] == [hm.pairing(p, q) for p, q in zip(Ps[:2], Qs[:2])]
    ff = f.reshape(1, 3, 6, 2, 8).contiguous()
    h = torch.empty((1, 6, 2, 8), dtype=torch.int32)
    host["gt_product"](ff.data_ptr(), h.data_ptr(), 1, 3)
    assert torch.equal(h, st.gt_product_plain(ff))
    vals = tw.decode_fp12(f)
    assert tw.decode_fp12(h)[0] == hm.fp12_mul(hm.fp12_mul(vals[0], vals[1]), vals[2])


def test_pairing_fused_rows_match_plain_and_hostmath(host):
    """Both modes of pairing_fused.cu on 3 rows of K = 2, the last leg
    of row 1 a (0, 0) leg: with no mask, with that leg masked, and the
    tail on the Miller values of the miller row function, all equal
    `pairing_product_plain` (the staged plain sequence) exactly; the
    finite rows equal hostmath's pairing products."""
    rng = random.Random(29)
    p = _pts(rng, 5)
    q = _g2pts(rng, 6)
    Ps = [[p[0], p[1]], [p[2], None], [p[3], p[4]]]
    Qs = [[q[0], q[1]], [q[2], q[3]], [q[4], q[5]]]
    P = torch.from_numpy(pr.encode_g1([x for r in Ps for x in r])).reshape(3, 2, 2, 8)
    Q = torch.from_numpy(pr.encode_g2([x for r in Qs for x in r])).reshape(3, 2, 2, 2, 8)
    want = st.pairing_product_plain(P, Q)
    out = torch.empty((3, 6, 2, 8), dtype=torch.int32)
    host["pairing_product"](P.data_ptr(), Q.data_ptr(), None, out.data_ptr(), 3, 2)
    assert torch.equal(out, want)
    mask = torch.zeros((3, 2), dtype=torch.uint8)
    mask[1, 1] = 1
    masked = torch.empty_like(out)
    host["pairing_product"](P.data_ptr(), Q.data_ptr(), mask.data_ptr(), masked.data_ptr(), 3, 2)
    assert torch.equal(masked, want)
    f = torch.empty((6, 6, 2, 8), dtype=torch.int32)
    host["miller"](P.data_ptr(), Q.data_ptr(), f.data_ptr(), 6)
    tail = torch.empty_like(out)
    host["gt_product_final_exp"](f.data_ptr(), tail.data_ptr(), 3, 2)
    assert torch.equal(tail, want)
    assert tw.decode_fp12(out) == [
        hm.pairing_product([(a, b) for a, b in zip(pr_, qr) if a is not None])
        for pr_, qr in zip(Ps, Qs)]


@pytest.mark.parametrize("k", [1, 3, 4])
def test_pairing_fused_rows_other_leg_counts(host, k):
    """K = 1, 3, 4 (with a masked leg at K = 4) against hostmath, and the
    tail over K gathered Miller values against the fused mode."""
    rng = random.Random(30 + k)
    p, q = _pts(rng, 2 * k), _g2pts(rng, 2 * k)
    P = torch.from_numpy(pr.encode_g1(p)).reshape(2, k, 2, 8)
    Q = torch.from_numpy(pr.encode_g2(q)).reshape(2, k, 2, 2, 8)
    mask = torch.zeros((2, k), dtype=torch.uint8)
    if k == 4:
        mask[0, 2] = 1
    out = torch.empty((2, 6, 2, 8), dtype=torch.int32)
    host["pairing_product"](P.data_ptr(), Q.data_ptr(), mask.data_ptr(), out.data_ptr(), 2, k)
    legs = [[(p[r * k + j], q[r * k + j]) for j in range(k) if not mask[r, j]] for r in range(2)]
    assert tw.decode_fp12(out) == [hm.pairing_product(row) for row in legs]
    f = torch.empty((2 * k, 6, 2, 8), dtype=torch.int32)
    host["miller"](P.data_ptr(), Q.data_ptr(), f.data_ptr(), 2 * k)
    f = f.reshape(2, k, 6, 2, 8)
    f[mask.bool()] = torch.from_numpy(tw.fp12_one_np())
    tail = torch.empty_like(out)
    host["gt_product_final_exp"](f.contiguous().data_ptr(), tail.data_ptr(), 2, k)
    assert torch.equal(tail, out)
