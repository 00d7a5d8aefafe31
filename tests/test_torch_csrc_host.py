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
import re
import shutil
import subprocess

import numpy as np
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
ENTRY = {  # name: (source in csrc/, symbol, argtypes[, restype])
    "fp_ops": ("fp_ops", "host_fp_ops", [_P, _P, _P, _I]),
    "g1_msm": ("g1_msm", "host_g1_msm", [_P, _P, _P, _I, _I]),
    "g1_msm_select": ("g1_msm", "host_g1_msm_select", [_P, _P, _P, _I, _I]),
    "g1_msm_lanes": ("g1_msm", "host_g1_msm_lanes", [_P, _P, _P, _I, _I, _I, _I], _I),
    "g1_msm_config": ("g1_msm", "fts_g1_msm_config", [_P], _I),
    "g1_mul": ("g1_mul", "host_g1_mul", [_P, _P, _P, _I]),
    "g1_mul_lanes": ("g1_mul", "host_g1_mul_lanes", [_P, _P, _P, _I, _I]),
    "ladder_field": ("g1_mul", "host_ladder_field", [_P, _P, _P, _I, _I]),
    "g1_addsub": ("g1_addsub", "host_g1_addsub", [_P, _P, _P, _I, _I]),
    "g1_addsub_lanes": ("g1_addsub", "host_g1_addsub_lanes", [_P, _P, _P, _I, _I, _I], _I),
    "g1_addsub_config": ("g1_addsub", "fts_g1_addsub_config", [_P, _P], _I),
    "g1_to_affine": ("g1_to_affine", "host_g1_to_affine", [_P, _P, _I]),
    "fp_inv": ("g1_to_affine", "host_fp_inv", [_P, _P, _I]),
    "g2_mul": ("g2_mul", "host_g2_mul", [_P, _P, _P, _I]),
    "g2_mul_lanes": ("g2_mul", "host_g2_mul_lanes", [_P, _P, _P, _I, _I]),
    "g2_add": ("g2_add", "host_g2_add", [_P, _P, _P, _I]),
    "g2_add_lanes": ("g2_add", "host_g2_add_lanes", [_P, _P, _P, _I, _I], _I),
    "g2_add_config": ("g2_add", "fts_g2_add_config", [_P, _P, _P], _I),
    "g2_to_affine": ("g2_to_affine", "host_g2_to_affine", [_P, _P, _I]),
    "miller": ("miller", "host_miller", [_P, _P, _P, _I]),
    "miller_lanes": ("miller", "host_miller_lanes", [_P, _P, _P, _I, _I], _I),
    "miller_config": ("miller", "fts_miller_config", [_P, _P], _I),
    "gt_product": ("gt_product", "host_gt_product", [_P, _P, _I, _I]),
    "gt_product_lanes": ("gt_product", "host_gt_product_lanes", [_P, _P, _I, _I, _I], _I),
    "gt_product_config": ("gt_product", "fts_gt_product_config", [_P, _P], _I),
    "final_exp": ("final_exp", "host_final_exp", [_P, _P, _I]),
    "final_exp_lanes": ("final_exp", "host_final_exp_lanes", [_P, _P, _I, _I], _I),
    "final_exp_config": ("final_exp", "fts_final_exp_config", [_P, _P], _I),
    "pairing_product": ("pairing_fused", "host_pairing_product", [_P, _P, _P, _P, _I, _I]),
    "gt_product_final_exp": ("pairing_fused", "host_gt_product_final_exp", [_P, _P, _I, _I]),
    "pairing_product_lanes": ("pairing_fused", "host_pairing_product_lanes",
                              [_P, _P, _P, _P, _I, _I, _I, _I], _I),
    "gt_product_final_exp_lanes": ("pairing_fused", "host_gt_product_final_exp_lanes",
                                   [_P, _P, _I, _I, _I], _I),
    "pairing_fused_config": ("pairing_fused", "fts_pairing_fused_config", [_I, _P], _I),
}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernels' row functions for the CPU")
    out = tmp_path_factory.mktemp("csrc_host")
    procs = {}
    for src in sorted({e[0] for e in ENTRY.values()}):  # all sources compile at once
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
    for name, (src, symbol, argtypes, *restype) in ENTRY.items():
        fn = getattr(ctypes.CDLL(str(out / f"{src}.so")), symbol)
        fn.argtypes, fn.restype = argtypes, (restype or [None])[0]
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


# scalar edges of the window ladder: 0, 1, r-1, every digit 15 below a
# zero top digit, a single digit, and random scalars
LADDER_KS = [0, 1, hm.R - 1, 16 ** 63 - 1, 12345]


def _lift(words: torch.Tensor, rows) -> torch.Tensor:
    """Every 8-word value of the given rows moved from [0, p) into [p, 2p):
    the same points in the redundant domain."""
    out = words.clone()
    flat = out.view(out.shape[0], -1, 8)
    for r in rows:
        for c in range(flat.shape[1]):
            v = lb.words_to_int(flat[r, c].numpy())
            if v < hm.P:
                flat[r, c] = torch.from_numpy(lb.int_to_words(v + hm.P))
    return out


@pytest.fixture(scope="module")
def ladder_rows():
    """Rows for both ladders, their plain outputs and the host answers:
    the scalar edges, random scalars, a point at infinity, and rows with
    every coordinate in [p, 2p)."""
    rng = random.Random(23)
    rows = {}
    for name, enc, dec, mul, gen in (("g1", cv.encode_points, cv.decode_points, hm.g1_mul, _pts),
                                     ("g2", cv2.encode_points, cv2.decode_points, hm.g2_mul, _g2pts)):
        pts = gen(rng, 5) + [None]
        ks = LADDER_KS + [rng.randrange(hm.R)]
        p = _lift(torch.from_numpy(enc(pts)), [1, 4, 5])
        k = torch.from_numpy(cv.encode_scalars(ks))
        plain = (st.g1_mul_plain if name == "g1" else st.g2_mul_plain)(p, k)
        rows[name] = (p, k, plain, [mul(q, s) if q else None for q, s in zip(pts, ks)], dec)
    return rows


def _ladder_row_check(host, ladder_rows, curve):
    p, k, plain, want, dec = ladder_rows[curve]
    out = torch.empty_like(p)
    host[f"{curve}_mul"](p.data_ptr(), k.data_ptr(), out.data_ptr(), k.shape[0])
    assert torch.equal(out, plain)
    assert dec(out) == want


def test_g1_mul_row_matches_plain_and_hostmath(host, ladder_rows):
    """The G1 ladder row function (one lane a row) on the edge rows:
    equal to the windowed plain version exactly, to hostmath as points."""
    _ladder_row_check(host, ladder_rows, "g1")


def test_g2_mul_row_matches_plain_and_hostmath(host, ladder_rows):
    """The G2 ladder row function on the edge rows, likewise."""
    _ladder_row_check(host, ladder_rows, "g2")


@pytest.mark.parametrize("curve,tpi", [("g1", 2), ("g1", 4), ("g1", 8), ("g2", 2), ("g2", 4),
                                       ("g2", 8)])
def test_ladder_rows_by_lane_groups_match_plain(host, ladder_rows, curve, tpi):
    """The same rows with each row spread over an emulated group of tpi
    lanes, whose shuffles and ballots carry words and carries between
    the lanes: bit for bit the plain version's output."""
    p, k, plain, _, _ = ladder_rows[curve]
    n = 4 if tpi == 8 else k.shape[0]  # the slowest emulation on its first rows
    out = torch.empty_like(p[:n])
    host[f"{curve}_mul_lanes"](p.data_ptr(), k.data_ptr(), out.data_ptr(), n, tpi)
    assert torch.equal(out, plain[:n])


@pytest.mark.parametrize("tpi", [1, 2, 4, 8])
def test_ladder_field_by_lane_groups_matches_plain(host, tpi):
    """The ladder's cooperative field (Montgomery product, add, sub,
    is_zero) on values whose words are all ones or all zeros across whole
    lanes, so that carries and borrows run through the lookahead, and on
    [p, 2p) and random values: equal to fp_ops's plain version."""
    rng = random.Random(40 + tpi)
    P = hm.P
    ones = [(1 << (32 * j)) - 1 for j in range(1, 8)]
    powers = [1 << (32 * j) for j in range(1, 8)]
    mont_one = (1 << 256) % P
    xs = ([0, 1, P - 1, P, P + 1, 2 * P - 1] + ones + powers + ones + [o - 5 for o in ones]
          + ones + [rng.randrange(2 * P) for _ in range(16)])
    ys = ([2 * P - 1, P, 0, 1, P - 1, P + 3] + [1] * 14 + ones[::-1] + [5] * 7 + [mont_one] * 7
          + [rng.randrange(2 * P) for _ in range(16)])
    a = torch.from_numpy(lb.ints_to_words(xs))
    b = torch.from_numpy(lb.ints_to_words(ys))
    out = torch.empty((len(xs), 4, 8), dtype=torch.int32)
    host["ladder_field"](a.data_ptr(), b.data_ptr(), out.data_ptr(), len(xs), tpi)
    assert torch.equal(out[:, :3], fd.fp_ops_plain(a, b)[:, :3])
    zero = torch.tensor([x % P == 0 for x in xs])
    assert torch.equal(out[:, 3], torch.where(zero, -1, 0).to(torch.int32)[:, None].expand(-1, 8))


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


# the g1_msm row function's lanes a row (shares S) that host_g1_msm_lanes
# builds
MSM_LANES = [1, 2, 4, 8, 16, 32]


def _config(host, name, n):
    vals = [ctypes.c_int() for _ in range(n)]
    assert host[name](*(ctypes.byref(v) for v in vals)) == 0
    return tuple(v.value for v in vals)


def test_g1_msm_build_config_matches_the_plain_split(host):
    """The kernels' lane shares (FTS_G1_MSM_S, as the library reports
    them) are the split the plain version takes, so the two run the same
    sequence; the build's configuration is one of the host lane tests'."""
    (s,) = _config(host, "g1_msm_config", 1)
    assert s == cv.MSM_SPLIT
    assert s in MSM_LANES


@pytest.fixture(scope="module")
def msm_rows():
    """Rows for the lane tests: three random bases, and two equal bases
    (a row of equal scalars then meets P == Q in the butterfly); scalar
    edges 0, 1, r-1, every digit 15, one window, a scalar whose low
    windows sum to its top window's entry (P == Q inside one lane's chain
    when a lane owns all 64 windows), a zero scalar beside random ones;
    the tables lifted into [p, 2p) on every third entry."""
    rng = random.Random(52)
    m = (4 << 252) - hm.R  # (4 * 16^63) mod r, below 16^63
    assert 0 < m < 1 << 252
    ks = [0, 1, hm.R - 1, (1 << 256) - 1, 9 << 84, (4 << 252) + m]
    out = {}
    for tag, bases in (("random", _pts(rng, 3)), ("equal", [_pts(rng, 1)[0]] * 2)):
        nb = len(bases)
        rows = [[k] * nb for k in ks] + [[rng.randrange(hm.R) for _ in range(nb)]
                                         for _ in range(2)]
        rows[-1][0] = 0
        table = cv.FixedBaseTable(bases).table
        lifted = _lift(table.reshape(-1, 3, 8), range(0, table.shape[0] * 16, 3)).reshape(
            table.shape).contiguous()
        sc = torch.from_numpy(lb.ints_to_words([x for r in rows for x in r]).reshape(len(rows), nb, 8))
        want = [hm.g1_multiexp(bases, [x % hm.R for x in r]) for r in rows]
        out[tag] = (lifted, sc, want)
    return out


@pytest.mark.parametrize("s", MSM_LANES)
def test_g1_msm_rows_by_lane_groups_match_split_plain(host, msm_rows, s):
    """Both forms of the g1_msm row function, each row spread over s
    emulated lanes (the butterfly's shuffles exchanged as on the card),
    bit for bit against the plain version at split s, and as points
    against hostmath."""
    for lifted, sc, want in msm_rows.values():
        n, nb = sc.shape[0], sc.shape[1]
        plain = cv.from_half3(cv.msm(lifted, sc, split=s))
        assert cv.decode_points(plain) == want
        for select in (0, 1):
            out = torch.empty((n, 3, 8), dtype=torch.int32)
            rc = host["g1_msm_lanes"](lifted.data_ptr(), sc.data_ptr(), out.data_ptr(), n, nb, s,
                                      select)
            assert rc == 0
            assert torch.equal(out, plain)


def _fexp_rows(host):
    """GT one, a (0, 0) leg's Miller value (it lies in Fp4) and a random
    Fp12 lifted into [p, 2p) on every coefficient."""
    rng = random.Random(53)
    P = torch.from_numpy(pr.encode_g1([None]))
    Q = torch.from_numpy(pr.encode_g2(_g2pts(rng, 1)))
    leg = torch.empty((1, 6, 2, 8), dtype=torch.int32)
    host["miller"](P.data_ptr(), Q.data_ptr(), leg.data_ptr(), 1)
    rand = [tuple((rng.randrange(hm.P), rng.randrange(hm.P)) for _ in range(6))]
    f = torch.cat([_lift(torch.from_numpy(tw.encode_fp12(rand)), [0]), leg,
                   torch.from_numpy(tw.encode_fp12([hm.FP12_ONE]))])
    return f.contiguous()


def test_final_exp_program_table_matches_the_plain_program():
    """The kernels' FE_PROGRAM (csrc/bn254_gt_rows.cuh, the row function
    of final_exp.cu and pairing_fused.cu) is the program the plain
    version runs (ops/pairing.py:final_exp_program)."""
    with open(os.path.join(CSRC, "bn254_gt_rows.cuh")) as fh:
        src = fh.read()
    body = src[src.index("FE_PROGRAM[FE_PROGRAM_LEN] = {"):]
    body = body[: body.index("};")]
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)]
    assert words == pr.final_exp_program_words()
    assert f"FE_PROGRAM_LEN = {len(words)};" in src


# the final_exp row function's lanes a row (G) that host_final_exp_lanes
# builds
FEXP_LANES = [1, 2, 4, 8, 32]


def test_final_exp_build_config_is_a_tested_one(host):
    """The kernel's lanes a row (FTS_FINAL_EXP_G, as the library reports
    it) is one of the lane tests', and its shared memory a block is the
    row's cells times the rows of a one-warp block."""
    g, smem = _config(host, "final_exp_config", 2)
    assert g in FEXP_LANES
    assert smem == (32 // g) * (60 + 18) * 2 * 8 * 4  # 10 Fp12 slots + 18 product cells of Fp2


@pytest.mark.parametrize("g", FEXP_LANES)
def test_final_exp_rows_by_lane_groups_match_plain(host, g):
    """The final_exp row function by g emulated lanes (the cooperative
    tower's barriers as on the card) on a random value in [p, 2p), a (0,
    0) leg's Fp4 value and GT one: equal to the plain version and
    hostmath, and, at the kernel's own g, to the kernel's host entry."""
    f = _fexp_rows(host)
    n = 3
    want = st.final_exp_plain(f[:n])
    assert tw.decode_fp12(want) == [hm.final_exp(v) for v in tw.decode_fp12(f[:n])]
    out = torch.empty_like(f[:n])
    assert host["final_exp_lanes"](f.data_ptr(), out.data_ptr(), n, g) == 0
    assert torch.equal(out, want)
    if g == _config(host, "final_exp_config", 2)[0]:
        built = torch.empty_like(out)
        host["final_exp"](f.data_ptr(), built.data_ptr(), n)
        assert torch.equal(built, want)


def _g2pts(rng, n):
    return [hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(n)]


# the lanes a row (G) that host_miller_lanes and host_gt_product_lanes
# build
GT_LANES = [1, 2, 4, 8, 16, 32]


@pytest.fixture(scope="module")
def miller_legs():
    """A random leg with every coordinate lifted into [p, 2p), a (0, 0)
    leg and the generator pair, with their plain Miller values (one plain
    run for every lane count)."""
    rng = random.Random(54)
    P = _lift(torch.from_numpy(pr.encode_g1(_pts(rng, 1) + [None, hm.G1_GEN])), [0])
    Q = _lift(torch.from_numpy(pr.encode_g2(_g2pts(rng, 2) + [hm.G2_GEN])), [0])
    return P.contiguous(), Q.contiguous(), st.miller_plain(P, Q)


def test_miller_build_config_is_a_tested_one(host):
    """The kernel's lanes a leg (FTS_MILLER_G, as the library reports it)
    is one of the lane tests', and its shared memory a block is the leg's
    cells times the legs of a one-warp block."""
    g, smem = _config(host, "miller_config", 2)
    assert g in GT_LANES
    # f, T, Q, pi(Q), -pi^2(Q), (xp, 0), (yp, 0), 6 step products, the
    # line and 4 add-step values, x2 Z^2, y2 Z^3, Z^2, y2 Z of the next
    # add, 18 product cells
    assert smem == (32 // g) * (6 + 3 + 6 + 2 + 6 + 7 + 4 + 18) * 2 * 8 * 4


@pytest.mark.parametrize("g", GT_LANES)
def test_miller_rows_by_lane_groups_match_plain(host, miller_legs, g):
    """The miller row function by g emulated lanes (the barriers between
    its phases as on the card) on a leg in [p, 2p), a (0, 0) leg and the
    generator pair: equal to the plain version bit for bit, and, at the
    kernel's own g, to the kernel's host entry."""
    P, Q, want = miller_legs
    out = torch.empty_like(want)
    assert host["miller_lanes"](P.data_ptr(), Q.data_ptr(), out.data_ptr(), 3, g) == 0
    assert torch.equal(out, want)
    if g == _config(host, "miller_config", 2)[0]:
        built = torch.empty_like(want)
        host["miller"](P.data_ptr(), Q.data_ptr(), built.data_ptr(), 3)
        assert torch.equal(built, want)


def test_gt_product_build_config_is_a_tested_one(host):
    """As for miller: the built G is a tested one, and a row is two Fp12
    slots and the product cells."""
    g, smem = _config(host, "gt_product_config", 2)
    assert g in GT_LANES
    assert smem == (32 // g) * (12 + 18) * 2 * 8 * 4


@pytest.mark.parametrize("g", GT_LANES)
@pytest.mark.parametrize("k", [2, 3, 4])
def test_gt_product_rows_by_lane_groups_match_plain(host, k, g):
    """The gt_product row function by g emulated lanes over K legs (random
    values, some lifted into [p, 2p), a (0, 0) leg's Fp4 Miller value and
    GT one): equal to the plain version's pairwise tree and to hostmath's
    product, and, at the kernel's own g, to the kernel's host entry."""
    rng = random.Random(55 + k)
    vals = [tuple((rng.randrange(hm.P), rng.randrange(hm.P)) for _ in range(6))
            for _ in range(2 * k)]
    f = _lift(torch.from_numpy(tw.encode_fp12(vals)), range(0, 2 * k, 2))
    f[1] = _fexp_rows(host)[1]  # the (0, 0) leg's Miller value
    f[2 * k - 1] = torch.from_numpy(tw.encode_fp12([hm.FP12_ONE]))[0]
    f = f.reshape(2, k, 6, 2, 8).contiguous()
    want = st.gt_product_plain(f)
    legs = [tw.decode_fp12(f[r]) for r in range(2)]
    prods = []
    for row in legs:
        acc = row[0]
        for v in row[1:]:
            acc = hm.fp12_mul(acc, v)
        prods.append(acc)
    assert tw.decode_fp12(want) == prods
    out = torch.empty_like(want)
    assert host["gt_product_lanes"](f.data_ptr(), out.data_ptr(), 2, k, g) == 0
    assert torch.equal(out, want)
    if g == _config(host, "gt_product_config", 2)[0]:
        built = torch.empty_like(want)
        host["gt_product"](f.data_ptr(), built.data_ptr(), 2, k)
        assert torch.equal(built, want)


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


def _fp_inv_inputs(kind):
    """Montgomery words in [0, 2p) for the inversion's test, by kind."""
    P, RM = hm.P, (1 << 256) % hm.P
    rng = random.Random(61)
    if kind == "edges":
        return [0, P, 1, RM, P - 1, 2 * P - 1, P + 1, P + RM]
    if kind == "powers of two":
        return [pow(2, k, P) for k in range(256)] + [P + pow(2, k, P) for k in range(0, 254, 7)]
    if kind == "random":
        return [rng.randrange(P) for _ in range(2000)]
    return [rng.randrange(P, 2 * P) for _ in range(1000)]  # lifted into [p, 2p)


@pytest.mark.parametrize("kind", ["edges", "powers of two", "random", "lifted"])
def test_fp_inv_safegcd_matches_hostmath(host, kind):
    """csrc/bn254_inv.cuh's inversion alone, on Montgomery words a = zR in
    [0, 2p): canonical z^-1 R, that is a^-1 R^2 mod p, and 0 for 0 and p;
    on 0, p, 1, R mod p, p - 1, 2p - 1 and their lifts, 2^k mod p, and
    seeded random values in [0, p) and in [p, 2p)."""
    P, R = hm.P, 1 << 256
    xs = _fp_inv_inputs(kind)
    a = torch.from_numpy(lb.ints_to_words(xs))
    out = torch.empty_like(a)
    host["fp_inv"](a.data_ptr(), out.data_ptr(), len(xs))
    want = [0 if x % P == 0 else hm.fp_inv(x % P) * R * R % P for x in xs]
    assert lb.batch_words_to_ints(out) == want


@pytest.fixture(scope="module")
def affine_rows():
    """37 rows of each group, with random Z: the generator with Z = 1
    (row 0) and with a random Z (row 1), Z = 0 (row 3), Z = p (row 10, the
    redundant zero, X and Y random), every coordinate lifted into [p, 2p)
    in rows 20-24, and infinity again in row 34; with the hostmath points
    the rows encode (None where Z is 0 or p)."""
    rng = random.Random(62)
    P, RM, n = hm.P, (1 << 256) % hm.P, 37
    g1 = [hm.G1_GEN, hm.G1_GEN] + _pts(rng, n - 2)
    g2 = [hm.G2_GEN, hm.G2_GEN] + _g2pts(rng, n - 2)
    g1[3] = g2[3] = g1[34] = g2[34] = None
    w1 = np.zeros((n, 3, 8), dtype=np.int32)
    w2 = np.zeros((n, 3, 2, 8), dtype=np.int32)
    for i in range(n):
        z1 = 1 if i == 0 else rng.randrange(1, P)
        z2 = (1, 0) if i == 0 else (rng.randrange(P), rng.randrange(P))
        if g1[i] is not None:
            x, y = g1[i]
            w1[i] = lb.ints_to_words([v * RM % P for v in (x * z1 * z1, y * z1 ** 3, z1)])
        if g2[i] is not None:
            zz = hm.fp2_mul(z2, z2)
            w2[i] = tw.encode_fp2([hm.fp2_mul(g2[i][0], zz),
                                   hm.fp2_mul(g2[i][1], hm.fp2_mul(zz, z2)), z2])
    for w, k in ((w1, 3), (w2, 6)):  # row 10: Z = p (both Z words in G2), X, Y random
        flat = w.reshape(n, k, 8)
        flat[10] = lb.ints_to_words([rng.randrange(P) for _ in range(k)])
        flat[10, k * 2 // 3:] = lb.ints_to_words([P] * (k // 3))
    g1[10] = g2[10] = None
    t1 = _lift(torch.from_numpy(w1), range(20, 25))
    t2 = _lift(torch.from_numpy(w2), range(20, 25))
    return {"g1": (t1.contiguous(), g1), "g2": (t2.contiguous(), g2)}


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_to_affine_rows_with_edges_match_plain_and_hostmath(host, affine_rows, curve):
    """g1_to_affine and g2_to_affine rows over the safegcd inversion, on
    37 rows with Z = 0 and Z = p among them, coordinates in [p, 2p) and
    the generators: bit for bit the plain versions (a Fermat inversion)
    and the encoded hostmath points, (0, 0) where Z is 0 or p."""
    points, pts = affine_rows[curve]
    plain = getattr(st, f"{curve}_to_affine_plain")(points)
    encode = pr.encode_g1 if curve == "g1" else pr.encode_g2
    assert torch.equal(plain, torch.from_numpy(encode(pts)))
    out = torch.full_like(plain, -1)
    host[f"{curve}_to_affine"](points.data_ptr(), out.data_ptr(), points.shape[0])
    assert torch.equal(out, plain)


# the lanes a row that host_g1_addsub_lanes (TPI: each element split over
# the lanes) and host_g2_add_lanes (G: the formula's base products split
# over the lanes) build
ADD_LANES = {"g1": [1, 2, 4, 8], "g2": [1, 2, 4, 8, 16, 32]}


@pytest.fixture(scope="module")
def add_rows(affine_rows):
    """Operand pairs for the add kernels and their plain outputs: a the
    to-affine rows (random Z, the generator with Z = 1, Z = 0 in rows 3
    and 34, Z = p in row 10, every coordinate in [p, 2p) in rows 20-24),
    b the same rows turned by one (so b is at infinity in rows 4, 11 (Z =
    p) and 35 against a finite a), with the edges planted: b = a (P + P)
    in rows 5 and 21 (both lifted), b = a with another Z (P + P) in row
    6, b = -a (P - P) in row 7, both at infinity (Z = 0) in row 34; with
    the hostmath points the rows encode."""
    rows = {}
    for curve, k in (("g1", 3), ("g2", 6)):
        a, pts = affine_rows[curve]
        n = a.shape[0]
        b = torch.roll(a, 1, dims=0).clone()
        B = [pts[i - 1] for i in range(n)]
        fa, fb = a.view(n, k, 8), b.view(n, k, 8)
        lam = 0x2468ACE1
        for c in range(k):
            x6 = lb.words_to_int(fa[6, c].numpy())
            x7 = lb.words_to_int(fa[7, c].numpy())
            power = 2 if c < k // 3 else 3 if c < 2 * k // 3 else 1  # X, Y, Z
            fb[6, c] = torch.from_numpy(lb.int_to_words(x6 * lam ** power % hm.P))
            if k // 3 <= c < 2 * k // 3:
                x7 = (hm.P - x7 % hm.P) % hm.P
            fb[7, c] = torch.from_numpy(lb.int_to_words(x7))
        for r in (5, 21, 34):
            fb[r] = fa[r]
        neg = hm.g1_neg if curve == "g1" else hm.g2_neg
        B[5], B[6], B[7], B[21], B[34] = pts[5], pts[6], neg(pts[7]), pts[21], None
        b = b.contiguous()
        if curve == "g1":
            for negate_b in (False, True):
                want = st.g1_addsub_plain(a, b, negate_b)
                host_pts = [hm.g1_add(x, neg(y) if negate_b and y is not None else y)
                            for x, y in zip(pts, B)]
                assert cv.decode_points(want) == host_pts
                rows[(curve, negate_b)] = (a, b, want)
        else:
            want = st.g2_add_plain(a, b)
            assert cv2.decode_points(want) == [hm.g2_add(x, y) for x, y in zip(pts, B)]
            rows[(curve, False)] = (a, b, want)
    return rows


@pytest.mark.parametrize("curve,negate_b,g", [("g1", nb, t) for nb in (False, True)
                                              for t in ADD_LANES["g1"]]
                         + [("g2", False, g) for g in ADD_LANES["g2"]])
def test_add_rows_by_lane_groups_match_plain_and_hostmath(host, add_rows, curve, negate_b, g):
    """g1_addsub (as an add and as a sub) and g2_add by an emulated group of
    g lanes (host_check.h: the shuffles and barriers between the lanes
    as on the card) on 37 rows with P + P (the same words, and another
    Z), P - P, infinity (Z = 0 and Z = p) on either side and on both, and
    coordinates in [p, 2p): bit for bit the plain version, itself equal
    to hostmath's points; at the kernel's own lane count also its host
    entry."""
    a, b, want = add_rows[(curve, negate_b)]
    n, out = a.shape[0], torch.full_like(a, -1)
    if curve == "g1":
        rc = host["g1_addsub_lanes"](a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                                     int(negate_b), g)
    else:
        rc = host["g2_add_lanes"](a.data_ptr(), b.data_ptr(), out.data_ptr(), n, g)
    assert rc == 0
    assert torch.equal(out, want)
    name = "g1_addsub" if curve == "g1" else "g2_add"
    if g == _config(host, f"{name}_config", 2 if curve == "g1" else 3)[0]:
        built = torch.full_like(a, -1)
        extra = (int(negate_b),) if curve == "g1" else ()
        host[name](a.data_ptr(), b.data_ptr(), built.data_ptr(), n, *extra)
        assert torch.equal(built, want)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_add_build_config_is_a_tested_one(host, curve):
    """The kernels' lanes a row (FTS_G1_ADDSUB_TPI, FTS_G2_ADD_G, as the
    libraries report them) are lane counts of the tests above, a block is
    whole warps of whole groups, and g2_add's shared memory a block is a
    row's cells (44 Fp2 values as c0, c1, c0 + c1, and the 3 base products
    of each of a phase's 8 products) for each row of the block."""
    if curve == "g1":
        tpi, threads = _config(host, "g1_addsub_config", 2)
        assert tpi in ADD_LANES["g1"] and threads % 32 == 0
        return
    g, threads, smem = _config(host, "g2_add_config", 3)
    assert g in ADD_LANES["g2"] and threads % 32 == 0
    rows = threads // g
    assert smem == (44 * 3 + 8 * 3) * (8 * rows + 1) * 4


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


# the fused kernel's variants that host_pairing_product_lanes builds:
# (lanes a leg GM, lanes a row GF), and the tail's GF
FUSED_LANES = [(gm, gf) for gm in (2, 4, 8) for gf in (4, 8, 16)]
TAIL_LANES = [4, 8, 16]
# legs a row: K = 1-4, and 6, where GM = 8 takes two rounds of legs
FUSED_K = [1, 2, 3, 4, 6]


def _fused_plan(gm, gf, k):
    """(rows, shared bytes) of a warp of both modes, as pairing_fused.cu
    lays them out: a leg's 52 Fp2 cells a group of GM lanes, a row's 78
    (ten Fp12 slots and 18 product cells) in turns of 32 / GF rows; one
    round of legs puts the rows over the legs' cells past their f, several
    rounds the rows after the legs."""
    leg, row, slot = 52 * 16, 78 * 16, 6 * 16
    groups, turn = 32 // gm, 32 // gf
    rows = max(1, groups // k)
    legs = min(k, groups // rows)
    rounds = -(-k // legs)
    row_words = -(-rows // turn) * turn * row
    if rounds == 1:
        words = max(leg * groups, slot * groups + row_words)
    else:
        words = leg * groups + row_words
    return rows, words * 4, turn, turn * row * 4


@pytest.mark.parametrize("k", FUSED_K)
def test_pairing_fused_build_config_is_a_tested_one(host, k):
    """The fused kernel's lanes (FTS_FUSED_GM, _GF, as the library
    reports them for K legs a row) are a variant of the lane tests, and its
    rows and shared memory a warp, both modes, are that layout's."""
    vals = (ctypes.c_int * 6)()
    assert host["pairing_fused_config"](k, vals) == 0
    gm, gf, *rest = tuple(vals)
    assert (gm, gf) in FUSED_LANES and gf in TAIL_LANES
    assert tuple(rest) == _fused_plan(gm, gf, k)
    assert host["pairing_fused_config"](0, (ctypes.c_int * 6)()) == -1


@pytest.fixture(scope="module")
def fused_rows():
    """3 rows a K (rows past a warp's last for most layouts; K = 3 leaves
    groups with no leg): row 0 lifted into [p, 2p), leg 0 of row 1 a (0,
    0) leg, and a mask of that leg and the last leg of row 2. Their plain
    results with and without the mask, and the masked Miller values, by
    one plain Miller call and one plain final exponentiation."""
    rng = random.Random(56)
    n, cases, legs_P, legs_Q = 3, {}, [], []
    for k in FUSED_K:
        p, q = _pts(rng, n * k), _g2pts(rng, n * k)
        p[k] = None
        P = _lift(torch.from_numpy(pr.encode_g1(p)), range(k))
        Q = _lift(torch.from_numpy(pr.encode_g2(q)), range(k))
        mask = torch.zeros((n, k), dtype=torch.uint8)
        mask[1, 0] = mask[2, k - 1] = 1
        cases[k] = (P.reshape(n, k, 2, 8).contiguous(), Q.reshape(n, k, 2, 2, 8).contiguous(),
                    mask, p, q)
        legs_P.append(P)
        legs_Q.append(Q)
    f = st.miller_plain(torch.cat(legs_P), torch.cat(legs_Q))
    prods, fs, at = [], {}, 0
    for k in FUSED_K:
        fk = f[at:at + n * k].reshape(n, k, 6, 2, 8)
        at += n * k
        fs[k] = st._mask_one(fk, cases[k][2].bool().numpy()).contiguous()
        prods += [st.gt_product_plain(fk), st.gt_product_plain(fs[k])]
    gt = st.final_exp_plain(torch.cat(prods))
    out = {}
    for i, k in enumerate(FUSED_K):
        P, Q, mask, p, q = cases[k]
        out[k] = (P, Q, mask, fs[k], gt[2 * i * n:(2 * i + 1) * n],
                  gt[(2 * i + 1) * n:(2 * i + 2) * n])
        # the finite rows against hostmath: unmasked, row 1 has a (0, 0)
        # leg (outside hostmath's domain); masked, every row
        host_rows = [hm.pairing_product([(p[r * k + j], q[r * k + j]) for j in range(k)
                                         if not mask[r, j]]) for r in range(n)]
        assert tw.decode_fp12(out[k][5]) == host_rows
        assert [v for r, v in enumerate(tw.decode_fp12(out[k][4])) if r != 1] == [
            hm.pairing_product([(p[r * k + j], q[r * k + j]) for j in range(k)])
            for r in (0, 2)]
    return out


@pytest.mark.parametrize("gm,gf", FUSED_LANES)
def test_pairing_fused_rows_by_lane_groups_match_plain(host, fused_rows, gm, gf):
    """fts_pairing_product's warp function by a warp of emulated lanes
    (host_check.h: its barriers real ones, so a missing one between the
    Miller loops, the product and the final exponentiation fails) at GM
    lanes a leg and GF a row, on K = 1-4 and 6 with
    rows past a block's last, an unmasked (0, 0) leg, masked legs and
    coordinates in [p, 2p): equal to pairing_product_plain bit for bit
    (hostmath holds the plain results in the fixture), and, at the built
    variant, to the kernel's host entry."""
    vals = (ctypes.c_int * 6)()
    host["pairing_fused_config"](1, vals)
    built = tuple(vals)[:2] == (gm, gf)
    for k, (P, Q, mask, _, want, want_masked) in fused_rows.items():
        n = P.shape[0]
        for m, expect in ((None, want), (mask, want_masked)):
            out = torch.zeros((n, 6, 2, 8), dtype=torch.int32)
            ptr = None if m is None else m.data_ptr()
            assert host["pairing_product_lanes"](P.data_ptr(), Q.data_ptr(), ptr, out.data_ptr(),
                                                 n, k, gm, gf) == 0
            assert torch.equal(out, expect), (k, m is not None)
            if built:
                own = torch.zeros_like(out)
                host["pairing_product"](P.data_ptr(), Q.data_ptr(), ptr, own.data_ptr(), n, k)
                assert torch.equal(own, expect)


@pytest.mark.parametrize("g", TAIL_LANES)
def test_gt_product_final_exp_rows_by_lane_groups_match_plain(host, fused_rows, g):
    """fts_gt_product_final_exp's warp function by a warp of emulated
    lanes at g lanes a row, on the masked Miller values (GT one in the
    masked legs, a (0, 0) leg's Fp4 value, K = 1-4 and 6, rows past a
    warp's last): equal to gt_product_final_exp_plain bit for bit, and, at
    the built g, to the kernel's host entry."""
    vals = (ctypes.c_int * 6)()
    host["pairing_fused_config"](1, vals)
    for k, (_, _, _, f, _, want_masked) in fused_rows.items():
        n = f.shape[0]
        assert torch.equal(st.gt_product_final_exp_plain(f), want_masked)
        out = torch.zeros((n, 6, 2, 8), dtype=torch.int32)
        assert host["gt_product_final_exp_lanes"](f.data_ptr(), out.data_ptr(), n, k, g) == 0
        assert torch.equal(out, want_masked), k
        if g == vals[1]:
            own = torch.zeros_like(out)
            host["gt_product_final_exp"](f.data_ptr(), own.data_ptr(), n, k)
            assert torch.equal(own, want_masked)
    bad = torch.zeros((1, 6, 2, 8), dtype=torch.int32)
    assert host["gt_product_final_exp_lanes"](bad.data_ptr(), bad.data_ptr(), 1, 1, 2) == -1
    assert host["pairing_product_lanes"](bad.data_ptr(), bad.data_ptr(), None, bad.data_ptr(),
                                         1, 1, 4, 2) == -1
