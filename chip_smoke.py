#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from `fabric_token_sdk_tpu_torch/csrc`,
holds each against its plain torch version on the card (edge cases
included), then drives the port's main paths through
`BatchedTransferVerifier` on `cuda`, each for a 64-transaction block
(the orderer's default block size) and a 1,024-transaction backlog
batch, with tampered and malformed rows planted:

* zkatdlog 1-in/1-out transfers (no range proof: three G1 kernels);
* 2-in/2-out transfers (the JAX bench's headline shape), whose range
  proofs run all ten kernels: the G1 ones, G1 to-affine, the G2 ladder,
  add and to-affine, the Miller loop, the GT product and the final
  exponentiation. The batch is 16 copies of the block's 64 distinct
  transactions (the port has no parse cache, so a copy costs what a
  distinct row costs).

Verdicts must equal the port's host `TransferVerifier` on every row, and
every kernel of each path must have been launched by that path's run.
The range kernels are then timed on the very inputs the verify gave
them, at both sizes, and held against their plain versions there.

Then the prove plane, through `TransferProver.batch` on `cuda` at the JAX
bench's shape and values (2-in/2-out, [100, 55] -> [120, 35]) for a
64-transaction group and a 1,024-transaction backlog, all distinct, and
1-in/1-out for 64 (the WF-only prove): every fixed-base multiexp goes
through the select kernel (`g1_msm_select`), the signature obfuscation
through `g1_addsub` as an add, the GT pre-commitments through the K = 2
product. The proofs must be accepted by the host and batched verifiers,
planted tampering rejected, a small group's bytes equal the plain
versions' on the CPU for one seed, and each launch count equal the
plan; the select multiexp, the add and the K = 2 product are held
against their plain versions on the prover's own inputs, and the select
kernel is timed on zero and on random scalars beside the gather. Last,
64 Pointcheval-Sanders signatures (the range parameters' signed set,
randomised, with tampered and malformed rows) through
`BatchedPSVerifier`, verdicts equal the host's.

Last, the mesh plane on logical meshes of the one card (every cell of a
(dp = 2, mp = 2) mesh, and a (1, 1) mesh, on cuda:0): the fused pairing
product of `csrc/pairing_fused.cu` in both modes (the whole product a
row, and the tail after a gather of Miller values) held exactly against
its plain version and the staged launch sequence on edge rows (K = 1,
2, 4, a (0, 0) leg, masked legs), on the membership check's legs and on
the PS verify's legs, and timed beside the staged sequence; the PS
checks through `sharded_pairing_product(fused=True)` on both meshes
(planted rows rejected, the launches as planned) and through
`multichip_torch.py --logical`; `sharded_schnorr_rows` on the mesh bit
for bit against no mesh; and `BatchedSchnorrVerifier` on 64 and 1,024
signatures with planted faults against the host `PublicKey.verify`,
with and without the mesh.

Phases print one line each. Before the last line come the GPU's name
and power limit as `nvidia-smi` reports them and one JSON object with
each path kernel's launches, times and bound; the last line is
`{"ok": true, "device": {...}}`. Any failure exits non-zero with no
result line, as does a machine without CUDA. Imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM rates (NVIDIA data sheet; CUDA C++ Programming Guide,
# arithmetic instruction throughput for compute capability 9.0): 3.35 TB/s
# of HBM3, and 64 32-bit integer multiply-adds per clock per SM, on 132
# SMs at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
# One CIOS Montgomery product of 8-word operands: 64 a*b and 64 m*p
# word products (32x32->64 bits, a low and a high multiply each) plus 8
# multiplies for the m words.
IMAD_PER_FP_MUL = 2 * (64 + 64) + 8
# Field products the function itself needs, whatever algorithm a kernel
# uses: a Jacobian add (add-2007-bl) 16, a mixed add against an affine
# table entry (madd-2007-bl) 11, a doubling (dbl-2009-l) 7. The kernels
# do more (their add also computes the doubling it selects away when
# P == Q, and g1_mul adds on every bit); the bound counts only these.
FP_MULS_ADD = 16
FP_MULS_MADD = 11
FP_MULS_DOUBLE = 7
# [k]P by 4-bit fixed windows: the table P..15P takes 7 doublings and
# 7 adds.
FP_MULS_WINDOW_TABLE = 7 * FP_MULS_DOUBLE + 7 * FP_MULS_ADD
POINT_BYTES = 3 * 8 * 4
SCALAR_BYTES = 8 * 4
# Over the tower, in base-field products: Karatsuba Fp2 product 3,
# complex Fp2 squaring 2; G2 doubling (2M + 5S) 16 and addition
# (11M + 5S) 43; Fp12 product 18 Fp2 products (Karatsuba over Fp6) 54,
# Fp12 squaring 2 Fp6 products 36, cyclotomic squaring (Granger-Scott,
# 9 Fp2 squarings) 18, sparse line product (13 Fp2 products) 39.
G2_MULS_DOUBLE = 2 * 3 + 5 * 2
G2_MULS_ADD = 11 * 3 + 5 * 2
G2_MULS_WINDOW_TABLE = 7 * G2_MULS_DOUBLE + 7 * G2_MULS_ADD
FP12_MUL = 18 * 3
FP12_SQR = 12 * 3
CYCLO_SQR = 9 * 2
SPARSE_MUL = 13 * 3
# An Fp inversion by Fermat with 4-bit windows: 252 squarings, 64
# multiplies and a 14-product table. Montgomery's trick makes one
# inversion serve a whole launch, at 3 products a row.
INV_PRODUCTS = 252 + 64 + 14
BATCH_INV_PER_ROW = 3
# Miller loop a leg, projective lines: doubling step with line
# (3M2 + 6S2 + 4 scalings by xp, yp) 25, mixed addition step with line
# (11M2 + 2S2 + 4) 41; f^2 and a sparse product on each of the 64 bits
# of 6u+2 below its top, an add step and a sparse product on its 36 set
# bits and the two closing adds, Q1 and -Q2 by 4 Fp2 products.
MILLER_DBL, MILLER_ADD = 3 * 3 + 6 * 2 + 4, 11 * 3 + 2 * 2 + 4
# Final exponentiation a row: easy part 2 Fp12 products and a p^2
# Frobenius (10), the Fp12 inverse by the batch trick (3 Fp12 products
# a row); hard part (Fuentes-Castaneda et al.) 3 exponentiations by u
# (62 cyclotomic squarings, 27 products each for u's 28 set bits), 12
# Fp12 products, 4 cyclotomic squarings and 3 Frobenius maps (40).
FEXP_PER_ROW = (2 * FP12_MUL + 10 + 3 * FP12_MUL
                + 3 * (62 * CYCLO_SQR + 27 * FP12_MUL) + 12 * FP12_MUL + 4 * CYCLO_SQR + 40)
FP12_INV = 3 * FP12_MUL + INV_PRODUCTS  # one a launch (batch trick)
FP2_BYTES, FP12_BYTES = 2 * SCALAR_BYTES, 12 * SCALAR_BYTES
G2_BYTES = 3 * FP2_BYTES

BLOCK_TXS = 64  # orderer default max_block_txs
BATCH_TXS = 1024  # backlog batch
ROWS_PER_TX = 4  # 1-in/1-out WF: input, input sum, output, output sum
RANGE_COPIES = BATCH_TXS // BLOCK_TXS  # the range batch: copies of the block
VERIFY_REPS = {"1-in/1-out": (11, 5), "2-in/2-out": (7, 3)}  # block, batch
RANGE_KERNELS = ("g1_to_affine", "g2_mul", "g2_add", "g2_to_affine", "miller",
                 "gt_product", "final_exp")
# launches of one 2-in/2-out verify, reckoned from crypto/batch.py: WF
# (msm, mul, sub), membership (msm x2, mul x2, sub, and one of each range
# kernel), equality (msm x2, mul x2, sub x2)
RANGE_LAUNCHES = {"g1_msm": 5, "g1_mul": 5, "g1_addsub": 4, **{k: 1 for k in RANGE_KERNELS},
                  "g1_msm_select": 0, "pairing_product": 0, "gt_product_final_exp": 0}
# launches of one 2-in/2-out prove, reckoned from crypto/batch_prove.py:
# select multiexps for the WF (ped3), ped2, equality (ped3) and P rows,
# the signature ladder, the obfuscating add, the G2 ladder, add and
# to-affine, and the K = 2 pairing product; no gather, no to-affine in G1
PROVE_LAUNCHES = {"g1_msm": 0, "g1_mul": 1, "g1_addsub": 1, "g1_to_affine": 0, "g2_mul": 1,
                  "g2_add": 1, "g2_to_affine": 1, "miller": 1, "gt_product": 1, "final_exp": 1,
                  "g1_msm_select": 4, "pairing_product": 0, "gt_product_final_exp": 0}
PROVE_WF_LAUNCHES = {**{k: 0 for k in PROVE_LAUNCHES}, "g1_msm_select": 1}
# a PS verify: the G2 ladder, two G2 adds (the tree of 2 terms, then PK0),
# to-affine, and the K = 2 product
PS_LAUNCHES = {**{k: 0 for k in PROVE_LAUNCHES}, "g2_mul": 1, "g2_add": 2, "g2_to_affine": 1,
               "miller": 1, "gt_product": 1, "final_exp": 1}
PROVE_REPS = (5, 3)  # block, batch
PS_SIGS = 64
REPLACES = {
    "g1_msm": "fabric_token_sdk_tpu/ops/stages.py:61",
    "g1_mul": "fabric_token_sdk_tpu/ops/curve.py:122",
    "g1_addsub": "fabric_token_sdk_tpu/ops/stages.py:83",
    "g1_to_affine": "fabric_token_sdk_tpu/ops/stages.py:91",
    "g2_mul": "fabric_token_sdk_tpu/ops/curve2.py:102",
    "g2_add": "fabric_token_sdk_tpu/ops/curve2.py:59",
    "g2_to_affine": "fabric_token_sdk_tpu/ops/stages.py:100",
    "miller": "fabric_token_sdk_tpu/ops/pairing.py:180",
    "gt_product": "fabric_token_sdk_tpu/ops/pairing.py:361",
    "final_exp": "fabric_token_sdk_tpu/ops/pairing.py:250",
    "g1_msm_select": "fabric_token_sdk_tpu/ops/curve.py:256",
    "g1_add": "fabric_token_sdk_tpu/ops/curve.py:60",
    "gt_product_k2": "fabric_token_sdk_tpu/ops/pairing.py:361",
    "pairing_product": "fabric_token_sdk_tpu/parallel/sharding.py:158",
    "gt_product_final_exp": "fabric_token_sdk_tpu/parallel/sharding.py:158",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nibbles(k: int) -> list:
    """The 4-bit digits of k, least significant first, up to its top digit."""
    out = []
    while k:
        out.append(k & 15)
        k >>= 4
    return out


def msm_products(scalar_rows) -> int:
    """Field products of fixed-base multiexps, one a row over its scalars:
    one mixed add per non-zero 4-bit digit after the first (the first
    is a table load)."""
    total = 0
    for ks in scalar_rows:
        nonzero = sum(1 for k in ks for d in nibbles(k) if d)
        total += max(nonzero - 1, 0) * FP_MULS_MADD
    return total


def mul_products(points, scalars, table=FP_MULS_WINDOW_TABLE, dbl=FP_MULS_DOUBLE,
                 add=FP_MULS_ADD) -> int:
    """Field products of [k]P a row by 4-bit fixed windows: the table
    (when k has more than one digit), 4 doublings a window below the top
    one and an add per non-zero digit below the top one. `points` holds
    None where a point is at infinity."""
    total = 0
    for p, k in zip(points, scalars):
        ds = nibbles(k)
        if p is None or len(ds) < 2:
            continue
        total += table + 4 * (len(ds) - 1) * dbl
        total += sum(1 for d in ds[:-1] if d) * add
    return total


def miller_products(legs: int) -> int:
    from fabric_token_sdk_tpu_torch.ops import pairing as pr

    nbits, nset = len(pr._ATE_BITS), int(pr._ATE_BITS.sum())
    per_leg = (nbits * (FP12_SQR + MILLER_DBL + SPARSE_MUL) + nset * (MILLER_ADD + SPARSE_MUL)
               + 4 * 3 + 2 * (MILLER_ADD + SPARSE_MUL))
    return legs * per_leg


def bound_ms(products: int, nbytes: int) -> tuple:
    """(bound in ms, "bytes" or "operations") for work of `products`
    Fp products that must move `nbytes` bytes."""
    t_ops = products * IMAD_PER_FP_MUL / IMAD_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261017)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from fabric_token_sdk_tpu_torch.crypto import hostmath as hm, token as tok
    from fabric_token_sdk_tpu_torch.crypto import transfer as tr, wellformedness as wfm
    from fabric_token_sdk_tpu_torch.crypto import pssign
    from fabric_token_sdk_tpu_torch.crypto.batch import BatchedPSVerifier, BatchedTransferVerifier
    from fabric_token_sdk_tpu_torch.crypto.batch_prove import prover_for
    from fabric_token_sdk_tpu_torch.crypto.rangeproof import RangeProof
    from fabric_token_sdk_tpu_torch.crypto.setup import setup
    from fabric_token_sdk_tpu_torch.ops import _build, curve as cv, curve2 as cv2, field as fd
    from fabric_token_sdk_tpu_torch.ops import limbs as lb, pairing as pr, stages as st, tower as tw
    from fabric_token_sdk_tpu_torch.utils import metrics as mx

    dev = torch.device("cuda")
    rng = random.Random(args.seed)
    kernels_by_name = {k.name: k for k in _build.ALL_KERNELS}

    # ---------------------------------------------------------------- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    say("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind} "
        f"x{torch.cuda.device_count()}; nvidia-smi: {card}")

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    _build.build_all()
    t_build = time.perf_counter() - t0
    regs = []
    for src, log in sorted(_build.BUILD_LOG.items()):
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln:  # the kernel's own properties follow
                regs.append(f"{src}: " + " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 2:i + 4]))
    say("build", f"{len(_build.SOURCES)} sources with nvcc sm_90a in {t_build:.1f} s; "
        + " | ".join(regs))

    def timed(fn, reps: int) -> float:
        """Mean ms per call over `reps` calls, after a warm-up call."""
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def plain_timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def max_abs_err(a, b) -> int:
        """Largest |difference| between two (..., 8) word tensors, as
        256-bit integers (0 when they agree exactly)."""
        x, y = lb.batch_words_to_ints(a), lb.batch_words_to_ints(b)
        return max((abs(u - v) for u, v in zip(x, y)), default=0)

    # ---------------------------------------------------------------- field
    P = hm.P
    vals_a = [rng.randrange(2 * P) for _ in range(4096)] + [0, 1, P - 1, P, P + 1, 2 * P - 1]
    vals_b = [rng.randrange(2 * P) for _ in range(4096)] + [2 * P - 1, P, 0, 1, P - 1, P + 3]
    fa = torch.from_numpy(lb.ints_to_words(vals_a)).to(dev)
    fb = torch.from_numpy(lb.ints_to_words(vals_b)).to(dev)
    got = fd.fp_ops(fa, fb)
    torch.cuda.synchronize()
    want = fd.fp_ops_plain(fa, fb)
    if not torch.equal(got, want):
        fail(f"fp_ops kernel disagrees with its plain version (max |err| {max_abs_err(got, want)})")
    say("field", f"fp_ops mul/add/sub/inv on {len(vals_a)} values (edges 0, 1, p-1, [p, 2p)): exact")

    # ---------------------------------------------------------------- kernels
    pool = [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(64)]
    pool2 = [hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(16)]
    tables = {nb: cv.FixedBaseTable(pool[:nb]).to(dev) for nb in (1, 2, 3)}

    def rand_points(n, edges, src=pool):
        pts = [rng.choice(src) for _ in range(n)]
        pts[: len(edges)] = edges
        return pts

    def redundant(words: torch.Tensor, rows) -> torch.Tensor:
        """Lift every 8-word value of some rows from [0, p) into [p, 2p)."""
        out = words.clone().cpu()
        flat = out.view(out.shape[0], -1, lb.NWORDS)
        for r in rows:
            for c in range(flat.shape[1]):
                v = lb.words_to_int(flat[r, c].numpy())
                if v < P:
                    flat[r, c] = torch.from_numpy(lb.int_to_words(v + P))
        return out.to(words.device)

    stats = {}  # kernel -> numbers at the path's shapes
    for rows in (BLOCK_TXS * ROWS_PER_TX, BATCH_TXS * ROWS_PER_TX):
        # g1_msm, nbases 1/2/3; scalars 0, 1, r-1 among random ones
        for nb in (1, 2, 3):
            ks = [rng.randrange(hm.R) for _ in range(rows * nb)]
            ks[:3 * nb] = [0] * nb + [1] * nb + [hm.R - 1] * nb
            sc = torch.from_numpy(cv.encode_scalars(ks).reshape(rows, nb, 8)).to(dev)
            tab = tables[nb].table
            got = st.g1_msm_rows(tab, sc)
            want, p_ms = plain_timed(lambda: st.g1_msm_plain(tab, sc))
            if not torch.equal(got, want):
                fail(f"g1_msm nbases={nb} rows={rows} disagrees with its plain version")
            if nb == 3:
                ms = timed(lambda: st.g1_msm_rows(tab, sc), 10)
                bound = bound_ms(
                    msm_products(ks[r * nb:(r + 1) * nb] for r in range(rows)),
                    tab.numel() * 4 + rows * (nb * SCALAR_BYTES + POINT_BYTES))
                stats.setdefault("g1_msm", {})[rows] = (ms, p_ms, max_abs_err(got, want), bound)
        # g1_mul: scalars 0, 1, r-1 and an infinite point, some rows redundant
        pts = rand_points(rows, [pool[0], pool[1], pool[2], None])
        ks = [rng.randrange(hm.R) for _ in range(rows)]
        ks[:4] = [0, 1, hm.R - 1, 5]
        pw = redundant(torch.from_numpy(cv.encode_points(pts)), range(4, 12)).to(dev)
        kw = torch.from_numpy(cv.encode_scalars(ks)).to(dev)
        got = st.g1_mul_rows(pw, kw)
        want, p_ms = plain_timed(lambda: st.g1_mul_plain(pw, kw))
        if not torch.equal(got, want):
            fail(f"g1_mul rows={rows} disagrees with its plain version")
        ms = timed(lambda: st.g1_mul_rows(pw, kw), 10)
        bound = bound_ms(mul_products(pts, ks), rows * (2 * POINT_BYTES + SCALAR_BYTES))
        stats.setdefault("g1_mul", {})[rows] = (ms, p_ms, max_abs_err(got, want), bound)
        # g1_addsub: P-P, P+P, P+(-P), infinity operands, both flags
        p0, p1 = pool[3], pool[4]
        A = rand_points(rows, [p0, p0, None, p1, None, p0])
        B = rand_points(rows, [p0, hm.g1_neg(p0), p1, None, None, hm.g1_neg(p0)])
        aw = redundant(torch.from_numpy(cv.encode_points(A)), range(6, 12)).to(dev)
        bw = torch.from_numpy(cv.encode_points(B)).to(dev)
        for negate in (False, True):
            got = st.g1_sub_rows(aw, bw) if negate else st.g1_add_rows(aw, bw)
            want, p_ms = plain_timed(lambda: st.g1_addsub_plain(aw, bw, negate))
            if not torch.equal(got, want):
                fail(f"g1_addsub negate_b={negate} rows={rows} disagrees with its plain version")
        ms = timed(lambda: st.g1_sub_rows(aw, bw), 200)
        finite = sum(1 for a, b in zip(A, B) if a is not None and b is not None)
        bound = bound_ms(finite * FP_MULS_ADD, rows * 3 * POINT_BYTES)
        stats.setdefault("g1_addsub", {})[rows] = (ms, p_ms, max_abs_err(got, want), bound)
        say("kernels", f"rows={rows}: g1_msm (nbases 1/2/3), g1_mul, g1_addsub (both flags) "
            f"equal their plain versions exactly; ms/launch " + ", ".join(
                f"{k} {v[rows][0]:.4f}" for k, v in stats.items()) + f" [{card}]")

    # ---------------------------------------------------------------- edges
    # the range path's kernels against their plain versions at a small
    # row count, on the edges: infinity operands, P+P and P-P, scalars 0,
    # 1 and r-1, a (0, 0) Miller leg, a masked leg, values in [p, 2p)
    def check(name, got, want):
        if not torch.equal(got, want):
            fail(f"{name} disagrees with its plain version on the edge rows "
                 f"(max |err| {max_abs_err(got, want)})")

    n = 32
    g1j = st.g1_add_rows(*(torch.from_numpy(cv.encode_points(rand_points(n, []))).to(dev),) * 2)
    g1j[:2] = torch.from_numpy(cv.encode_points([None, None])).to(dev)  # infinity rows
    g1j = redundant(g1j, range(2, 8))
    check("g1_to_affine", st.g1_to_affine_rows(g1j), st.g1_to_affine_plain(g1j))
    q0, q1 = pool2[0], pool2[1]
    g2p = redundant(torch.from_numpy(cv2.encode_points(rand_points(n, [q0, q1, q0, None], pool2))).to(dev),
                    range(4, 9))
    ks = [0, 1, hm.R - 1, 5] + [rng.randrange(hm.R) for _ in range(n - 4)]
    g2k = torch.from_numpy(cv.encode_scalars(ks)).to(dev)
    g2m = st.g2_mul_rows(g2p, g2k)
    check("g2_mul", g2m, st.g2_mul_plain(g2p, g2k))
    A = rand_points(n, [q0, q0, None, q1, None, q1], pool2)
    B = [q0, hm.g2_neg(q0), q1, None, None, hm.g2_neg(q1)]
    ga = redundant(torch.from_numpy(cv2.encode_points(A)).to(dev), range(6, 10))
    gb = redundant(g2m, range(10, 14))
    gb[: len(B)] = torch.from_numpy(cv2.encode_points(B)).to(dev)
    g2s = st.g2_add_rows(ga, gb)
    check("g2_add", g2s, st.g2_add_plain(ga, gb))
    g2s = redundant(g2s, range(6, 10))
    check("g2_to_affine", st.g2_to_affine_rows(g2s), st.g2_to_affine_plain(g2s))
    legs = 2 * n
    mP = torch.from_numpy(pr.encode_g1([None] + rand_points(legs - 1, []))).to(dev)  # leg 0: (0, 0)
    mP = redundant(mP, range(1, 5))
    mQ = redundant(torch.from_numpy(pr.encode_g2(rand_points(legs, [], pool2))).to(dev), range(3, 7))
    mf = st.miller_rows(mP, mQ)
    check("miller", mf, st.miller_plain(mP, mQ))
    ff = mf.reshape(legs // 4, 4, 6, 2, lb.NWORDS).clone()
    ff[0, 1] = torch.from_numpy(tw.fp12_one_np()).to(dev)  # a masked leg's GT one
    ff = redundant(ff.reshape(legs // 4, -1, lb.NWORDS), range(1, 3)).reshape(ff.shape).contiguous()
    gp = st.gt_product_rows(ff)
    check("gt_product", gp, st.gt_product_plain(ff))
    gp[0] = ff[0, 1]  # a row that is GT one
    check("final_exp", st.final_exp_rows(gp), st.final_exp_plain(gp))
    mask = torch.zeros((8, 4), dtype=torch.bool)
    mask[0, 0] = mask[3, 2] = True
    Ps, Qs = mP[:32].reshape(8, 4, 2, lb.NWORDS), mQ[:32].reshape(8, 4, 2, 2, lb.NWORDS)
    staged = pr.pairing_product_staged(Ps, Qs, inf_mask=mask.numpy())
    check("pairing_product_staged (masked legs)", staged,
          pr.pairing_product_staged(Ps.cpu(), Qs.cpu(), inf_mask=mask.numpy()).to(dev))
    say("edges", f"g1_to_affine, g2_mul, g2_add, g2_to_affine ({n} rows), miller ({legs} legs), "
        f"gt_product, final_exp and a masked pairing product equal their plain versions "
        f"exactly on infinity operands, P+P, P-P, scalars 0/1/r-1, a (0, 0) leg, GT one and "
        f"values in [p, 2p)")

    # ---------------------------------------------------------------- slice
    t0 = time.perf_counter()
    pp = setup(base=16, exponent=2, rng=rng)

    def make_txs(count):
        txs = []
        for _ in range(count):
            v = rng.randrange(1, 1 << 8)
            ins, inw = tok.tokens_with_witness([v], "USD", pp.ped_params, rng)
            outs, outw = tok.tokens_with_witness([v], "USD", pp.ped_params, rng)
            txs.append((ins, outs, tr.TransferProver(inw, outw, ins, outs, pp, rng).prove()))
        # plant a bumped sum_resp, a swapped output commitment and
        # truncated bytes in the middle of the batch
        mid = count // 2
        p = tr.TransferProof.from_bytes(txs[mid][2])
        w = wfm.TransferWF.from_bytes(p.wf)
        w.sum_resp = (w.sum_resp + 1) % hm.R
        txs[mid] = (txs[mid][0], txs[mid][1], tr.TransferProof(w.to_bytes(), None).to_bytes())
        txs[mid + 1] = (txs[mid + 1][0], txs[mid + 2][1], txs[mid + 1][2])
        txs[mid + 3] = (txs[mid + 3][0], txs[mid + 3][1], txs[mid + 3][2][:-9])
        return txs, {mid, mid + 1, mid + 3}

    block, bad_block = make_txs(BLOCK_TXS)
    batch, bad_batch = make_txs(BATCH_TXS)
    t_prove = time.perf_counter() - t0

    def host_verdicts(txs):
        out = []
        for ins, outs, raw in txs:
            try:
                tr.TransferVerifier(ins, outs, pp).verify(raw)
                out.append(True)
            except Exception:
                out.append(False)
        return out

    host_block, host_batch = host_verdicts(block), host_verdicts(batch)
    for host, bad, n in ((host_block, bad_block, BLOCK_TXS), (host_batch, bad_batch, BATCH_TXS)):
        if [i for i in range(n) if not host[i]] != sorted(bad):
            fail("host verifier does not reject exactly the planted rows")
    verifier = BatchedTransferVerifier(pp, device="cuda")

    for k in _build.ALL_KERNELS:
        k.launches = 0
    t = time.perf_counter()
    got_block = verifier.verify(block)
    t_block = time.perf_counter() - t
    t = time.perf_counter()
    got_batch = verifier.verify(batch)
    t_batch = time.perf_counter() - t
    launches = {k.name: k.launches for k in _build.WF_KERNELS}

    if got_block.tolist() != host_block or got_batch.tolist() != host_batch:
        fail("BatchedTransferVerifier on cuda disagrees with the host TransferVerifier")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the verify path")
    if _build.G1_MSM_SELECT.launches:
        fail("the verify path launched the select multiexp")
    say("slice", f"proved {BLOCK_TXS}+{BATCH_TXS} 1-in/1-out transfers in {t_prove:.1f} s; "
        f"first verify: {BLOCK_TXS}-tx block {t_block * 1e3:.1f} ms, {BATCH_TXS}-tx batch "
        f"{t_batch * 1e3:.1f} ms; planted rows rejected, verdicts equal the host verifier's "
        f"on all {BLOCK_TXS + BATCH_TXS} rows; launches {launches} [{card}]")

    def medians(tag, cases, run=None, what="verify", unit="tx"):
        """Repeated verifies on the warm verifier (or calls of `run`):
        median and spread."""
        run = run or verifier.verify
        out = {}
        for txs, reps in cases:
            walls = []
            for _ in range(reps):
                t = time.perf_counter()
                run(txs)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            walls.sort()
            med = statistics.median(walls)
            out[len(txs)] = med
            say("throughput", f"{tag} {len(txs)}-{unit} {what} over {reps} runs: median "
                f"{med * 1e3:.1f} ms ({len(txs) / med:.1f} {unit}/s), min {walls[0] * 1e3:.1f} ms, "
                f"max {walls[-1] * 1e3:.1f} ms [{card}]")
        return out

    medians("1-in/1-out", zip((block, batch), VERIFY_REPS["1-in/1-out"]))

    def breakdown(tag, run, kernels, span_names, what="verify"):
        """One call of `run` (a verify or a prove) with spans on and CUDA
        events around each launch of `kernels`; returns the launch names
        of that call."""
        events = []

        def with_events(kernel):
            launch = kernel.launch

            def timed_launch(device, *args):
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                launch(device, *args)
                ev[1].record()
                events.append((kernel.name, ev))
            return timed_launch

        mx.enable(True)
        mx.REGISTRY.reset()
        for k in kernels:
            k.launch = with_events(k)
        try:
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t
        finally:
            for k in kernels:
                del k.launch
            mx.enable(False)
        spans = mx.REGISTRY.span_summary()
        torch.cuda.synchronize()
        kernel_ms = {}
        for name, (start, end) in events:
            kernel_ms[name] = kernel_ms.get(name, 0.0) + start.elapsed_time(end)
        busy_ms = sum(kernel_ms.values())
        say("breakdown", f"{tag} {what} {t_prof * 1e3:.1f} ms: " + ", ".join(
            f"{name.split('.', 1)[-1]} {spans[name]['total_s'] * 1e3:.1f} ms"
            for name in span_names if name in spans) + f"; kernels in this {what.split()[-1]} "
            "by CUDA events " + ", ".join(f"{name} {ms:.3f} ms" for name, ms in kernel_ms.items())
            + f", {busy_ms:.1f} ms in all ({len(events)} launches): no kernel running for "
            f"{100 * (1 - busy_ms / (t_prof * 1e3)):.1f}% of the {what.split()[-1]} [{card}]")
        return [name for name, _ in events]

    wf_spans = ("batch.transfer.verify", "batch.wf.parse", "batch.wf.encode",
                "batch.wf.device", "batch.wf.decode", "batch.wf.challenge")
    names = breakdown("1-in/1-out", lambda: verifier.verify(batch), _build.WF_KERNELS, wf_spans,
                      f"{len(batch)}-tx verify")
    if sorted(names) != sorted(k.name for k in _build.WF_KERNELS):
        fail(f"profiled 1-in/1-out verify launched {names}")

    # ---------------------------------------------------------------- range slice
    t0 = time.perf_counter()
    rblock = []
    for _ in range(BLOCK_TXS):
        vals = [rng.randrange(1, 1 << 7) for _ in range(2)]
        ins, inw = tok.tokens_with_witness(vals, "USD", pp.ped_params, rng)
        split = rng.randrange(0, sum(vals) + 1)
        outs, outw = tok.tokens_with_witness([split, sum(vals) - split], "USD", pp.ped_params, rng)
        rblock.append((ins, outs, tr.TransferProver(inw, outw, ins, outs, pp, rng).prove()))
    t_rprove = time.perf_counter() - t0

    def edit_range(raw, edit):
        p = tr.TransferProof.from_bytes(raw)
        r = RangeProof.from_bytes(p.range_correctness)
        edit(r)
        return tr.TransferProof(p.wf, r.to_bytes()).to_bytes()

    def bump_value(r):
        r.membership_proofs[0][1].value_resp = (r.membership_proofs[0][1].value_resp + 1) % hm.R

    def swap_digits(r):
        r.digit_commitments[1][0], r.digit_commitments[1][1] = (
            r.digit_commitments[1][1], r.digit_commitments[1][0])

    def bump_challenge(r):
        r.challenge = (r.challenge + 1) % hm.R

    plants = {
        "membership value_resp bumped": lambda raw: edit_range(raw, bump_value),
        "digit commitments swapped": lambda raw: edit_range(raw, swap_digits),
        "range challenge bumped": lambda raw: edit_range(raw, bump_challenge),
        "range bytes truncated": lambda raw: tr.TransferProof(
            tr.TransferProof.from_bytes(raw).wf,
            tr.TransferProof.from_bytes(raw).range_correctness[:-7]).to_bytes(),
        "range proof missing": lambda raw: tr.TransferProof(
            tr.TransferProof.from_bytes(raw).wf, None).to_bytes(),
    }
    bad_rows = []
    for j, plant in enumerate(plants.values()):
        i = 1 + j * max(1, BLOCK_TXS // len(plants) - 1)
        rblock[i] = (rblock[i][0], rblock[i][1], plant(rblock[i][2]))
        bad_rows.append(i)
    rbatch = rblock * RANGE_COPIES
    t = time.perf_counter()
    host_r = host_verdicts(rblock)
    t_rhost = time.perf_counter() - t
    if [i for i in range(BLOCK_TXS) if not host_r[i]] != bad_rows:
        fail("host verifier does not reject exactly the planted range rows")

    # record what the verify hands each range kernel (first call a verify)
    captured = {}
    originals = {name: getattr(st, f"{name}_rows") for name in RANGE_KERNELS}

    def capturing(name):
        fn = originals[name]

        def wrapper(*a, **kw):
            captured.setdefault(name, tuple(x.clone() for x in a))
            return fn(*a, **kw)
        return wrapper

    def verify_counted(txs):
        """One verify with every count set to 0 just before it and read
        just after, recording each range kernel's inputs."""
        captured.clear()
        for name in RANGE_KERNELS:
            setattr(st, f"{name}_rows", capturing(name))
        for k in _build.ALL_KERNELS:
            k.launches = 0
        try:
            t = time.perf_counter()
            got = verifier.verify(txs)
            wall = time.perf_counter() - t
        finally:
            for name, fn in originals.items():
                setattr(st, f"{name}_rows", fn)
        counts = {k.name: k.launches for k in _build.ALL_KERNELS}
        if counts != RANGE_LAUNCHES:
            fail(f"a {len(txs)}-tx 2-in/2-out verify launched {counts}, expected {RANGE_LAUNCHES}")
        return got, wall, counts, dict(captured)

    got_rblock, t_rblock, launches_r, inputs_block = verify_counted(rblock)
    got_rbatch, t_rbatch, launches_rb, inputs_batch = verify_counted(rbatch)
    if got_rblock.tolist() != host_r:
        fail(f"2-in/2-out block verdicts {got_rblock.tolist()} differ from the host verifier's")
    if got_rbatch.tolist() != host_r * RANGE_COPIES:
        fail("2-in/2-out batch verdicts differ from their source rows' host verdicts")
    say("range", f"proved {BLOCK_TXS} distinct 2-in/2-out transfers in {t_rprove:.1f} s, host "
        f"verify {t_rhost:.1f} s; planted rows {bad_rows} ({', '.join(plants)}) rejected; "
        f"first verify: {BLOCK_TXS}-tx block {t_rblock * 1e3:.1f} ms, {len(rbatch)}-tx batch "
        f"({RANGE_COPIES} copies) {t_rbatch * 1e3:.1f} ms; verdicts equal the host's on every "
        f"row; launches a verify {launches_r} [{card}]")

    # ---------------------------------------------------------------- range kernels
    # each range kernel on the very inputs the verify gave it: held against
    # its plain version at the block's shapes, timed at both sizes
    def finite(points):
        """1 for a row whose Z is not 0, None at infinity (G1 or G2)."""
        return [1 if bool(z.any()) else None for z in points[:, 2].cpu()]

    def repeats(name, big, got) -> bool:
        """The batch is RANGE_COPIES copies of the block, so a kernel's
        output at the batch's rows repeats its block output (g1_to_affine
        takes three stacked parts, each repeated)."""
        parts = 3 if name == "g1_to_affine" else 1
        shape = tuple(got.shape[1:])
        b = big.reshape((parts, RANGE_COPIES, -1) + shape)
        g = got.reshape((parts, 1, -1) + shape)
        return b.shape[2] == g.shape[2] and torch.equal(b, g.expand_as(b))

    def bound_of(name, a):
        rows = a[0].shape[0]
        if name == "g1_to_affine":
            fin = sum(1 for x in finite(a[0]) if x)
            # batch trick, then Z^-2, X Z^-2, Y Z^-2, times Z^-1
            prods = (BATCH_INV_PER_ROW + 4) * fin + (INV_PRODUCTS if fin else 0)
            return bound_ms(prods, rows * (POINT_BYTES + 2 * SCALAR_BYTES))
        if name == "g2_mul":
            ks = lb.batch_words_to_ints(a[1])
            prods = mul_products(finite(a[0]), ks, G2_MULS_WINDOW_TABLE, G2_MULS_DOUBLE, G2_MULS_ADD)
            return bound_ms(prods, rows * (2 * G2_BYTES + SCALAR_BYTES))
        if name == "g2_add":
            fin = sum(1 for x, y in zip(finite(a[0]), finite(a[1])) if x and y)
            return bound_ms(fin * G2_MULS_ADD, rows * 3 * G2_BYTES)
        if name == "g2_to_affine":
            fin = sum(1 for x in finite(a[0]) if x)
            # batch trick over Fp2 (9 a row), one Fp2 inverse, then
            # Z^-2 (2), X Z^-2 (3), Y Z^-1 (3), times Z^-2 (3)
            prods = 20 * fin + (INV_PRODUCTS + 4 if fin else 0)
            return bound_ms(prods, rows * (G2_BYTES + 2 * FP2_BYTES))
        if name == "miller":
            return bound_ms(miller_products(rows), rows * (2 * SCALAR_BYTES + 2 * FP2_BYTES + FP12_BYTES))
        if name == "gt_product":
            k = a[0].shape[1]
            return bound_ms(rows * (k - 1) * FP12_MUL, rows * (k + 1) * FP12_BYTES)
        return bound_ms(rows * FEXP_PER_ROW + FP12_INV, rows * 2 * FP12_BYTES)  # final_exp

    range_stats = {}
    for name in RANGE_KERNELS:
        fn, plain = originals[name], getattr(st, f"{name}_plain")
        ab, abig = inputs_block[name], inputs_batch[name]
        got = fn(*ab)
        want, p_ms = plain_timed(lambda: plain(*ab))
        if not torch.equal(got, want):
            fail(f"{name} disagrees with its plain version on the verify's inputs "
                 f"(max |err| {max_abs_err(got, want)})")
        big = fn(*abig)
        reps = 3 if name in ("miller", "final_exp", "g2_mul") else 20
        range_stats[name] = {
            "rows_block": ab[0].shape[0], "rows_batch": abig[0].shape[0],
            "ms_block": timed(lambda: fn(*ab), reps), "ms_batch": timed(lambda: fn(*abig), reps),
            "plain_ms": p_ms, "max_abs_err": max_abs_err(got, want),
            "bound_block": bound_of(name, ab), "bound_batch": bound_of(name, abig),
        }
        if not repeats(name, big, got):
            fail(f"{name} at the batch's rows does not repeat its block output")
    say("range-kernels", "ms at block/batch rows: " + ", ".join(
        f"{k} {v['rows_block']}/{v['rows_batch']} rows {v['ms_block']:.3f}/{v['ms_batch']:.3f} ms "
        f"(bound {v['bound_block'][0]:.4f}/{v['bound_batch'][0]:.4f}, plain {v['plain_ms']:.0f})"
        for k, v in range_stats.items()) + f"; each equals its plain version exactly on the "
        f"block verify's inputs and repeats that output on the batch's [{card}]")

    range_medians = medians("2-in/2-out", zip((rblock, rbatch), VERIFY_REPS["2-in/2-out"]))
    range_spans = wf_spans + ("batch.membership.verify", "batch.range.parse", "batch.range.device",
                              "batch.range.decode", "batch.range.challenge")
    names = breakdown("2-in/2-out", lambda: verifier.verify(rbatch), _build.PATH_KERNELS,
                      range_spans, f"{len(rbatch)}-tx verify")
    want_names = sorted(n for n, c in RANGE_LAUNCHES.items() for _ in range(c))
    if sorted(names) != want_names:
        fail(f"profiled 2-in/2-out verify launched {sorted(names)}")

    # ---------------------------------------------------------------- prove
    def prove_reqs(count, in_vals, out_vals):
        """`count` distinct prove requests (in_witnesses, out_witnesses,
        inputs, outputs) of the given values."""
        reqs = []
        for _ in range(count):
            ins, inw = tok.tokens_with_witness(in_vals, "USD", pp.ped_params, rng)
            outs, outw = tok.tokens_with_witness(out_vals, "USD", pp.ped_params, rng)
            reqs.append((inw, outw, ins, outs))
        return reqs

    t0 = time.perf_counter()
    preq_block = prove_reqs(BLOCK_TXS, [100, 55], [120, 35])
    preq_batch = prove_reqs(BATCH_TXS, [100, 55], [120, 35])
    preq_wf = prove_reqs(BLOCK_TXS, [100], [100])
    t_reqs = time.perf_counter() - t0
    t0 = time.perf_counter()
    prover_for(pp, device="cuda")  # the window tables, built once
    t_tables = time.perf_counter() - t0

    def prove(reqs):
        return tr.TransferProver.batch(reqs, pp, rng=rng, min_batch=1, device="cuda")

    # stage wrapper of each kernel held against its plain version below
    prove_capture = {"g1_msm_select": "g1_msm_select_rows", "g1_add": "g1_add_rows",
                     "gt_product_k2": "gt_product_rows"}

    def prove_counted(reqs, expect):
        """One prove with every count set to 0 just before it and read just
        after, recording the inputs of the select multiexps, the add and
        the GT product."""
        captured = {name: [] for name in prove_capture}
        saved = {name: getattr(st, fn) for name, fn in prove_capture.items()}

        def recording(name):
            fn = saved[name]

            def wrapper(*a, **kw):
                captured[name].append(tuple(x.clone() for x in a))
                return fn(*a, **kw)
            return wrapper

        for name, fn in prove_capture.items():
            setattr(st, fn, recording(name))
        for k in _build.ALL_KERNELS:
            k.launches = 0
        try:
            t = time.perf_counter()
            proofs = prove(reqs)
            wall = time.perf_counter() - t
        finally:
            for name, fn in prove_capture.items():
                setattr(st, fn, saved[name])
        counts = {k.name: k.launches for k in _build.ALL_KERNELS}
        if counts != expect:
            fail(f"a {len(reqs)}-tx prove launched {counts}, expected {expect}")
        return proofs, wall, counts, captured

    proofs_block, t_pblock, launches_p, pin_block = prove_counted(preq_block, PROVE_LAUNCHES)
    proofs_batch, t_pbatch, launches_pb, pin_batch = prove_counted(preq_batch, PROVE_LAUNCHES)
    proofs_wf, t_pwf, launches_pwf, _ = prove_counted(preq_wf, PROVE_WF_LAUNCHES)

    # acceptance: the host verifier on every proof of the 64-tx groups,
    # the batched verifier on the card on all of them
    t = time.perf_counter()
    for reqs, proofs in ((preq_block, proofs_block), (preq_wf, proofs_wf)):
        for (_, _, ins, outs), raw in zip(reqs, proofs):
            try:
                tr.TransferVerifier(ins, outs, pp).verify(raw)
            except Exception as exc:  # noqa: BLE001
                fail(f"the host verifier rejects a proof made on the card: {exc}")
    t_phost = time.perf_counter() - t

    def bump_wf(raw):
        p = tr.TransferProof.from_bytes(raw)
        w = wfm.TransferWF.from_bytes(p.wf)
        w.sum_resp = (w.sum_resp + 1) % hm.R
        return tr.TransferProof(w.to_bytes(), p.range_correctness).to_bytes()

    planted = [(preq_block[0], bump_wf(proofs_block[0])),
               (preq_block[1], edit_range(proofs_block[1], bump_value)),
               (preq_wf[0], bump_wf(proofs_wf[0]))]
    for (_, _, ins, outs), raw in planted:
        try:
            tr.TransferVerifier(ins, outs, pp).verify(raw)
        except Exception:  # noqa: BLE001
            continue
        fail("the host verifier accepts a tampered proof")

    def as_txs(reqs, proofs):
        return [(r[2], r[3], raw) for r, raw in zip(reqs, proofs)]

    t = time.perf_counter()
    got = verifier.verify(as_txs([q for q, _ in planted[:2]], [raw for _, raw in planted[:2]])
                          + as_txs(preq_batch, proofs_batch))
    t_pverify = time.perf_counter() - t
    if got.tolist() != [False, False] + [True] * BATCH_TXS:
        fail(f"batched verify of the {BATCH_TXS} proofs made on the card: "
             f"{int((~got[2:]).sum())} rejected, planted rows {got[:2].tolist()}")
    if verifier.verify(as_txs(preq_block, proofs_block)).tolist() != [True] * BLOCK_TXS:
        fail("the batched verifier rejects a proof of the 64-tx group")
    got = verifier.verify(as_txs(preq_wf[:1], [planted[2][1]]) + as_txs(preq_wf, proofs_wf))
    if got.tolist() != [False] + [True] * BLOCK_TXS:
        fail("1-in/1-out proofs made on the card: batched verdicts are wrong")
    # the same group and seed proved by the plain versions on the CPU
    small, seed = prove_reqs(2, [100, 55], [120, 35]), rng.getrandbits(64)
    t = time.perf_counter()
    on_card = tr.TransferProver.batch(small, pp, rng=random.Random(seed), min_batch=1,
                                      device="cuda")
    on_cpu = tr.TransferProver.batch(small, pp, rng=random.Random(seed), min_batch=1,
                                     device="cpu")
    t_cpu = time.perf_counter() - t
    if on_card != on_cpu:
        fail("proofs made on the card differ from the plain versions' on the CPU")
    say("prove", f"made {BLOCK_TXS}+{BATCH_TXS} 2-in/2-out and {BLOCK_TXS} 1-in/1-out prove "
        f"requests in {t_reqs:.1f} s, prover tables {t_tables:.1f} s; first prove: "
        f"{BLOCK_TXS}-tx {t_pblock * 1e3:.1f} ms, {BATCH_TXS}-tx {t_pbatch * 1e3:.1f} ms, "
        f"1-in/1-out {BLOCK_TXS}-tx {t_pwf * 1e3:.1f} ms; the host verifier accepts all "
        f"{2 * BLOCK_TXS} of the 64-tx groups ({t_phost:.1f} s), the batched verifier all "
        f"{BATCH_TXS} of the backlog ({t_pverify * 1e3:.1f} ms) and the 64-tx groups; a bumped "
        f"WF response and a bumped membership response are rejected by both; 2 txs proved on "
        f"the card and by the plain versions on the CPU from one seed: byte-identical "
        f"({t_cpu:.1f} s); launches a 2-in/2-out prove {launches_p}, a 1-in/1-out prove "
        f"{ {k: v for k, v in launches_pwf.items() if v} } [{card}]")

    # the kernels of the prove that the verify did not run, on the prove's
    # own inputs: held against their plain versions at the block's rows,
    # timed at both sizes
    plains = {"g1_msm_select": st.g1_msm_select_plain,
              "g1_add": lambda a, b: st.g1_addsub_plain(a, b, False),
              "gt_product_k2": st.gt_product_plain}

    def prove_bound(name, a):
        rows = a[-1].shape[0]
        if name == "g1_msm_select":
            table, scal = a
            nb = scal.shape[1]
            ks = lb.batch_words_to_ints(scal)
            return bound_ms(msm_products(ks[r * nb:(r + 1) * nb] for r in range(rows)),
                            table.numel() * 4 + rows * (nb * SCALAR_BYTES + POINT_BYTES))
        if name == "g1_add":
            fin = sum(1 for x, y in zip(finite(a[0]), finite(a[1])) if x and y)
            return bound_ms(fin * FP_MULS_ADD, rows * 3 * POINT_BYTES)
        return bound_of("gt_product", a)

    prove_stats = {}
    for name, wrapper in prove_capture.items():
        fn = getattr(st, wrapper)
        calls = []
        for ab, abig in zip(pin_block[name], pin_batch[name]):
            got = fn(*ab)
            want, p_ms = plain_timed(lambda: plains[name](*ab))
            if not torch.equal(got, want):
                fail(f"{name} disagrees with its plain version on the prove's inputs "
                     f"(max |err| {max_abs_err(got, want)})")
            big = fn(*abig)
            # at the batch's rows against the gather kernel (itself held
            # against the plain version above) or the plain version
            ref = st.g1_msm_rows(*abig) if name == "g1_msm_select" else plains[name](*abig)
            if not torch.equal(big, ref):
                fail(f"{name} at the batch's rows disagrees with its reference")
            reps = 10 if name == "g1_msm_select" else 50
            calls.append({
                "rows_block": ab[-1].shape[0], "rows_batch": abig[-1].shape[0],
                "nbases": ab[1].shape[1] if name == "g1_msm_select" else None,
                "ms_block": timed(lambda: fn(*ab), reps),
                "ms_batch": timed(lambda: fn(*abig), reps),
                "plain_ms": p_ms, "max_abs_err": max_abs_err(got, want),
                "bound_block": prove_bound(name, ab), "bound_batch": prove_bound(name, abig),
            })
        prove_stats[name] = calls
    # the select kernel on zero and on random scalars, beside the gather,
    # at the WF multiexp's rows (the ped3 table)
    zero_random = {}
    for tag, (table, scal) in (("block", pin_block["g1_msm_select"][0]),
                               ("batch", pin_batch["g1_msm_select"][0])):
        zero = torch.zeros_like(scal)
        zero_random[tag] = {
            "rows": scal.shape[0],
            "select_zero": timed(lambda: st.g1_msm_select_rows(table, zero), 10),
            "select_random": timed(lambda: st.g1_msm_select_rows(table, scal), 10),
            "gather_zero": timed(lambda: st.g1_msm_rows(table, zero), 10),
            "gather_random": timed(lambda: st.g1_msm_rows(table, scal), 10),
        }
    say("prove-kernels", "; ".join(
        f"{name} " + ", ".join(
            f"{c['rows_block']}/{c['rows_batch']} rows"
            + (f" x{c['nbases']}" if c["nbases"] else "")
            + f" {c['ms_block']:.3f}/{c['ms_batch']:.3f} ms (bound {c['bound_block'][0]:.4f}/"
            f"{c['bound_batch'][0]:.4f}, plain {c['plain_ms']:.0f})" for c in calls)
        for name, calls in prove_stats.items()) + "; each equals its plain version exactly on "
        "the 64-tx prove's inputs; g1_msm_select ms on zero / random scalars, gather beside it: "
        + ", ".join(f"{v['rows']} rows select {v['select_zero']:.3f} / {v['select_random']:.3f}, "
                    f"gather {v['gather_zero']:.3f} / {v['gather_random']:.3f}"
                    for v in zero_random.values()) + f" [{card}]")

    prove_medians = medians("2-in/2-out", zip((preq_block, preq_batch), PROVE_REPS), run=prove,
                            what="prove")
    prove_medians_wf = medians("1-in/1-out", [(preq_wf, PROVE_REPS[0])], run=prove, what="prove")
    prove_spans = ("batch.prove", "batch.prove.wf", "batch.prove.range", "batch.prove.draw",
                   "batch.prove.device", "batch.prove.decode", "batch.prove.finish")
    names = breakdown("2-in/2-out", lambda: prove(preq_batch), _build.PROVE_KERNELS, prove_spans,
                      f"{BATCH_TXS}-tx prove")
    want_names = sorted(n for n, c in PROVE_LAUNCHES.items() for _ in range(c))
    if sorted(names) != want_names:
        fail(f"profiled 2-in/2-out prove launched {sorted(names)}")

    # ---------------------------------------------------------------- PS
    rp = pp.range_params
    signer = pssign.SignVerifier(rp.sign_pk, rp.Q)
    nvals = len(rp.signed_values)
    ps_msgs = [[i % nvals] for i in range(PS_SIGS)]
    ps_sigs = [signer.randomize(rp.signed_values[i % nvals], rng) for i in range(PS_SIGS)]
    # planted: a wrong message, R and S swapped, another value's
    # signature, a wrong message count, no signature
    ps_msgs[3] = [(ps_msgs[3][0] + 1) % nvals]
    ps_sigs[10] = pssign.Signature(ps_sigs[10].S, ps_sigs[10].R)
    ps_sigs[20] = ps_sigs[21]
    ps_msgs[30] = [1, 2]
    ps_sigs[40] = None
    ps_bad = [3, 10, 20, 30, 40]
    ps_host = []
    for m, sg in zip(ps_msgs, ps_sigs):
        try:
            signer.verify(m, sg)
            ps_host.append(True)
        except Exception:  # noqa: BLE001
            ps_host.append(False)
    if [i for i, ok in enumerate(ps_host) if not ok] != ps_bad:
        fail("the host PS verifier does not reject exactly the planted rows")
    ps_verifier = BatchedPSVerifier(rp.sign_pk, rp.Q, device="cuda")
    for k in _build.ALL_KERNELS:
        k.launches = 0
    t = time.perf_counter()
    ps_got = ps_verifier.verify(ps_msgs, ps_sigs)
    t_ps = time.perf_counter() - t
    launches_ps = {k.name: k.launches for k in _build.ALL_KERNELS}
    if launches_ps != PS_LAUNCHES:
        fail(f"a PS verify launched {launches_ps}, expected {PS_LAUNCHES}")
    if ps_got.tolist() != ps_host:
        fail(f"BatchedPSVerifier verdicts differ from the host's: {ps_got.tolist()}")
    ps_medians = medians("PS", [(ps_sigs, PROVE_REPS[0])],
                         run=lambda sigs: ps_verifier.verify(ps_msgs, sigs), unit="sig")
    say("ps", f"{PS_SIGS} signatures (the signed set, randomised; planted rows {ps_bad}: a "
        f"wrong message, R and S swapped, another value's signature, a wrong message count, "
        f"no signature): verdicts equal the host's; first verify {t_ps * 1e3:.1f} ms; launches "
        f"{ {k: v for k, v in launches_ps.items() if v} } [{card}]")

    # ---------------------------------------------------------------- mesh
    # The mesh plane on logical meshes of this one card: every cell of a
    # (dp = 2, mp = 2) mesh, and the (1, 1) mesh, on cuda:0. First the
    # fused pairing product (csrc/pairing_fused.cu) in both modes against
    # its plain version and the staged launch sequence, then the plane's
    # entry points: sharded_pairing_product(fused=True) on both meshes,
    # sharded_schnorr_rows, BatchedSchnorrVerifier and multichip_torch.py.
    import multichip_torch
    from fabric_token_sdk_tpu_torch.crypto import sign as sgn
    from fabric_token_sdk_tpu_torch.crypto.batch_sign import BatchedSchnorrVerifier
    from fabric_token_sdk_tpu_torch.crypto.serialization import dumps, loads
    from fabric_token_sdk_tpu_torch.parallel import (
        make_mesh, sharded_pairing_product, sharded_schnorr_rows)

    mesh22 = make_mesh(4, mp=2, devices=[dev] * 4)
    mesh11 = make_mesh(1, devices=[dev])

    def staged_seq(P, Q):
        """The staged launch sequence miller -> gt_product -> final_exp."""
        b, k = P.shape[0], P.shape[1]
        f = st.miller_rows(P.reshape(b * k, 2, lb.NWORDS), Q.reshape(b * k, 2, 2, lb.NWORDS))
        return st.final_exp_rows(st.gt_product_rows(f.reshape(b, k, 6, 2, lb.NWORDS)))

    def miller_of(P, Q, mask=None):
        b, k = P.shape[0], P.shape[1]
        f = st.miller_rows(P.reshape(b * k, 2, lb.NWORDS), Q.reshape(b * k, 2, 2, lb.NWORDS))
        return st._mask_one(f.reshape(b, k, 6, 2, lb.NWORDS), mask).contiguous()

    def both_modes(tag, P, Q, want, mask=None):
        """Both modes and the staged sequence against `want`, exactly."""
        outs = {"pairing_product": st.pairing_product_rows(P, Q, mask),
                "gt_product_final_exp": st.gt_product_final_exp_rows(miller_of(P, Q, mask)),
                "staged": pr.pairing_product_staged(P, Q, mask)}
        for name, got in outs.items():
            if not torch.equal(got, want):
                fail(f"{name} disagrees with the plain pairing product on {tag} "
                     f"(max |err| {max_abs_err(got, want)})")
        return max(max_abs_err(o, want) for o in outs.values())

    # edge rows: K = 1, 2, 4, a (0, 0) leg unmasked and masked, a finite
    # leg masked, values in [p, 2p); the plain results of every group by
    # one plain Miller call and one plain final exponentiation on the CPU
    edge = {}
    n_edge = 4
    for k in (1, 2, 4):
        legs_P = rand_points(n_edge * k, [None])  # leg 0: (0, 0)
        eP = redundant(torch.from_numpy(pr.encode_g1(legs_P)), range(1, 3))
        eQ = redundant(torch.from_numpy(pr.encode_g2(rand_points(n_edge * k, [], pool2))),
                       range(2, 4))
        mask = np.zeros((n_edge, k), dtype=bool)
        mask[0, 0] = True  # the (0, 0) leg masked
        mask[n_edge - 1, k - 1] = True  # a finite leg masked
        edge[k] = (eP.reshape(n_edge, k, 2, 8).to(dev), eQ.reshape(n_edge, k, 2, 2, 8).to(dev),
                   mask)
    t = time.perf_counter()
    all_P = torch.cat([eP.reshape(-1, 2, 8) for eP, _, _ in edge.values()]).cpu()
    all_Q = torch.cat([eQ.reshape(-1, 2, 2, 8) for _, eQ, _ in edge.values()]).cpu()
    f_plain = st.miller_plain(all_P, all_Q)
    prods, at = [], 0
    for k, (_, _, mask) in edge.items():
        fk = f_plain[at:at + n_edge * k].reshape(n_edge, k, 6, 2, lb.NWORDS)
        at += n_edge * k
        prods += [st.gt_product_plain(fk), st.gt_product_plain(st._mask_one(fk, mask))]
    gt_plain = st.final_exp_plain(torch.cat(prods)).to(dev)
    t_edge_plain = time.perf_counter() - t
    at = 0
    for k, (eP, eQ, mask) in edge.items():
        both_modes(f"edge rows K={k}", eP, eQ, gt_plain[at:at + n_edge])
        both_modes(f"edge rows K={k} masked", eP, eQ, gt_plain[at + n_edge:at + 2 * n_edge], mask)
        at += 2 * n_edge
    say("mesh", f"pairing_product and gt_product_final_exp (and the staged sequence) equal the "
        f"plain pairing product exactly on edge rows K = 1, 2, 4 (a (0, 0) leg unmasked and "
        f"masked, a finite leg masked, values in [p, 2p)); plain {t_edge_plain:.1f} s on the CPU")

    # the membership check's legs (the verify's own Miller inputs, K = 4)
    # and the PS verify's legs (K = 2) at the block's rows against the
    # plain version; at the batch's rows (copies of the block) against
    # the block's plain output repeated
    mem_P = inputs_block["miller"][0].reshape(-1, 4, 2, lb.NWORDS).contiguous()
    mem_Q = inputs_block["miller"][1].reshape(-1, 4, 2, 2, lb.NWORDS).contiguous()
    mem_Pb = inputs_batch["miller"][0].reshape(-1, 4, 2, lb.NWORDS).contiguous()
    mem_Qb = inputs_batch["miller"][1].reshape(-1, 4, 2, 2, lb.NWORDS).contiguous()
    ps_legs = {}
    staged_fn = pr.pairing_product_staged

    def grab(Ps, Qs, *a, **kw):
        ps_legs.setdefault("P", Ps.clone())
        ps_legs.setdefault("Q", Qs.clone())
        return staged_fn(Ps, Qs, *a, **kw)

    pr.pairing_product_staged = grab
    try:
        ps_verifier.verify(ps_msgs, ps_sigs)
    finally:
        pr.pairing_product_staged = staged_fn
    ps_P, ps_Q = ps_legs["P"].contiguous(), ps_legs["Q"].contiguous()
    copies = BATCH_TXS * ROWS_PER_TX // PS_SIGS
    ps_Pb = ps_P.repeat(copies, 1, 1, 1).contiguous()
    ps_Qb = ps_Q.repeat(copies, 1, 1, 1, 1).contiguous()
    sets = {"membership": (mem_P, mem_Q, mem_Pb, mem_Qb), "ps": (ps_P, ps_Q, ps_Pb, ps_Qb)}
    mesh_stats = {}
    for tag, (sP, sQ, sPb, sQb) in sets.items():
        if tag == "membership":  # the plain times of the kernels line, on the card
            want, p_ms = plain_timed(lambda: st.pairing_product_plain(sP, sQ))
            f_blk = miller_of(sP, sQ)
            _, p_tail_ms = plain_timed(lambda: st.gt_product_final_exp_plain(f_blk))
        else:
            t = time.perf_counter()
            want = st.pairing_product_plain(sP.cpu(), sQ.cpu()).to(dev)
            p_ms, p_tail_ms = (time.perf_counter() - t) * 1e3, None
        err = both_modes(f"the {tag} rows ({sP.shape[0]} x {sP.shape[1]})", sP, sQ, want)
        copies_of = sPb.shape[0] // sP.shape[0]
        err = max(err, both_modes(f"the {tag} batch rows ({sPb.shape[0]} x {sPb.shape[1]})",
                                  sPb, sQb, want.repeat(copies_of, 1, 1, 1)))
        fb, fbig = miller_of(sP, sQ), miller_of(sPb, sQb)
        k = sP.shape[1]
        row = {"k": k, "rows_block": sP.shape[0], "rows_batch": sPb.shape[0], "max_abs_err": err,
               "plain_ms": p_ms, "plain_tail_ms": p_tail_ms}
        for size, (PP, QQ, ff) in (("block", (sP, sQ, fb)), ("batch", (sPb, sQb, fbig))):
            b = PP.shape[0]
            row[f"ms_{size}"] = timed(lambda: st.pairing_product_rows(PP, QQ), 3)
            row[f"tail_ms_{size}"] = timed(lambda: st.gt_product_final_exp_rows(ff), 3)
            row[f"staged_ms_{size}"] = timed(lambda: staged_seq(PP, QQ), 3)
            ops_tail = b * (k - 1) * FP12_MUL + b * FEXP_PER_ROW + FP12_INV
            row[f"bound_{size}"] = bound_ms(
                miller_products(b * k) + ops_tail,
                b * k * (2 * SCALAR_BYTES + 2 * FP2_BYTES) + b * FP12_BYTES)
            row[f"tail_bound_{size}"] = bound_ms(ops_tail, b * (k + 1) * FP12_BYTES)
        mesh_stats[tag] = row
    say("mesh", "both modes equal the plain pairing product and the staged sequence exactly on "
        "the membership check's legs and the PS verify's legs; ms a launch at block/batch rows: "
        + "; ".join(
            f"{tag} {v['rows_block']}/{v['rows_batch']} x K={v['k']}: pairing_product "
            f"{v['ms_block']:.3f}/{v['ms_batch']:.3f} (bound {v['bound_block'][0]:.4f}/"
            f"{v['bound_batch'][0]:.4f}), gt_product_final_exp {v['tail_ms_block']:.3f}/"
            f"{v['tail_ms_batch']:.3f} (bound {v['tail_bound_block'][0]:.4f}/"
            f"{v['tail_bound_batch'][0]:.4f}), staged miller+gt_product+final_exp "
            f"{v['staged_ms_block']:.3f}/{v['staged_ms_batch']:.3f}, plain {v['plain_ms']:.0f}"
            for tag, v in mesh_stats.items()) + f" [{card}]")

    # stage 2 of the dry run: the PS checks through the fused sharded
    # product on both meshes (5 planted rows), each the main path of the
    # fused kernel's modes: counts set to 0 just before, read just after
    ps_staged = pr.pairing_product_staged(ps_P, ps_Q)
    fused_launches = {}
    for name, mesh, expect in (
            ("(2, 2)", mesh22, {"miller": 4, "gt_product_final_exp": 2}),
            ("(1, 1)", mesh11, {"pairing_product": 1})):
        for kk in _build.ALL_KERNELS:
            kk.launches = 0
        gt = sharded_pairing_product(ps_P, ps_Q, mesh, fused=True)
        counts = {kk.name: kk.launches for kk in _build.ALL_KERNELS if kk.launches}
        if counts != expect:
            fail(f"the fused sharded product on the {name} mesh launched {counts}, "
                 f"expected {expect}")
        fused_launches[name] = counts
        if not torch.equal(gt, ps_staged):
            fail(f"the fused sharded product on the {name} mesh differs from the staged path")
        if pr.gt_is_one_host(gt.cpu().numpy()).tolist() != ps_host:
            fail(f"fused sharded PS verdicts on the {name} mesh differ from the host's")
    for args_ in (["--fused"], []):
        rc = multichip_torch.main(["--logical", "--devices", "4", "--mp", "2", *args_])
        if rc != 0:
            fail(f"multichip_torch.py --logical --devices 4 --mp 2 {' '.join(args_)} exited {rc}")
    say("mesh", f"stage 2: {PS_SIGS} PS rows through sharded_pairing_product(fused=True): valid "
        f"rows accepted and planted rows {ps_bad} rejected on the (2, 2) and the (1, 1) mesh, "
        f"GT values equal the staged path's; launches {fused_launches}; multichip_torch.py "
        f"--logical --devices 4 --mp 2 passes fused and staged [{card}]")

    # stage 1: Schnorr rows over the mesh's 2 row groups against the
    # rows without a mesh, bit for bit
    s_bases, s_resp, s_stmts, s_chals = multichip_torch.schnorr_fixture(rng, 256)
    s_table = cv.FixedBaseTable(s_bases).to(dev)
    s_args = (torch.from_numpy(cv.encode_scalars([x for r in s_resp for x in r])
                               .reshape(-1, 3, lb.NWORDS)).to(dev),
              torch.from_numpy(cv.encode_points(s_stmts)).to(dev),
              torch.from_numpy(cv.encode_scalars(s_chals)).to(dev))
    for kk in _build.ALL_KERNELS:
        kk.launches = 0
    s_mesh = sharded_schnorr_rows(s_table, *s_args, mesh=mesh22)
    s_counts = {kk.name: kk.launches for kk in _build.ALL_KERNELS if kk.launches}
    if s_counts != {"g1_msm": 2, "g1_mul": 2, "g1_addsub": 2}:
        fail(f"sharded_schnorr_rows on the (2, 2) mesh launched {s_counts}")
    if not torch.equal(s_mesh, sharded_schnorr_rows(s_table, *s_args, mesh=None)):
        fail("sharded_schnorr_rows on the mesh differs from mesh=None")

    # BatchedSchnorrVerifier on 64 and 1,024 signatures with planted faults
    def schnorr_rows(count):
        keys = [sgn.keygen(rng) for _ in range(8)]
        rows = []
        for i in range(count):
            key = keys[i % len(keys)]
            msg = b"block %d tx %d" % (count, i)
            rows.append((key.public.point, msg, key.sign(msg, rng)))
        for i, edit in ((3, "c"), (7, "z")):
            d = loads(rows[i][2])
            d[edit] ^= 1 << (i % 5)
            rows[i] = (rows[i][0], rows[i][1], dumps(d))
        rows[11] = (rows[11][0], b"another message", rows[11][2])
        rows[15] = (keys[(15 + 1) % len(keys)].public.point, rows[15][1], rows[15][2])
        rows[19] = (rows[19][0], rows[19][1], b"\x00not a signature")
        return rows

    def host_sign_verdicts(rows):
        out = []
        for pk, msg, sig in rows:
            try:
                loads(sig)
            except Exception:  # noqa: BLE001
                out.append(None)
                continue
            try:
                sgn.PublicKey(pk).verify(msg, sig)
                out.append(True)
            except Exception:  # noqa: BLE001
                out.append(False)
        return out

    schnorr = BatchedSchnorrVerifier(device="cuda")
    schnorr_mesh = BatchedSchnorrVerifier(device="cuda", mesh=mesh22)
    sign_medians, sign_launches = {}, None
    for count in (BLOCK_TXS, BATCH_TXS):
        rows = schnorr_rows(count)
        want = host_sign_verdicts(rows)
        if [i for i, v in enumerate(want) if v is not True] != [3, 7, 11, 15, 19]:
            fail("the host Schnorr verifier does not reject exactly the planted rows")
        for kk in _build.ALL_KERNELS:
            kk.launches = 0
        got = schnorr.verify(rows)
        counts = {kk.name: kk.launches for kk in _build.ALL_KERNELS if kk.launches}
        if counts != {"g1_msm": 1, "g1_mul": 1, "g1_addsub": 1}:
            fail(f"a BatchedSchnorrVerifier call launched {counts}")
        sign_launches = counts
        if got != want or schnorr_mesh.verify(rows) != want:
            fail(f"BatchedSchnorrVerifier verdicts on {count} signatures differ from the host's")
        sign_medians.update(medians("Schnorr", [(rows, PROVE_REPS[0])], run=schnorr.verify,
                                    unit="sig"))
    say("mesh", f"stage 1: {len(s_stmts)} Schnorr rows over the (2, 2) mesh's 2 row groups "
        f"(launches {s_counts}) equal mesh=None bit for bit; BatchedSchnorrVerifier on "
        f"{BLOCK_TXS} and {BATCH_TXS} signatures (planted: c and z bit-flipped, message, pk, "
        f"an unparsable blob) equals the host PublicKey.verify, with and without the mesh; "
        f"launches a call {sign_launches} [{card}]")

    ptxas = {}
    lines = _build.BUILD_LOG.get("pairing_fused.cu", "").splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln:
            entry = "pairing_product" if "ILb1E" in ln else "gt_product_final_exp"
            ptxas[entry] = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 2:i + 4])
    say("mesh", f"pairing_fused.cu ptxas: {ptxas}")

    # ---------------------------------------------------------------- report
    kernels = []
    big, small = BATCH_TXS * ROWS_PER_TX, BLOCK_TXS * ROWS_PER_TX
    for k in _build.WF_KERNELS:
        ms, p_ms, err, (b_ms, b_by) = stats[k.name][big]
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"fabric_token_sdk_tpu_torch/csrc/{k.source}",
            "replaces": REPLACES[k.name], "launches": launches[k.name],
            "launches_2in2out_verify": launches_r[k.name],
            "launches_2in2out_prove": launches_p[k.name],
            "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "rows": big, "ms_at_256_rows": stats[k.name][small][0],
            "plain_ms_at_256_rows": stats[k.name][small][1],
            "bound_ms_at_256_rows": stats[k.name][small][3][0],
        })
    for name in RANGE_KERNELS:
        v, k = range_stats[name], kernels_by_name[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"fabric_token_sdk_tpu_torch/csrc/{k.source}",
            "replaces": REPLACES[name], "launches": launches_r[name],
            "launches_batch_verify": launches_rb[name],
            "launches_2in2out_prove": launches_p[name], "launches_ps_verify": launches_ps[name],
            "max_abs_err": v["max_abs_err"], "ms": v["ms_batch"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_batch"][0], "bound_by": v["bound_batch"][1], "library_ms": None,
            "rows": v["rows_batch"], "ms_block": v["ms_block"], "rows_block": v["rows_block"],
            "bound_ms_block": v["bound_block"][0], "plain_rows": v["rows_block"],
        })
    # the prove path's own rows: the select multiexp (its WF call, 3 bases,
    # stands for it; every call is listed), the add, the K = 2 product
    sources = {"g1_msm_select": "g1_msm.cu", "g1_add": "g1_addsub.cu",
               "gt_product_k2": "gt_product.cu"}
    kernel_of = {"g1_msm_select": "g1_msm_select", "g1_add": "g1_addsub",
                 "gt_product_k2": "gt_product"}
    for name, calls in prove_stats.items():
        c = calls[0]
        row = {
            "name": name, "route": "cuda",
            "source": f"fabric_token_sdk_tpu_torch/csrc/{sources[name]}",
            "replaces": REPLACES[name], "launches": launches_p[kernel_of[name]],
            "launches_batch_prove": launches_pb[kernel_of[name]],
            "max_abs_err": max(x["max_abs_err"] for x in calls), "ms": c["ms_batch"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_batch"][0],
            "bound_by": c["bound_batch"][1], "library_ms": None, "rows": c["rows_batch"],
            "ms_block": c["ms_block"], "rows_block": c["rows_block"],
            "bound_ms_block": c["bound_block"][0], "plain_rows": c["rows_block"],
            "calls": [{k: (v[0] if k.startswith("bound") else v) for k, v in x.items()}
                      for x in calls],
        }
        if name == "g1_msm_select":
            row["launches_1in1out_prove"] = launches_pwf[name]
            row["zero_vs_random_scalars_ms"] = zero_random
        kernels.append(row)
    # the mesh plane's kernel: both modes of pairing_fused.cu, at the
    # membership check's batch rows (K = 4); the PS rows beside them
    for name, launches_of, prefix in (("pairing_product", fused_launches["(1, 1)"], ""),
                                      ("gt_product_final_exp", fused_launches["(2, 2)"], "tail_")):
        v, vp = mesh_stats["membership"], mesh_stats["ps"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fabric_token_sdk_tpu_torch/csrc/pairing_fused.cu",
            "replaces": REPLACES[name], "launches": launches_of[name],
            "max_abs_err": max(v["max_abs_err"], vp["max_abs_err"]),
            "ms": v[f"{prefix}ms_batch"],
            "plain_ms": v["plain_ms"] if name == "pairing_product" else v["plain_tail_ms"],
            "bound_ms": v[f"{prefix}bound_batch"][0], "bound_by": v[f"{prefix}bound_batch"][1],
            "library_ms": None, "rows": v["rows_batch"], "k": v["k"],
            "ms_block": v[f"{prefix}ms_block"], "rows_block": v["rows_block"],
            "bound_ms_block": v[f"{prefix}bound_block"][0], "plain_rows": v["rows_block"],
            "staged_ms": v["staged_ms_batch"], "staged_ms_block": v["staged_ms_block"],
            "ps_rows": [vp["rows_block"], vp["rows_batch"]], "ps_k": vp["k"],
            "ps_ms": [vp[f"{prefix}ms_block"], vp[f"{prefix}ms_batch"]],
            "ps_bound_ms": [vp[f"{prefix}bound_block"][0], vp[f"{prefix}bound_batch"][0]],
            "ps_staged_ms": [vp["staged_ms_block"], vp["staged_ms_batch"]],
            "ptxas": ptxas.get(name),
        })
    print(json.dumps({
        "range_verify_median_ms": {str(k): v * 1e3 for k, v in range_medians.items()},
        "prove_median_ms": {str(k): v * 1e3 for k, v in prove_medians.items()},
        "prove_1in1out_median_ms": {str(k): v * 1e3 for k, v in prove_medians_wf.items()},
        "ps_verify_median_ms": {str(k): v * 1e3 for k, v in ps_medians.items()},
        "schnorr_verify_median_ms": {str(k): v * 1e3 for k, v in sign_medians.items()},
        "build_s": t_build}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
