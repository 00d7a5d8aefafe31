#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from `fabric_token_sdk_tpu_torch/csrc`,
holds each against its plain torch version on the card, then drives the
port's main path: zkatdlog 1-in/1-out transfer-block verification
through `BatchedTransferVerifier` on `cuda`, for a 64-transaction block
(the orderer's default block size) and a 1,024-transaction backlog
batch, with tampered and malformed rows planted in both. Verdicts must
equal the port's host `TransferVerifier` on every row, and every kernel
of the path must have been launched by that run.

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

BLOCK_TXS = 64  # orderer default max_block_txs
BATCH_TXS = 1024  # backlog batch
ROWS_PER_TX = 4  # 1-in/1-out WF: input, input sum, output, output sum


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


def mul_products(points, scalars) -> int:
    """Field products of [k]P a row by 4-bit fixed windows: the table
    (when k has more than one digit), 4 doublings a window below the top
    one and an add per non-zero digit below the top one."""
    total = 0
    for p, k in zip(points, scalars):
        ds = nibbles(k)
        if p is None or len(ds) < 2:
            continue
        total += FP_MULS_WINDOW_TABLE + 4 * (len(ds) - 1) * FP_MULS_DOUBLE
        total += sum(1 for d in ds[:-1] if d) * FP_MULS_ADD
    return total


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

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from fabric_token_sdk_tpu_torch.crypto import hostmath as hm, token as tok
    from fabric_token_sdk_tpu_torch.crypto import transfer as tr, wellformedness as wfm
    from fabric_token_sdk_tpu_torch.crypto.batch import BatchedTransferVerifier
    from fabric_token_sdk_tpu_torch.crypto.setup import setup
    from fabric_token_sdk_tpu_torch.ops import _build, curve as cv, field as fd
    from fabric_token_sdk_tpu_torch.ops import limbs as lb, stages as st
    from fabric_token_sdk_tpu_torch.utils import metrics as mx

    dev = torch.device("cuda")
    rng = random.Random(args.seed)

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
    regs = []
    for src, log in sorted(_build.BUILD_LOG.items()):
        regs += [f"{src}: {ln.split(':', 2)[-1].strip()}" for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
    say("build", f"{len(_build.SOURCES)} sources with nvcc sm_90a in "
        f"{time.perf_counter() - t0:.1f} s; " + " | ".join(regs))

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
    tables = {nb: cv.FixedBaseTable(pool[:nb]).to(dev) for nb in (1, 2, 3)}

    def rand_points(n, edges):
        pts = [rng.choice(pool) for _ in range(n)]
        pts[: len(edges)] = edges
        return pts

    def redundant(words: torch.Tensor, rows) -> torch.Tensor:
        """Lift the coordinates of some rows from [0, p) into [p, 2p)."""
        out = words.clone()
        for r in rows:
            for c in range(3):
                v = lb.words_to_int(out[r, c].numpy()) + P
                out[r, c] = torch.from_numpy(lb.int_to_words(v))
        return out

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

    for k in _build.PATH_KERNELS:
        k.launches = 0
    t = time.perf_counter()
    got_block = verifier.verify(block)
    t_block = time.perf_counter() - t
    t = time.perf_counter()
    got_batch = verifier.verify(batch)
    t_batch = time.perf_counter() - t
    launches = {k.name: k.launches for k in _build.PATH_KERNELS}

    if got_block.tolist() != host_block or got_batch.tolist() != host_batch:
        fail("BatchedTransferVerifier on cuda disagrees with the host TransferVerifier")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the verify path")
    say("slice", f"proved {BLOCK_TXS}+{BATCH_TXS} 1-in/1-out transfers in {t_prove:.1f} s; "
        f"first verify: {BLOCK_TXS}-tx block {t_block * 1e3:.1f} ms, {BATCH_TXS}-tx batch "
        f"{t_batch * 1e3:.1f} ms; planted rows rejected, verdicts equal the host verifier's "
        f"on all {BLOCK_TXS + BATCH_TXS} rows; launches {launches} [{card}]")

    # steady state: repeated verifies, median and spread
    for txs, reps in ((block, 11), (batch, 5)):
        walls = []
        for _ in range(reps):
            t = time.perf_counter()
            verifier.verify(txs)
            walls.append(time.perf_counter() - t)
        walls.sort()
        med = walls[len(walls) // 2]
        say("throughput", f"{len(txs)}-tx verify over {reps} runs: median {med * 1e3:.1f} ms "
            f"({len(txs) / med:.1f} tx/s), min {walls[0] * 1e3:.1f} ms, max "
            f"{walls[-1] * 1e3:.1f} ms [{card}]")

    # where the time of one batch verify goes: the verifier's own spans,
    # and CUDA events recorded around each kernel launch of this verify
    launch_events = []

    def with_events(kernel):
        launch = kernel.launch

        def timed_launch(device, *args):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            launch(device, *args)
            ev[1].record()
            launch_events.append((kernel.name, ev))
        return timed_launch

    mx.enable(True)
    mx.REGISTRY.reset()
    for k in _build.PATH_KERNELS:
        k.launch = with_events(k)
    try:
        t = time.perf_counter()
        verifier.verify(batch)
        t_prof = time.perf_counter() - t
    finally:
        for k in _build.PATH_KERNELS:
            del k.launch
        mx.enable(False)
    spans = mx.REGISTRY.span_summary()
    torch.cuda.synchronize()
    if sorted(name for name, _ in launch_events) != sorted(k.name for k in _build.PATH_KERNELS):
        fail(f"profiled verify launched {[name for name, _ in launch_events]}")
    kernel_ms = {name: start.elapsed_time(end) for name, (start, end) in launch_events}
    busy_ms = sum(kernel_ms.values())
    say("breakdown", f"{BATCH_TXS}-tx verify {t_prof * 1e3:.1f} ms: " + ", ".join(
        f"{name.split('.', 1)[-1]} {spans[name]['total_s'] * 1e3:.1f} ms"
        for name in ("batch.transfer.verify", "batch.wf.parse", "batch.wf.encode",
                     "batch.wf.device", "batch.wf.decode", "batch.wf.challenge")
        if name in spans) + "; kernels in this verify by CUDA events " + ", ".join(
        f"{name} {ms:.3f} ms" for name, ms in kernel_ms.items()) + f", {busy_ms:.1f} ms "
        f"in all: no kernel running for {100 * (1 - busy_ms / (t_prof * 1e3)):.1f}% of "
        f"the verify [{card}]")

    # ---------------------------------------------------------------- report
    replaces = {
        "g1_msm": "fabric_token_sdk_tpu/ops/stages.py:61",
        "g1_mul": "fabric_token_sdk_tpu/ops/curve.py:122",
        "g1_addsub": "fabric_token_sdk_tpu/ops/stages.py:83",
    }
    kernels = []
    big, small = BATCH_TXS * ROWS_PER_TX, BLOCK_TXS * ROWS_PER_TX
    for k in _build.PATH_KERNELS:
        ms, p_ms, err, (b_ms, b_by) = stats[k.name][big]
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"fabric_token_sdk_tpu_torch/csrc/{k.source}",
            "replaces": replaces[k.name], "launches": launches[k.name],
            "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "rows": big, "ms_at_256_rows": stats[k.name][small][0],
            "plain_ms_at_256_rows": stats[k.name][small][1],
            "bound_ms_at_256_rows": stats[k.name][small][3][0],
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
