#!/usr/bin/env python3
"""Dry run of the PyTorch port's mesh plane on a (dp, mp) mesh of GPUs.

    python3 multichip_torch.py [--devices N] [--mp M] [--fused]
                               [--logical [--device cuda|cpu]] [--seed S]
                               [--block-txs N] [--deadline S]
                               [--sidecar PATH] [--result PATH]

The counterpart of `__graft_entry__.py:dryrun_multichip` for the port
(`fabric_token_sdk_tpu_torch/parallel/sharding.py`). `--devices N --mp
M` lays a (N // M, M) mesh over the first N CUDA devices and fails when
fewer exist; `--logical` puts every cell of the mesh on one device
(`--device`, `cuda` by default, `cpu` for the plain torch versions), as
the reference's tests run on virtual CPU devices. Four stages:

0. The flagship step of `entry()`: a fixed-base multiexp minus [c]stmt
   over 8 statements of 4 rows (`g1_msm`, `g1_mul`, `g1_sub`), every row
   equal to the host's.
1. Ragged Schnorr rows through `sharded_schnorr_rows`: dp * 2 + 3
   statements of 4 rows each, one row group on each row of the mesh.
   Each row is built so that its commitment is 7 * (b0 + b1 + b2); every row must
   decode to it.
2. Ragged Pointcheval-Sanders checks through `sharded_pairing_product`
   on the mesh: B = dp + 1 signatures, K = 2 legs, every GT value one.
   `--fused` takes the fused product (Miller values gathered over mp,
   then `fts_gt_product_final_exp`; one `fts_pairing_product` a row
   group when mp = 1), else the staged sequence on each row group's
   device.
3. One zkatdlog block through `Network(..., mesh=mesh)`: an issue of
   `--block-txs` outputs, then as many 1-in/1-out transfers in one block
   (`BlockPolicy(max_block_txs=n, min_batch=1)`), every transaction
   Valid; with dp > 1 and n >= 3 the block's verify must have run over
   the mesh's row groups (`stages.sharded_calls` rises).

The phases are set through a `metrics.Heartbeat`. `--deadline S`
(default 1800, 0 for none) arms a watchdog: when it fires it writes the
degraded result (`ok: false`, the live phase), flushes the metrics
sidecar and the flight ring, and exits 1. `--sidecar PATH` installs the
metrics sidecar (`PATH` and its `*.flight.json`, flushed at exit and on
SIGTERM/SIGINT); `--result PATH` writes the outcome as one JSON line in
the reference's shape (`ok`, `n_devices`, `phase`, the `multichip.*`
gauges); a run that fails writes `ok: false` with the error and raises.
The script prints one line a stage and exits 0 when all pass.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def schnorr_fixture(rng, statements: int, rows_per: int = 4):
    """(bases, resp (N, 3) ints, stmt points, chal ints) with N =
    statements * rows_per rows, one challenge a statement: stmt =
    prod b_i^{w_i} and resp_i = w_i c + 7, so every commitment
    table^resp - stmt^c is prod b_i^7."""
    from fabric_token_sdk_tpu_torch.crypto import hostmath as hm

    bases = [hm.g1_mul(hm.G1_GEN, 3 + i) for i in range(3)]
    resp, stmts, chals = [], [], []
    for _ in range(statements):
        c = rng.randrange(hm.R)
        for _ in range(rows_per):
            ws = [rng.randrange(hm.R) for _ in range(3)]
            stmts.append(hm.g1_multiexp(bases, ws))
            resp.append([(w * c + 7) % hm.R for w in ws])
            chals.append(c)
    return bases, resp, stmts, chals


def _fixture_tensors(rng, statements: int, dev):
    """`schnorr_fixture` as device tensors: (table, resp, stmts, chals,
    the commitment every row must give)."""
    import torch

    from fabric_token_sdk_tpu_torch.crypto import hostmath as hm
    from fabric_token_sdk_tpu_torch.ops import curve as cv

    bases, resp, stmts, chals = schnorr_fixture(rng, statements)
    table = cv.FixedBaseTable(bases).to(dev)
    return (table,
            torch.from_numpy(cv.encode_scalars([s for r in resp for s in r]).reshape(-1, 3, 8)).to(dev),
            torch.from_numpy(cv.encode_points(stmts)).to(dev),
            torch.from_numpy(cv.encode_scalars(chals)).to(dev),
            hm.g1_multiexp(bases, [7, 7, 7]))


def entry(device=None):
    """Returns (fn, example_args): the flagship step, the batched Schnorr
    recompute com = prod g_i^{z_i} - stmt^c over 8 statements of 4 rows
    (the fixed-base multiexp `g1_msm`, the ladder `g1_mul`, `g1_sub`),
    on `device` (None: the card)."""
    from fabric_token_sdk_tpu_torch.crypto.batch import resolve_device
    from fabric_token_sdk_tpu_torch.ops import stages as st

    table, resp, stmt, chal, _ = _fixture_tensors(random.Random(0xF75), 8,
                                                  resolve_device(device))

    def step(resp, stmt, chal):
        return st.g1_sub_rows(st.g1_msm_rows(table.table, resp), st.g1_mul_rows(stmt, chal))

    return step, (resp, stmt, chal)


def block_smoke(mesh, dev, rng, n: int) -> int:
    """Commit one zkatdlog block through `Network(..., mesh=mesh)` on
    `dev`: an issue of n outputs to alice, then n 1-in/1-out transfers
    (WF-only proofs) in one block. Every transaction must be Valid, and
    with dp > 1 and n >= 3 the block's verify must ride the mesh
    (`stages.sharded_calls` rises). Returns n."""
    from fabric_token_sdk_tpu_torch.api.request import IssueRecord, TokenRequest, TransferRecord
    from fabric_token_sdk_tpu_torch.api.validator import RequestValidator
    from fabric_token_sdk_tpu_torch.crypto import sign
    from fabric_token_sdk_tpu_torch.crypto.setup import setup
    from fabric_token_sdk_tpu_torch.drivers import identity
    from fabric_token_sdk_tpu_torch.drivers.zkatdlog import ZKATDLogDriver
    from fabric_token_sdk_tpu_torch.models.token import ID
    from fabric_token_sdk_tpu_torch.services.network import BlockPolicy, Network
    from fabric_token_sdk_tpu_torch.utils import metrics as mx

    pp = setup(base=4, exponent=2, rng=rng)
    driver = ZKATDLogDriver(pp, device=dev)
    net = Network(RequestValidator(driver), policy=BlockPolicy(max_block_txs=n, min_batch=1),
                  mesh=mesh, device=dev)
    issuer_key, alice_key = sign.keygen(rng), sign.keygen(rng)
    issuer_id = identity.pk_identity(issuer_key.public)
    alice_id = identity.pk_identity(alice_key.public)

    anchor = "multichip-issue"
    outcome = driver.issue(issuer_id, "USD", [7] * n, [alice_id] * n, anonymous=False, rng=rng)
    issue_req = TokenRequest(anchor=anchor)
    issue_req.issues.append(IssueRecord(action=outcome.action_bytes, issuer=issuer_id,
                                        outputs_metadata=outcome.metadata,
                                        receivers=[alice_id] * n))
    issue_req.issues[0].signature = issuer_key.sign(issue_req.marshal_to_sign(), rng)
    ev = net.submit(issue_req.to_bytes())
    if ev.status.value != "Valid":
        raise RuntimeError(f"multichip issue rejected: {ev.message}")

    reqs = []
    for i in range(n):
        tout = driver.transfer([ID(anchor, i)], [outcome.outputs[i]], [outcome.metadata[i]],
                               "USD", [7], [alice_id], rng=rng)
        req = TokenRequest(anchor=f"multichip-t{i}")
        req.transfers.append(TransferRecord(action=tout.action_bytes, input_ids=[ID(anchor, i)],
                                            senders=[alice_id], outputs_metadata=tout.metadata,
                                            receivers=[alice_id]))
        req.transfers[0].signatures = [alice_key.sign(req.marshal_to_sign(), rng)]
        reqs.append(req.to_bytes())

    sharded_before = mx.REGISTRY.counter("stages.sharded_calls").value
    events = net.submit_many(reqs)
    bad = [e for e in events if e.status.value != "Valid"]
    if bad:
        raise RuntimeError(f"multichip block rejected {len(bad)} txs: {bad[0].message}")
    if mesh.shape["dp"] > 1 and n >= 3 and \
            mx.REGISTRY.counter("stages.sharded_calls").value <= sharded_before:
        raise RuntimeError("block validation did not ride the mesh's row groups")
    return n


def _write_result(path, ok: bool, n_devices: int, **extra) -> None:
    """The outcome as one JSON line (the reference's `MULTICHIP.result.json`
    shape): on stderr always, and at `path` when one is given. A failed
    write never costs the run."""
    from fabric_token_sdk_tpu_torch.utils import metrics as mx

    snap = mx.REGISTRY.snapshot()
    n_devices = int(snap.get("gauges", {}).get("multichip.devices") or n_devices)
    doc = {"ok": bool(ok), "n_devices": n_devices,
           "phase": snap.get("meta", {}).get("progress.phase", "unknown"),
           "gauges": {k: v for k, v in snap.get("gauges", {}).items()
                      if k.startswith("multichip.")},
           **extra}
    line = json.dumps(doc)
    print(f"[fts-multichip] result {line}", file=sys.stderr, flush=True)
    if path:
        try:
            with open(path, "w") as fh:
                fh.write(line + "\n")
        except OSError as e:
            print(f"[fts-multichip] result write failed: {e}", file=sys.stderr, flush=True)


def _stages(args, hb) -> None:
    hb.set_phase("mesh_build", devices=args.devices)
    import torch

    from fabric_token_sdk_tpu_torch.crypto import hostmath as hm, pssign
    from fabric_token_sdk_tpu_torch.ops import curve as cv, pairing as pr
    from fabric_token_sdk_tpu_torch.parallel import (
        MeshConfig, make_mesh, sharded_pairing_product, sharded_schnorr_rows,
    )
    from fabric_token_sdk_tpu_torch.utils import metrics as mx

    if args.logical:
        n = args.devices or 1
        mesh = make_mesh(n, mp=args.mp, devices=[args.device] * n)
    else:
        mesh = make_mesh(args.devices, mp=args.mp)
    cfg = MeshConfig.of(mesh)
    dev = mesh.devices[0][0]
    rng = random.Random(args.seed)
    mx.gauge("multichip.devices").set(cfg.n_devices)
    mx.gauge("multichip.dp").set(cfg.dp)
    mx.gauge("multichip.mp").set(cfg.mp)
    print(f"mesh dp={cfg.dp} mp={cfg.mp} over "
          f"{sorted({str(d) for row in mesh.devices for d in row})}", flush=True)

    # stage 0: the flagship step on the mesh's first device
    hb.set_phase("entry_step")
    t0 = time.perf_counter()
    step, example = entry(dev)
    want = hm.g1_multiexp([hm.g1_mul(hm.G1_GEN, 3 + i) for i in range(3)], [7, 7, 7])
    got = cv.decode_points(step(*example).cpu().numpy())
    if len(got) != 32 or any(p != want for p in got):
        raise RuntimeError("the entry step disagrees with the host")
    print(f"stage 0: entry() step over {len(got)} rows equals the host's "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # stage 1: ragged Schnorr rows over the dp row groups
    hb.set_phase("sigma_kernel", dp=cfg.dp, mp=cfg.mp)
    t0 = time.perf_counter()
    statements = cfg.dp * 2 + 3
    table, resp, stmts, chals, want = _fixture_tensors(rng, statements, dev)
    coms = sharded_schnorr_rows(table, resp, stmts, chals, mesh)
    got = cv.decode_points(coms.cpu().numpy())
    if len(got) != statements * 4 or any(p != want for p in got):
        raise RuntimeError("sharded Schnorr rows disagree with the host")
    print(f"stage 1: {statements} statements, {len(got)} Schnorr rows over {cfg.dp} row groups "
          f"equal the host's ({time.perf_counter() - t0:.1f} s)", flush=True)

    # stage 2: ragged PS pairing-product checks on the mesh
    hb.set_phase("pairing_product", dp=cfg.dp, mp=cfg.mp)
    t0 = time.perf_counter()
    signer = pssign.keygen(1, rng)
    B = cfg.dp + 1
    msgs = [[rng.randrange(100)] for _ in range(B)]
    sigs = [signer.sign(m, rng) for m in msgs]
    Ps = torch.stack([torch.from_numpy(pr.encode_g1([hm.g1_neg(s.S), s.R])) for s in sigs])
    Qs = torch.stack([torch.from_numpy(pr.encode_g2([signer.Q, signer.message_base(m)]))
                      for m in msgs])
    gt = sharded_pairing_product(Ps.to(dev), Qs.to(dev), mesh, fused=args.fused)
    ok = pr.gt_is_one_host(gt.cpu().numpy())
    if not ok.all():
        raise RuntimeError(f"sharded PS verification {ok.tolist()}")
    print(f"stage 2: {B} PS pairing products (K = 2) through the "
          f"{'fused' if args.fused else 'staged'} product on the mesh: all one "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # stage 3: one zkatdlog block through the mesh-bound block pipeline
    hb.set_phase("block_pipeline", dp=cfg.dp, mp=cfg.mp)
    t0 = time.perf_counter()
    txs = block_smoke(mesh, dev, rng, args.block_txs)
    mx.gauge("multichip.block_txs").set(txs)
    print(f"stage 3: a {txs}-tx zkatdlog block through Network(mesh=...) all Valid "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    mx.flight("multichip.ok", dp=cfg.dp, mp=cfg.mp, rows=len(got), block_txs=txs)
    hb.set_phase("done")
    print(f"multichip_torch: mesh dp={cfg.dp} mp={cfg.mp} ok ({len(got)} Schnorr rows, "
          f"{B} pairing products, {txs} block txs)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh extent dp * mp (default: every CUDA device)")
    ap.add_argument("--mp", type=int, default=1, help="leg axis of the mesh")
    ap.add_argument("--fused", action="store_true", help="the fused pairing product (B16)")
    ap.add_argument("--logical", action="store_true", help="every mesh cell on --device")
    ap.add_argument("--device", default="cuda", help="the device of a --logical mesh")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--block-txs", type=int, default=4, help="transactions of stage 3's block")
    ap.add_argument("--deadline", type=float, default=1800.0,
                    help="seconds before the watchdog writes a degraded result (0: none)")
    ap.add_argument("--sidecar", default=None, help="metrics sidecar path (*.metrics.json)")
    ap.add_argument("--result", default=None, help="result file path (*.result.json)")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from fabric_token_sdk_tpu_torch.utils import metrics as mx

    was_enabled = mx.enabled()
    mx.enable(True)  # the phase and the gauges reach the result
    if args.sidecar:
        mx.install_sidecar(args.sidecar)
    mx.REGISTRY.set_meta("entry", "multichip_torch")
    n_devices = args.devices or 0
    hb = mx.Heartbeat("fts-multichip")
    done = threading.Event()

    def watchdog():
        if done.wait(timeout=args.deadline):
            return
        phase = mx.REGISTRY.snapshot().get("meta", {}).get("progress.phase", "unknown")
        mx.flight("multichip.deadline", deadline_s=args.deadline, phase=phase)
        print(f"[fts-multichip] DEADLINE after {args.deadline:.0f}s in phase={phase}: "
              "emitting degraded result JSON", file=sys.stderr, flush=True)
        _write_result(args.result, False, n_devices, degraded=True, deadline_s=args.deadline)
        mx.flush_sidecar()
        os._exit(1)  # a parsed degraded outcome, not a silent timeout

    if args.deadline > 0:
        threading.Thread(target=watchdog, name="fts-multichip-watchdog", daemon=True).start()
    hb.start()
    t0 = time.monotonic()
    try:
        _stages(args, hb)
        # disarm the watchdog before the green result is written
        done.set()
        mx.gauge("multichip.dryrun.seconds").set(round(time.monotonic() - t0, 3))
        _write_result(args.result, True, n_devices, degraded=False)
        return 0
    except BaseException as e:
        # a failed run leaves a parsed `ok: false` outcome too, then fails
        done.set()
        _write_result(args.result, False, n_devices, degraded=False,
                      error=f"{type(e).__name__}: {e}")
        raise
    finally:
        done.set()
        hb.stop()
        if args.sidecar:
            mx.flush_sidecar()
        mx.enable(was_enabled)


if __name__ == "__main__":
    sys.exit(main())
