#!/usr/bin/env python3
"""Dry run of the PyTorch port's mesh plane on a (dp, mp) mesh of GPUs.

    python3 multichip_torch.py [--devices N] [--mp M] [--fused]
                               [--logical [--device cuda|cpu]] [--seed S]

The counterpart of `__graft_entry__.py:dryrun_multichip` for the port
(`fabric_token_sdk_tpu_torch/parallel/sharding.py`). `--devices N --mp
M` lays a (N // M, M) mesh over the first N CUDA devices and fails when
fewer exist; `--logical` puts every cell of the mesh on one device
(`--device`, `cuda` by default, `cpu` for the plain torch versions), as
the reference's tests run on virtual CPU devices. Two stages:

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

The reference's third stage, a zkatdlog block through the sharded block
pipeline, waits for the port's block path (ROADMAP A8); its deadline
watchdog, metrics sidecar and `MULTICHIP.result.json` wait for the
port's observability plane (ROADMAP A12). This script writes no file.
It prints one line a stage and exits 0 when both pass.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh extent dp * mp (default: every CUDA device)")
    ap.add_argument("--mp", type=int, default=1, help="leg axis of the mesh")
    ap.add_argument("--fused", action="store_true", help="the fused pairing product (B16)")
    ap.add_argument("--logical", action="store_true", help="every mesh cell on --device")
    ap.add_argument("--device", default="cuda", help="the device of a --logical mesh")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, ROOT)
    from fabric_token_sdk_tpu_torch.crypto import hostmath as hm, pssign
    from fabric_token_sdk_tpu_torch.ops import curve as cv, pairing as pr
    from fabric_token_sdk_tpu_torch.parallel import (
        MeshConfig, make_mesh, sharded_pairing_product, sharded_schnorr_rows,
    )

    if args.logical:
        n = args.devices or 1
        mesh = make_mesh(n, mp=args.mp, devices=[args.device] * n)
    else:
        mesh = make_mesh(args.devices, mp=args.mp)
    cfg = MeshConfig.of(mesh)
    dev = mesh.devices[0][0]
    rng = random.Random(args.seed)
    print(f"mesh dp={cfg.dp} mp={cfg.mp} over "
          f"{sorted({str(d) for row in mesh.devices for d in row})}", flush=True)

    # stage 1: ragged Schnorr rows over the dp row groups
    t0 = time.perf_counter()
    statements = cfg.dp * 2 + 3
    bases, resp, stmts, chals = schnorr_fixture(rng, statements)
    table = cv.FixedBaseTable(bases).to(dev)
    coms = sharded_schnorr_rows(
        table,
        torch.from_numpy(cv.encode_scalars([s for r in resp for s in r]).reshape(-1, 3, 8)).to(dev),
        torch.from_numpy(cv.encode_points(stmts)).to(dev),
        torch.from_numpy(cv.encode_scalars(chals)).to(dev),
        mesh,
    )
    want = hm.g1_multiexp(bases, [7, 7, 7])
    got = cv.decode_points(coms.cpu().numpy())
    if len(got) != statements * 4 or any(p != want for p in got):
        print("FAIL: sharded Schnorr rows disagree with the host", file=sys.stderr)
        return 1
    print(f"stage 1: {statements} statements, {len(got)} Schnorr rows over {cfg.dp} row groups "
          f"equal the host's ({time.perf_counter() - t0:.1f} s)", flush=True)

    # stage 2: ragged PS pairing-product checks on the mesh
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
        print(f"FAIL: sharded PS verification {ok.tolist()}", file=sys.stderr)
        return 1
    print(f"stage 2: {B} PS pairing products (K = 2) through the "
          f"{'fused' if args.fused else 'staged'} product on the mesh: all one "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"multichip_torch: mesh dp={cfg.dp} mp={cfg.mp} ok ({len(got)} Schnorr rows, "
          f"{B} pairing products; stage 3, the block pipeline, waits for the block path)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
