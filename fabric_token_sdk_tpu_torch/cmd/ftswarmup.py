"""Build every kernel extension and launch each kernel once on the card.

Counterpart of the JAX package's `cmd/ftswarmup.py`.

Usage:
    python -m fabric_token_sdk_tpu_torch.cmd.ftswarmup                # every program
    python -m fabric_token_sdk_tpu_torch.cmd.ftswarmup --no-pairing   # no Miller/product/final-exp
    python -m fabric_token_sdk_tpu_torch.cmd.ftswarmup --no-prover    # skip prover-only programs
    python -m fabric_token_sdk_tpu_torch.cmd.ftswarmup --list         # the program inventory

Prints ONE JSON summary line last, e.g.:
    {"metric": "warmup", "programs": 15, "seconds": 41.2, "built": 12, "loaded": 12, ...}

`built` counts the sources `nvcc` compiled in this run, `loaded` the
libraries loaded from `fabric_token_sdk_tpu_torch/_build/`: a second
run builds nothing. A metrics sidecar (`--sidecar`, default
WARMUP.metrics.json, with its WARMUP.flight.json) records each program's
seconds.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ftswarmup", description=__doc__.splitlines()[0])
    ap.add_argument("--no-pairing", action="store_true",
                    help="skip the Miller, product, final-exp and fused pairing programs")
    ap.add_argument("--no-prover", action="store_true",
                    help="skip programs only the batched prover launches")
    ap.add_argument("--list", action="store_true",
                    help="list the program inventory without building or launching")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-program progress lines on stderr")
    ap.add_argument("--sidecar", default="WARMUP.metrics.json",
                    help="metrics sidecar path (the flight ring goes beside it)")
    args = ap.parse_args(argv)

    from fabric_token_sdk_tpu_torch.ops import warmup as wu
    from fabric_token_sdk_tpu_torch.utils import metrics as mx

    if args.list:
        for prog in wu.all_programs(not args.no_pairing, not args.no_prover):
            planes = f"[{wu.program_planes(prog.name)}]"
            print(f"{prog.name:<24} {planes:<16} {prog.row:<12} {prog.kernel.source}")
        return 0

    mx.enable(True)
    mx.install_sidecar(args.sidecar)
    mx.REGISTRY.set_meta("entry", "ftswarmup")

    def progress(name, dt):
        if not args.quiet:
            print(f"[fts-warmup] {name} launched in {dt:.3f}s", file=sys.stderr, flush=True)

    summary = wu.warmup(include_pairing=not args.no_pairing,
                        include_prover=not args.no_prover, progress=progress)
    summary.pop("per_program", None)
    print(json.dumps({"metric": "warmup", **summary}), flush=True)
    mx.flush_sidecar()
    return 0


if __name__ == "__main__":
    sys.exit(main())
