"""tokengen — generate token network artifacts (reference `cmd/tokengen`).

Counterpart of the JAX package's `cmd/tokengen.py`: the same arguments
and output lines; for one `--seed` it writes the same bytes.

Subcommands (`tokengen` is `python -m fabric_token_sdk_tpu_torch.cmd.tokengen`):
  tokengen gen fabtoken  --output DIR [--issuers N] [--owners N] [--auditor]
  tokengen gen dlog      --output DIR --base B --exponent E [...]

Writes public parameters + wallet key material as JSON files, mirroring
the reference's artifact generation for network bootstrap. Host code
only: the parameters' setup launches no kernel.
"""

from __future__ import annotations

import argparse
import os
import random

from ..crypto import sign
from ..crypto.serialization import dumps
from ..crypto.setup import setup
from ..drivers import identity
from ..drivers.fabtoken import FabTokenPublicParams


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    print(f"wrote {path}")


def _gen_identities(outdir: str, args, rng) -> tuple:
    issuers, auditor = [], b""
    for i in range(args.issuers):
        key = sign.keygen(rng)
        ident = identity.pk_identity(key.public)
        issuers.append(ident)
        _write(
            os.path.join(outdir, f"issuers/issuer{i}.json"),
            dumps({"sk": key.sk, "identity": ident}),
        )
    if args.auditor:
        key = sign.keygen(rng)
        auditor = identity.pk_identity(key.public)
        _write(
            os.path.join(outdir, "auditor/auditor.json"),
            dumps({"sk": key.sk, "identity": auditor}),
        )
    for i in range(args.owners):
        key = sign.keygen(rng)
        _write(
            os.path.join(outdir, f"owners/owner{i}.json"),
            dumps({"sk": key.sk, "identity": identity.pk_identity(key.public)}),
        )
    return issuers, auditor


def cmd_fabtoken(args) -> None:
    rng = random.Random(args.seed) if args.seed is not None else None
    pp = FabTokenPublicParams()
    issuers, auditor = _gen_identities(args.output, args, rng)
    for ident in issuers:
        pp.add_issuer(ident)
    if auditor:
        pp.add_auditor(auditor)
    _write(os.path.join(args.output, "fabtoken_pp.json"), pp.serialize())


def cmd_dlog(args) -> None:
    rng = random.Random(args.seed) if args.seed is not None else None
    pp = setup(base=args.base, exponent=args.exponent, rng=rng)
    issuers, auditor = _gen_identities(args.output, args, rng)
    for ident in issuers:
        pp.add_issuer(ident)
    if auditor:
        pp.add_auditor(auditor)
    pp.validate()
    _write(os.path.join(args.output, "zkatdlog_pp.json"), pp.serialize())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="tokengen")
    sub = ap.add_subparsers(dest="cmd", required=True)
    gen = sub.add_parser("gen")
    gsub = gen.add_subparsers(dest="driver", required=True)
    for name in ("fabtoken", "dlog"):
        p = gsub.add_parser(name)
        p.add_argument("--output", required=True)
        p.add_argument("--issuers", type=int, default=1)
        p.add_argument("--owners", type=int, default=2)
        p.add_argument("--auditor", action="store_true")
        p.add_argument("--seed", type=int, default=None)
        if name == "dlog":
            p.add_argument("--base", type=int, default=16)
            p.add_argument("--exponent", type=int, default=2)
    args = ap.parse_args(argv)
    if args.driver == "fabtoken":
        cmd_fabtoken(args)
    else:
        cmd_dlog(args)


if __name__ == "__main__":
    main()
