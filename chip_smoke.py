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
  transactions (the batched verifier parses every row, so a copy costs
  what a distinct row costs).

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
plan (the host verifier checks the first 8 2-in/2-out proofs of the
64-tx group and every 1-in/1-out one); the select multiexp, the add and the K = 2 product are held
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
`multichip_torch.py --logical --fused`; `sharded_schnorr_rows` on the mesh bit
for bit against no mesh; and `BatchedSchnorrVerifier` on 64 and 1,024
signatures with planted faults against the host `PublicKey.verify`,
with and without the mesh.

The verify's own five `g1_msm` launches are held against the plain
version and timed (`[msm]`); its four `g1_sub` launches and its `g2_add`
(block and batch, `[adds]`), the PS verify's two `g2_add` launches
(`[ps]`) and the prove's `g1_add` and `g2_add` (`[prove-kernels]`) are
held bit for bit against their plain versions; `g1_mul`, `g2_mul` and
the select multiexp are timed on all-zero, all-0xF and random scalars
at the 1,024-tx prove's rows, `g1_to_affine` and `g2_to_affine` on Z =
1, Z = p - 1 and the verify's own Z at the 1,024-tx verify's rows, and
the prove's `g1_add` and `g2_add` on its own operands, on P + P, on P +
(-P) and with Q at infinity, in eight rounds of shuffled turns
(`[secret-scalars]`); the kernels redesigned for the H100 print their
lanes, ptxas line and share of bound (`[ladder]`, `[redesign]`, the
fused product's two modes in a `[redesign]` line of the mesh phase with
their rows, shared memory and blocks an SM, direct launches and an
empty launch on the same grid; for
`final_exp`, `miller`, `gt_product` and `g2_add` also the shared memory
a block, for the last three, the to-affine kernels and `g1_addsub` the
blocks an SM; for the to-affine kernels and the adds the time of an
empty launch on the same grid, `csrc/probe_empty.cu`, and for the adds
their time by direct launches beside the wrapper's).

Last, the token drivers (`[drivers]`): `ManagementService` and
`ZKATDLogDriver(pp)` on the card at the headline shape. A 64-tx block
runs the lifecycle: non-anonymous issues of its 128 inputs from an
authorized issuer to nym owners, validated by `RequestValidator`; one
`driver.transfer_many` (a batched-prover group on the card), signed by
`sign_transfers`; planted faults (two tampered proofs, inputs that
differ from the ledger's, one input spent in two records, an
unplannable proof); the orderer's validation: `transfer_batch_plan` on
every record, one `driver.batch_verifier().verify`, and
`validate(..., transfer_proofs=...)`, held against `validate` on the
host for the planted requests and 8 others. A 1,024-tx backlog mints its
inputs directly and runs the same path, its verdicts held against
`BatchedTransferVerifier` called directly (and host validation on the
planted requests and 8 others). Each `transfer_many` must launch the prove's kernels and each
verify the 2-in/2-out verify's ten, at the counts the prove and range
phases plan; validation launches none. It prints the times and the
host profiler's leg totals.

Last, the block validation path (`[ledger]`) over the same requests:
`Network(RequestValidator(ZKATDLogDriver(pp)), BlockPolicy(
max_block_txs=64), wal_path=...)` with its device left to the card. The
block's issues through `submit_many`, one with a forged issuer signature
(their issuer signatures in one `BatchedSchnorrVerifier` call: `g1_msm`,
`g1_mul`, `g1_addsub`; the forged one rejected by it, the rest valid);
its transfers with the planted faults and a re-signed copy of an earlier
transfer in place of a valid one, so that MVCC rejects the later of the
two (statuses equal validation with the batched verdicts, the spend of
the forged issue's outputs rejected, exactly the 2-in/2-out verify's
launches); the backlog from a restored snapshot of
its minted inputs, through the pipelined engine, and its first 4 blocks
again with `FTS_BLOCK_PIPELINE=0` (equal statuses, one verify a block); then
`Network.recover` from the WAL (the same height, statuses and state).
Any host re-verification of a proof or signature, a failed plane, a
breaker not closed or a launch count off plan fails it. It prints each step's time, the
transfer block's cut-to-finality latency and breakdown, and the
backlog's tx/s pipelined and sequential.

Last, the mesh binding on logical meshes of the card, (2, 1) and (2, 2)
(`[mesh-block]`): `[ledger]`'s transfer block through `Network(...,
mesh=mesh)` restored from the snapshot before it (statuses, state and
spent set equal the unbound run's; every kernel launched dp times); the
1,024-tx 2-in/2-out batch through `BatchedTransferVerifier` unbound and
bound to (2, 2) (equal verdicts) and the 1,024-request
`TransferProver.batch` with the prover unbound and bound (equal bytes for
one seed), each side's launches, time and kernel time by CUDA events;
both modes of the fused product through a bound verifier's `fused=True`
on the 64-tx block; `multichip_torch.py --logical --devices 4 --mp 2
--result` (stages 0-3, `ok: true`). A `[cuts]` line gives the phase's
seconds and what the depth cut from `[drivers]` and `[ledger]` saved.

Last, the token transaction services (`[ttx]`): the quickstart's path
through `services.ttx` on one `Network(RequestValidator(ZKATDLogDriver(
pp), auditor), BlockPolicy(max_block_txs=64), wal_path=...)` with an
`AuditorService` subscribed and `Party`s with crash-safe vaults: a
16-tx issue block of `Transaction`s (`submit_async`, then `wait`; the
issuer and auditor signatures in one sign-plane call), a 16-tx transfer
block of `Transaction.transfer`s proved on the host, one with a tampered
proof that only the proof plane can reject (the proof plane once, the
auditor signatures on the sign plane once), a 1,024-tx backlog of
minted inputs in 16 groups of 64 (each selected by alice's selector and
proved by one `transfer_many`) through `pipelined_submit`, and its
first 4 groups again sequentially, then a redeem, a re-audited replay, an NFT issue and
transfer, certification, the owner and query views and both vaults
rebuilt from their journals. Statuses, balances, ttxdb and auditor rows
and launch counts must be exact, with no host re-verification.

Last, the replicated ledger over the wire (`[repl]`): two ledger node
processes on the card (`chip_smoke.py --repl-node leader|follower`, each
`warmup()` first, then `Network(RequestValidator(ZKATDLogDriver(pp)),
BlockPolicy(max_block_txs=64), wal_path=...)` under a `LedgerServer`),
the leader restored from the snapshot `[ledger]`'s backlog starts from,
the follower bootstrapped from it by `repl.bootstrap`. This process is
the client, `RemoteNetwork(endpoints=[leader, follower])`: a 16-request
issue block with a forged issuer signature (the leader's sign plane),
`[ledger]`'s backlog in 16 `submit_many` groups of 64 (a block and a
proof-plane call each, `ops.health` probed while one validates), the
leader SIGKILLed once the follower holds the ninth group's block and
before the leader acknowledges it, the follower promoted over the wire,
the killed group's verdicts adopted exactly once through the client's
failover, the rest of the backlog and a second issue block on
the promoted node's card. Statuses must equal `[ledger]`'s, no
acknowledged tx lost or doubled (the promoted node's journal recovered
on the CPU), the end state `[ledger]`'s plus the issues, each node's
launches (over `ops.metrics`) as planned, no host re-verification. It
prints each node's start-to-READY and warmup times, tx/s over the wire
before and after the failover, the failover time, the ship wait a
block and the probe latency during a block.

The operator plane (`[ops]`, inside `[repl]`, on the promoted node
before its orderly stop, no new node process): `ftstop devices
HOST:PORT --once` run as a subprocess, `ftstop top --once`,
`ftsmetrics show --prometheus` and `diff` over its `ops.metrics`
snapshots; its `device` section must list every kernel it launched,
each program's dispatches over planes equal to its
`kernel.launches.<name>`, a device time by CUDA events above zero a
program and the builds and loads of its warmup; `ftstrace timeline`
stitches a post-failover transfer over this process's sidecar and the
node's (flushed on SIGTERM) from the client's submit through the
orderer's queue, the block's device verify and WAL to finality, and
`export` writes it; `tokengen gen dlog --base 16 --exponent 2` writes
parameters over which a `ZKATDLogDriver` builds its batched verifier on
the card. In this process, on the range phase's warm verifier: the
64-tx 2-in/2-out verify 9 times with the dispatch ledger on and 9 off,
interleaved (the verdicts equal; the on median within 5% of the off
median, or inside the off runs' spread), and each program's device time
a dispatch by the ledger's events at the block's rows.

Phases print one line each. Before the last line come the GPU's name
and power limit as `nvidia-smi` reports them and one JSON object with
each path kernel's launches, times and bound; the last line is
`{"ok": true, "device": {...}}`. Any failure exits non-zero with no
result line, as does a machine without CUDA. Imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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
# a BatchedSchnorrVerifier call (the sign plane, `schnorr_rows`): the
# 1-base gather multiexp for g^z, the ladder for pk^c, the sub
SIGN_LAUNCHES = {**{k: 0 for k in PROVE_LAUNCHES}, "g1_msm": 1, "g1_mul": 1, "g1_addsub": 1}
PROVE_REPS = (5, 3)  # block, batch
# a scalar whose 4-bit digits are all 15 below a zero top digit: every
# window of the ladder adds the table's last entry
LADDER_EDGE_K = 16 ** 63 - 1
# rounds of the to-affine kernels' Z kinds in `[secret-scalars]`
AFFINE_ROUNDS = 8
LADDERS = ("g1_mul", "g2_mul")  # the window ladder's kernels (csrc/bn254_ladder.cuh)
PS_SIGS = 64
TTX_BLOCK = 16  # the [ttx] issue and transfer blocks' transactions
TTX_GROUPS, TTX_GROUP = 16, 64  # the [ttx] backlog: groups of one transfer_many, a block each
# the [ttx] backlog's second (sequential) run: its first groups only, a
# depth cut that keeps the smoke inside its time with [ops] added
TTX_SEQ_GROUPS = 4
# [drivers]: the valid requests validated on the host beside the planted
# ones, in the block and in the backlog (the batched verdicts cover all)
DRIVERS_HOST_SAMPLE = 8
# [ledger]: the first blocks of the backlog that the sequential engine
# commits again (the pipelined engine commits all of them)
LEDGER_SEQ_BLOCKS = 4
# [prove]: the 2-in/2-out proofs of the 64-tx group the host verifier checks
# (the batched verifier checks all of them and the 1,024 of the backlog)
PROVE_HOST_SAMPLE = 8
TTX_HOST_PROVE_BUDGET_S = 60.0  # the [ttx] transfer block's host proofs, at most
# a [ttx] transfer block: the proof plane once, and the auditor's pk
# signatures (one a request, at least `sign_min_batch`) on the sign plane once
TTX_BLOCK_LAUNCHES = {k: RANGE_LAUNCHES[k] + SIGN_LAUNCHES[k] for k in RANGE_LAUNCHES}
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


def drivers_phase(pp, rng, verifier, prove_launches, verify_launches,
                  block=BLOCK_TXS, backlog=BATCH_TXS, device=None,
                  host_sample=DRIVERS_HOST_SAMPLE) -> tuple:
    """The token drivers on the card: `ManagementService` and
    `ZKATDLogDriver(pp, device)` (None: the card) at the headline shape,
    2-in/2-out, [100, 55] -> [120, 35].

    A `block`-tx block runs the whole lifecycle: non-anonymous issues of
    its 2 x `block` inputs from an authorized `pk` issuer to nym owners,
    each validated by `RequestValidator`; one `transfer_many` (one group
    for the batched prover), signed by `sign_transfers`; planted faults
    (two tampered proofs, inputs that differ from the ledger's, a
    request spending one input in two records, a proof that
    `transfer_batch_plan` cannot plan); then validation as the orderer
    does it: the plan over every transfer record, one
    `batch_verifier().verify`, and `validate(..., transfer_proofs=...)`,
    held against `validate` on the host on the planted requests and
    `host_sample` others (every request's verdict is held against the
    batched verify's). A `backlog`-tx backlog mints
    its inputs directly and runs `transfer_many`, the plan, one verify
    (held against `verifier`, a `BatchedTransferVerifier` called
    directly on the same rows) and validation with the verdicts; host
    validation runs on its planted requests and `host_sample` others.
    Each `transfer_many` must launch `prove_launches` and each verify
    `verify_launches`, validation nothing. Returns the times in ms and
    the profiler's leg totals, and what the ledger phase reuses: the
    management service, the block's issue and transfer requests, the
    backlog's requests and minted inputs, and the verdicts of validation
    with the batched verdicts at both sizes."""
    import torch

    from fabric_token_sdk_tpu_torch.api.driver import ValidationError
    from fabric_token_sdk_tpu_torch.api.request import TokenRequest, TransferRecord
    from fabric_token_sdk_tpu_torch.api.tms import ManagementService
    from fabric_token_sdk_tpu_torch.api.wallet import IssuerWallet, OwnerWallet, WalletRegistry
    from fabric_token_sdk_tpu_torch.crypto import hostmath as hm, sign as sgn
    from fabric_token_sdk_tpu_torch.crypto import token as tok, transfer as tr
    from fabric_token_sdk_tpu_torch.crypto import wellformedness as wfm
    from fabric_token_sdk_tpu_torch.crypto.rangeproof import RangeProof
    from fabric_token_sdk_tpu_torch.crypto.serialization import dumps, loads
    from fabric_token_sdk_tpu_torch.drivers.zkatdlog import ZKATDLogDriver
    from fabric_token_sdk_tpu_torch.models.token import ID
    from fabric_token_sdk_tpu_torch.ops import _build
    from fabric_token_sdk_tpu_torch.utils import profiler

    in_vals, out_vals = [100, 55], [120, 35]
    driver = ZKATDLogDriver(pp, device=device)
    issuer = IssuerWallet("issuer", sgn.keygen(rng))
    if issuer.identity not in pp.issuers:
        pp.add_issuer(issuer.identity)
    owners = [OwnerWallet(f"owner{i}", anonymous=True, nym_params=pp.nym_params, rng=rng)
              for i in range(8)]
    tms = ManagementService(driver, WalletRegistry(owners={w.wallet_id: w for w in owners},
                                                   issuers={"issuer": issuer}), rng=rng)
    validator = tms.validator()
    ms = {}

    def sync():
        if device is None or torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def counted(what, expect):
        """Every count set to 0 just before the block, read just after."""
        for k in _build.ALL_KERNELS:
            k.launches = 0
        yield
        counts = {k.name: k.launches for k in _build.ALL_KERNELS}
        if counts != expect:
            fail(f"[drivers] {what} launched {counts}, expected {expect}")

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        sync()
        ms[key] = (time.perf_counter() - t) * 1e3
        return out

    def outcome(req, resolve, proofs=None):
        try:
            res = validator.validate(req, resolve, transfer_proofs=proofs)
        except ValidationError as e:
            return str(e)
        return [(i.tx_id, i.index) for i in res.spent], res.outputs

    def transfers(specs, tag):
        """`transfer_many` over the specs, then one signed request each,
        assembled as `ManagementService.add_transfer` does."""
        with counted(f"transfer_many of {len(specs)}", prove_launches):
            made = timed(f"{tag}_transfer_many", lambda: driver.transfer_many(
                specs, rng=rng, min_batch=1))
        return [(f"{tag}-xfer{t}", spec, o.action_bytes, o.metadata)
                for t, (spec, o) in enumerate(zip(specs, made))]

    def bump_wf(action):
        d = loads(action)
        p = tr.TransferProof.from_bytes(d["proof"])
        w = wfm.TransferWF.from_bytes(p.wf)
        w.sum_resp = (w.sum_resp + 1) % hm.R
        d["proof"] = tr.TransferProof(w.to_bytes(), p.range_correctness).to_bytes()
        return dumps(d)

    def bump_membership(action):
        d = loads(action)
        p = tr.TransferProof.from_bytes(d["proof"])
        r = RangeProof.from_bytes(p.range_correctness)
        r.membership_proofs[1][0].value_resp = (r.membership_proofs[1][0].value_resp + 1) % hm.R
        d["proof"] = tr.TransferProof(p.wf, r.to_bytes()).to_bytes()
        return dumps(d)

    def unplannable(action):
        d = loads(action)
        d["proof"] = "not proof bytes"
        return dumps(d)

    def plant_and_sign(made):
        """Requests over the made transfers with the five faults planted
        at fixed rows; returns (requests, {row: expected rejection})."""
        n = len(made)
        rows = {"wf": 1, "membership": n // 2, "inputs": n // 3, "twice": n - 2,
                "unplannable": n - 1}
        expect = {rows["wf"]: "invalid transfer proof", rows["membership"]: "invalid transfer proof",
                  rows["inputs"]: "transfer inputs do not match ledger state",
                  rows["twice"]: "request spends the same token twice",
                  rows["unplannable"]: "invalid transfer proof"}
        reqs = []
        for t, (anchor, spec, action, meta) in enumerate(made):
            ids = list(spec[0])
            if t == rows["wf"]:
                action = bump_wf(action)
            elif t == rows["membership"]:
                action = bump_membership(action)
            elif t == rows["unplannable"]:
                action = unplannable(action)
            elif t == rows["inputs"]:
                # the next transfer's ids: the ledger resolves its tokens,
                # not the ones this action claims (and proves)
                ids = list(made[t + 1][1][0])
                d = loads(action)
                d["ids"] = [[i.tx_id, i.index] for i in ids]
                action = dumps(d)
            req = TokenRequest(anchor=anchor)
            rec = dict(action=action, input_ids=ids,
                       senders=[driver.output_owner(raw) for raw in spec[1]],
                       outputs_metadata=meta, receivers=list(spec[5]))
            req.transfers.append(TransferRecord(**rec))
            if t == rows["twice"]:
                req.transfers.append(TransferRecord(**rec))
            tms.sign_transfers(req)
            reqs.append(req)
        return reqs, expect

    def plan_and_verify(reqs, tag):
        """The orderer's plan over every transfer record and one
        `batch_verifier().verify` over the planned rows."""
        plans = []
        t = time.perf_counter()
        for ri, req in enumerate(reqs):
            for k, rec in enumerate(req.transfers):
                pl = driver.transfer_batch_plan(rec.action)
                if pl is not None:
                    plans.append((ri, k, pl))
        ms[f"{tag}_plan"] = (time.perf_counter() - t) * 1e3
        if {pl[0] for _, _, pl in plans} != {(2, 2)}:
            fail(f"[drivers] {tag}: planned shapes {sorted({pl[0] for _, _, pl in plans})}")
        # the driver builds its verifier on the first call (the block's)
        bv = timed(f"{tag}_verifier", driver.batch_verifier)
        with counted(f"batch_verifier().verify of {len(plans)} rows", verify_launches):
            got = timed(f"{tag}_verify", lambda: bv.verify([pl[1] for _, _, pl in plans]))
        proofs = {}
        for (ri, k, _), ok in zip(plans, got.tolist()):
            proofs.setdefault(ri, {})[k] = bool(ok)
        return plans, got, proofs

    def validate_all(reqs, resolve, proofs, tag, rows=None):
        """`validate` on the chosen rows, with the verdicts (`proofs` a
        dict) or on the host (None), in a profiler window; nothing may
        launch a kernel."""
        rows = range(len(reqs)) if rows is None else rows
        with counted(f"{tag} validation", {k.name: 0 for k in _build.ALL_KERNELS}):
            with profiler.collect() as legs:
                out = timed(tag, lambda: {r: outcome(reqs[r], resolve, None if proofs is None
                                                     else proofs.get(r, {})) for r in rows})
        ms[f"{tag}_legs"] = {k: v * 1e3 for k, v in sorted(legs.items())}
        return out

    def host_sample_of(n, expect):
        """The planted requests and `host_sample` others, drawn from rng."""
        others = [r for r in range(n) if r not in expect]
        return sorted(expect) + sorted(random.Random(rng.getrandbits(64)).sample(
            others, min(host_sample, len(others))))

    def check_rejections(tag, verdicts, expect, n):
        for r in range(n):
            v = verdicts.get(r)
            if v is None:
                continue
            want = expect.get(r)
            if want is None and isinstance(v, str):
                fail(f"[drivers] {tag}: request {r} rejected: {v}")
            if want is not None and not (isinstance(v, str) and v.startswith(want)):
                fail(f"[drivers] {tag}: planted request {r} gave {v!r}, expected {want!r}")

    # ---------------------------------------------------- the block
    t_phase = time.perf_counter()
    ledger = {}
    issued = []
    t = time.perf_counter()
    issue_reqs = []
    for t_ in range(block):
        req = tms.new_request(f"issue{t_}")
        w = owners[t_ % len(owners)]
        tms.add_issue(req, issuer, "USD", in_vals, [w.recipient_identity() for _ in in_vals],
                      anonymous=False)
        tms.sign_issues(req)
        issue_reqs.append(req)
    ms["block_issue"] = (time.perf_counter() - t) * 1e3
    with profiler.collect() as issue_legs:
        got = timed("block_issue_validate", lambda: [outcome(r, ledger.__getitem__)
                                                      for r in issue_reqs])
    ms["block_issue_validate_legs"] = {k: v * 1e3 for k, v in sorted(issue_legs.items())}
    for t_, (req, res) in enumerate(zip(issue_reqs, got)):
        if isinstance(res, str):
            fail(f"[drivers] issue {t_} rejected: {res}")
        (_, outputs), = res[1]
        ids = [ID(req.anchor, k) for k in range(len(outputs))]
        ledger.update(zip(ids, outputs))
        issued.append((ids, outputs, req.issues[0].outputs_metadata))
    specs = []
    for t_, (ids, outputs, meta) in enumerate(issued):
        w = owners[(t_ + 1) % len(owners)]
        specs.append((ids, outputs, meta, "USD", out_vals,
                      [w.recipient_identity() for _ in out_vals]))
    reqs, expect = plant_and_sign(transfers(specs, "block"))
    plans, got, proofs = plan_and_verify(reqs, "block")
    dev_v = validate_all(reqs, ledger.__getitem__, proofs, "block_validate_verdicts")
    sample_block = host_sample_of(len(reqs), expect)
    host_v = validate_all(reqs, ledger.__getitem__, None, "block_validate_host", sample_block)
    ms["block_host_sample"] = len(sample_block)
    for r in sample_block:
        a, b = dev_v[r], host_v[r]
        if isinstance(a, str) != isinstance(b, str) or (not isinstance(a, str) and a != b):
            fail(f"[drivers] block request {r}: with verdicts {a!r}, on the host {b!r}")
    check_rejections("block with verdicts", dev_v, expect, len(reqs))
    check_rejections("block on the host", host_v, expect, len(reqs))
    # the leg that should catch each planted fault
    by_req = {}
    for (ri, k, _), ok in zip(plans, got.tolist()):
        by_req.setdefault(ri, []).append(ok)
    for r, want in expect.items():
        oks = by_req.get(r)
        if want == "invalid transfer proof" and oks is not None and any(oks):
            fail(f"[drivers] the batched verify accepts the tampered proof of request {r}")
        if want != "invalid transfer proof" and (oks is None or not all(oks)):
            fail(f"[drivers] request {r} ({want}) was not planned or its proof was rejected")
    unplanned = [r for r in expect if r not in by_req]
    if len(unplanned) != 1 or dev_v[unplanned[0]] != host_v[unplanned[0]]:
        fail(f"[drivers] unplannable rows {unplanned}")
    if len(plans) != block or sum(got.tolist()) != block - 2:
        fail(f"[drivers] block: {len(plans)} planned rows, {int(got.sum())} accepted")

    # ---------------------------------------------------- the backlog
    t = time.perf_counter()
    ledger_b = {}
    specs = []
    for t_ in range(backlog):
        coms, wits = tok.tokens_with_witness(in_vals, "USD", pp.ped_params, rng)
        w = owners[t_ % len(owners)]
        ids, raws, metas = [], [], []
        for k, (c, wit) in enumerate(zip(coms, wits)):
            owner = w.recipient_identity()
            ids.append(ID(f"mint{t_}", k))
            raws.append(tok.Token(owner=owner, data=c).to_bytes())
            metas.append(tok.Metadata("USD", wit.value, wit.bf, owner=owner).to_bytes())
            ledger_b[ids[-1]] = raws[-1]
        v = owners[(t_ + 1) % len(owners)]
        specs.append((ids, raws, metas, "USD", out_vals, [v.recipient_identity() for _ in out_vals]))
    ms["backlog_mint"] = (time.perf_counter() - t) * 1e3
    made = transfers(specs, "backlog")
    t = time.perf_counter()
    reqs_b, expect_b = plant_and_sign(made)
    ms["backlog_sign"] = (time.perf_counter() - t) * 1e3
    plans_b, got_b, proofs_b = plan_and_verify(reqs_b, "backlog")
    direct = timed("backlog_direct_verify", lambda: verifier.verify([pl[1] for _, _, pl in plans_b]))
    if direct.tolist() != got_b.tolist():
        fail("[drivers] the driver's batch verify disagrees with BatchedTransferVerifier called "
             "directly on the same rows")
    dev_b = validate_all(reqs_b, ledger_b.__getitem__, proofs_b, "backlog_validate_verdicts")
    check_rejections("backlog with verdicts", dev_b, expect_b, len(reqs_b))
    if sum(1 for v in dev_b.values() if isinstance(v, str)) != len(expect_b):
        fail("[drivers] backlog: the rejected requests are not exactly the planted ones")
    sample = host_sample_of(len(reqs_b), expect_b)
    host_b = validate_all(reqs_b, ledger_b.__getitem__, None, "backlog_validate_host", sample)
    for r in sample:
        a, b = dev_b[r], host_b[r]
        if isinstance(a, str) != isinstance(b, str) or (not isinstance(a, str) and a != b):
            fail(f"[drivers] backlog request {r}: with verdicts {a!r}, on the host {b!r}")
    ms["backlog_host_sample"] = len(sample)
    ms["phase"] = (time.perf_counter() - t_phase) * 1e3
    return ms, {"tms": tms, "issue_reqs": issue_reqs, "reqs": reqs, "expect": expect,
                "verdicts": dev_v, "reqs_b": reqs_b, "ledger_b": ledger_b, "verdicts_b": dev_b}


def drivers_line(ms: dict, block: int, backlog: int) -> str:
    """The `[drivers]` phase's times (ms) and profiler leg totals as one line."""
    def legs(key):
        return "{" + ", ".join(f"{k} {v:.1f}" for k, v in ms[f"{key}_legs"].items()) + "}"

    return (
        f"{block}-tx block: issue of {2 * block} inputs ({block} requests, pk issuer to nym "
        f"owners) {ms['block_issue']:.1f} ms, validated {ms['block_issue_validate']:.1f} ms; "
        f"transfer_many {ms['block_transfer_many']:.1f} ms; plan {ms['block_plan']:.1f} ms; "
        f"batch_verifier() {ms['block_verifier']:.1f} ms (built), .verify "
        f"{ms['block_verify']:.1f} ms; validate with verdicts "
        f"{ms['block_validate_verdicts']:.1f} ms, without on {ms['block_host_sample']} requests "
        f"{ms['block_validate_host']:.1f} ms. "
        f"{backlog}-tx backlog: mint {ms['backlog_mint']:.1f} ms, transfer_many "
        f"{ms['backlog_transfer_many']:.1f} ms, sign {ms['backlog_sign']:.1f} ms, plan "
        f"{ms['backlog_plan']:.1f} ms, batch_verifier().verify {ms['backlog_verify']:.1f} ms "
        f"(BatchedTransferVerifier directly {ms['backlog_direct_verify']:.1f} ms), validate "
        f"with verdicts {ms['backlog_validate_verdicts']:.1f} ms, without on "
        f"{ms['backlog_host_sample']} requests {ms['backlog_validate_host']:.1f} ms. Leg totals "
        f"(ms): issue validation {legs('block_issue_validate')}, block with verdicts "
        f"{legs('block_validate_verdicts')}, without {legs('block_validate_host')}, backlog "
        f"with verdicts {legs('backlog_validate_verdicts')}, without "
        f"{legs('backlog_validate_host')}. Verdicts equal host validation, the planted "
        f"faults (2 tampered proofs, inputs unlike the ledger's, one input in two records, "
        f"an unplannable proof) are rejected by their legs at both sizes; phase "
        f"{ms['phase'] / 1e3:.1f} s")


def ledger_phase(pp, ctx, verify_launches, sign_launches, block=BLOCK_TXS, device=None) -> dict:
    """The block validation path on the card: `Network(RequestValidator(
    ZKATDLogDriver(pp)), BlockPolicy(max_block_txs=block), wal_path=...)`
    with its device left as None (the card), over the `[drivers]` phase's
    requests (`ctx`, from `drivers_phase`).

    1. The issue block: the block's issue requests through `submit_many`,
       one of them forged (its issuer signature is the issuer's
       signature of another request, so it parses and does not verify):
       the forged request INVALID with the batched signature plane's
       message, every other status VALID (as host validation gave); the
       issuer's pk signatures through the sign plane, one
       `BatchedSchnorrVerifier` call (`sign_launches`).
    2. The transfer block: the block's requests with the planted faults,
       one valid request replaced by a re-signed copy (a new anchor) of
       an earlier valid one, so that MVCC invalidates the LATER of the
       two; statuses and messages equal validation with the batched
       verdicts, the copy "already spent", and the request that spends
       the forged issue's outputs "does not exist"; exactly
       `verify_launches`.
    3. The backlog, twice: its minted inputs enter by `Network.restore` of
       a snapshot that holds them; `submit_many` of every request through
       the pipelined engine, then of its first `LEDGER_SEQ_BLOCKS` blocks
       on a fresh restore with `FTS_BLOCK_PIPELINE=0`; statuses equal in
       both runs and equal the backlog's verdicts; one verify a block.
    4. Recovery: `Network.recover` from the WAL gives the same height,
       statuses and state.
    Any host re-verification (`ledger.block.batch_errors`,
    `batch.sign.host_fallbacks`, a `*.host_fallback` flight event), a
    breaker not closed or a launch count other than planned fails the
    phase. Returns the times (ms) and the transfer block's breakdown."""
    import tempfile

    from fabric_token_sdk_tpu_torch.api.request import IssueRecord, TokenRequest, TransferRecord
    from fabric_token_sdk_tpu_torch.api.validator import RequestValidator
    from fabric_token_sdk_tpu_torch.crypto.serialization import dumps, loads
    from fabric_token_sdk_tpu_torch.drivers.zkatdlog import ZKATDLogDriver
    from fabric_token_sdk_tpu_torch.ops import _build
    from fabric_token_sdk_tpu_torch.services.network import BlockPolicy, Network
    from fabric_token_sdk_tpu_torch.utils import metrics as mx, resilience

    ms, launches = {}, {}
    # a ring that holds every event of the phase, so no fallback is evicted
    mx.FLIGHT = mx.FlightRecorder(capacity=1 << 20)
    resilience.reset()
    watched = ("ledger.block.batch_errors", "batch.sign.host_fallbacks", "batch.sign.rows",
               "batch.sign.batches", "ledger.validate.batched", "ledger.validate.host")
    base = {k: mx.counter(k).value for k in watched}

    def delta(k):
        return mx.counter(k).value - base[k]

    @contextlib.contextmanager
    def counted(key, expect):
        """Every count set to 0 just before the block, read just after:
        launches on any thread (the bounded worker, the commit worker)."""
        for k in _build.ALL_KERNELS:
            k.launches = 0
        yield
        counts = {k.name: k.launches for k in _build.ALL_KERNELS}
        launches[key] = counts
        if counts != expect:
            fail(f"[ledger] {key} launched {counts}, expected {expect}")

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        ms[key] = (time.perf_counter() - t) * 1e3
        return out

    def statuses(events):
        return [(e.tx_id, e.status.value, e.message) for e in events]

    def expected(reqs, verdicts):
        """The status each request must end with: its verdict of validation
        with the batched verdicts in `[drivers]` (a rejection's message,
        or the outputs of a valid request)."""
        return [(r.anchor, "Invalid", verdicts[i]) if isinstance(verdicts[i], str)
                else (r.anchor, "Valid", "") for i, r in enumerate(reqs)]

    t_phase = time.perf_counter()
    validator = RequestValidator(ZKATDLogDriver(pp, device=device))
    # the sign plane's auto rule is on for the card; a rehearsal on the CPU
    # forces it on to drive the same path through the plain versions
    policy = BlockPolicy(max_block_txs=block, sign_batched=None if device is None else True)
    tmp = tempfile.TemporaryDirectory()
    wal_path = os.path.join(tmp.name, "ledger.wal")
    net = Network(validator, policy, wal_path=wal_path, device=device)
    if net._engine is None:
        fail("[ledger] the pipelined engine is off")

    # ---------------------------------------------------- 1. the issue block
    reqs = list(ctx["reqs"])
    want = expected(reqs, ctx["verdicts"])
    free = [r for r in range(len(reqs)) if r not in ctx["expect"]]

    def spends(r):
        return {i.tx_id for rec in reqs[r].transfers for i in rec.input_ids}

    # the orphan: a valid request that alone names the outputs of one issue,
    # whose issue is forged below; src and dup come from the rest
    orphan = next((r for r in free if len(spends(r)) == 1 and not any(
        spends(r) & spends(q) for q in range(len(reqs)) if q != r)), None)
    if orphan is None or len(free) < 3:
        fail(f"[ledger] no request of the block can take the forged issue ({free})")
    src, dup = [r for r in free if r != orphan][0], [r for r in free if r != orphan][-1]
    # forge the orphan's issue: the issuer's signature of the next issue
    # request, over another payload
    orphan_ids = reqs[orphan].transfers[0].input_ids
    issue_reqs = list(ctx["issue_reqs"])
    k = next(i for i, r in enumerate(issue_reqs) if r.anchor == orphan_ids[0].tx_id)
    genuine = issue_reqs[k].issues[0]
    forged = TokenRequest(anchor=issue_reqs[k].anchor)
    forged.issues.append(IssueRecord(
        action=genuine.action, issuer=genuine.issuer,
        outputs_metadata=list(genuine.outputs_metadata), receivers=list(genuine.receivers),
        signature=issue_reqs[(k + 1) % len(issue_reqs)].issues[0].signature))
    issue_reqs[k] = forged
    want_issue = [(r.anchor, "Valid", "") for r in issue_reqs]
    want_issue[k] = (forged.anchor, "Invalid",
                     "invalid issuer signature: rejected by the batched signature plane")
    want[orphan] = (reqs[orphan].anchor, "Invalid", f"token {orphan_ids[0]} does not exist")
    issue_raws = [r.to_bytes() for r in issue_reqs]
    with counted("issue_block", sign_launches):
        got = timed("issue_block", lambda: statuses(net.submit_many(issue_raws)))
    if got != want_issue:
        bad = [(g, w) for g, w in zip(got, want_issue) if g != w]
        fail(f"[ledger] issue block: {len(bad)} statuses differ, e.g. {bad[:2]}")
    if delta("batch.sign.batches") != 1 or delta("batch.sign.rows") != len(issue_raws):
        fail(f"[ledger] issue block: {delta('batch.sign.batches')} sign-plane calls over "
             f"{delta('batch.sign.rows')} rows, expected 1 over {len(issue_raws)}")
    issue_block = dict(net.last_block)

    # ---------------------------------------------------- 2. the transfer block
    copy = TokenRequest(anchor=f"{reqs[src].anchor}-again")
    rec = reqs[src].transfers[0]
    copy.transfers.append(TransferRecord(action=rec.action, input_ids=list(rec.input_ids),
                                         senders=list(rec.senders),
                                         outputs_metadata=list(rec.outputs_metadata),
                                         receivers=list(rec.receivers)))
    ctx["tms"].sign_transfers(copy)
    reqs[dup] = copy
    want[dup] = (copy.anchor, "Invalid", f"token {rec.input_ids[0]} already spent")
    before_transfer = net.snapshot()
    transfer_raws = [r.to_bytes() for r in reqs]
    with counted("transfer_block", verify_launches):
        got = timed("transfer_block", lambda: statuses(net.submit_many(transfer_raws)))
    if got != want:
        bad = [(g, w) for g, w in zip(got, want) if g != w]
        fail(f"[ledger] transfer block: {len(bad)} statuses differ, e.g. {bad[:2]}")
    transfer_block = dict(net.last_block)
    height, snap = net.height(), loads(net.snapshot())
    # what [mesh-block] replays on bound ledgers: the block's start, its
    # requests, their statuses and the end state
    ctx.update(block_start=before_transfer, block_raws=transfer_raws, block_statuses=got,
               block_end=snap)

    # ---------------------------------------------------- 3. the backlog, twice
    n_blocks = -(-len(ctx["reqs_b"]) // block)
    raws_b = [r.to_bytes() for r in ctx["reqs_b"]]
    want_b = expected(ctx["reqs_b"], ctx["verdicts_b"])
    minted = dumps({"state": {i.key(): raw for i, raw in ctx["ledger_b"].items()},
                    "spent": [], "blocks": [], "status": {}})
    runs, nets = {}, {}
    for run, pipelined in (("pipelined", True), ("sequential", False)):
        blocks = n_blocks if pipelined else min(n_blocks, LEDGER_SEQ_BLOCKS)
        raws = raws_b[:blocks * block]
        old = os.environ.get("FTS_BLOCK_PIPELINE")
        os.environ["FTS_BLOCK_PIPELINE"] = "1" if pipelined else "0"
        try:
            net_b = timed(f"backlog_{run}_restore", lambda: Network.restore(
                validator, minted, policy=policy, device=device))
        finally:
            if old is None:
                del os.environ["FTS_BLOCK_PIPELINE"]
            else:
                os.environ["FTS_BLOCK_PIPELINE"] = old
        if (net_b._engine is not None) != pipelined:
            fail(f"[ledger] backlog {run}: engine {net_b._engine}")
        n_dev = len([e for e in mx.FLIGHT.tail() if e["kind"] == "verify.device"])
        plan = {k: v * blocks for k, v in verify_launches.items()}
        with counted(f"backlog_{run}", plan):
            runs[run] = timed(f"backlog_{run}", lambda: statuses(net_b.submit_many(raws)))
        n_dev = len([e for e in mx.FLIGHT.tail() if e["kind"] == "verify.device"]) - n_dev
        if net_b.height() != blocks or n_dev != blocks:
            fail(f"[ledger] backlog {run}: {net_b.height()} blocks, {n_dev} batched verifies, "
                 f"expected {blocks} of each")
        if runs[run] != want_b[:len(raws)]:
            bad = [(g, w) for g, w in zip(runs[run], want_b) if g != w]
            fail(f"[ledger] backlog {run}: {len(bad)} statuses differ, e.g. {bad[:2]}")
        ms[f"backlog_{run}_txs_per_s"] = len(raws) / (ms[f"backlog_{run}"] / 1e3)
        ms[f"backlog_{run}_blocks"] = blocks
        nets[run] = net_b
    # what [repl] replays over the wire: the backlog's start, statuses and end
    ctx.update(backlog_minted=minted, backlog_statuses=runs["pipelined"],
               backlog_end=loads(nets["pipelined"].snapshot()))

    # ---------------------------------------------------- 4. recovery
    rec_net = timed("recover", lambda: Network.recover(validator, wal_path, policy=policy,
                                                       device=device))
    if rec_net.height() != height or loads(rec_net.snapshot()) != snap:
        fail("[ledger] recovery from the WAL does not rebuild the same height, statuses and "
             "state")

    # ---------------------------------------------------- 5. no host re-verification
    fallbacks = [e for e in mx.FLIGHT.tail()
                 if e["kind"].endswith((".host_fallback", ".device_error"))]
    if delta("ledger.block.batch_errors") or delta("batch.sign.host_fallbacks") or fallbacks:
        fail(f"[ledger] host re-verification: batch_errors "
             f"{delta('ledger.block.batch_errors')}, sign host_fallbacks "
             f"{delta('batch.sign.host_fallbacks')}, events {fallbacks[:3]}")
    states = resilience.breaker_states()
    if any(v != "closed" for v in states.values()):
        fail(f"[ledger] breakers {states}")
    tmp.cleanup()
    ms.update(phase=(time.perf_counter() - t_phase) * 1e3, blocks_backlog=n_blocks,
              device=str(net.device),
              issue_block=dict(ms=ms["issue_block"], commit_s=issue_block["commit_s"],
                               breakdown=issue_block["breakdown"]),
              transfer_block_last=dict(commit_s=transfer_block["commit_s"],
                                       breakdown=transfer_block["breakdown"]),
              launches=launches, breakers=states, sign_rows=delta("batch.sign.rows"),
              batched=delta("ledger.validate.batched"), host=delta("ledger.validate.host"))
    return ms


def ledger_line(ms: dict, block: int, backlog: int) -> str:
    """The `[ledger]` phase's times as one line."""
    tb = ms["transfer_block_last"]
    bd = {k: round(v * 1e3, 1) for k, v in tb["breakdown"].items() if v}
    ib = {k: round(v * 1e3, 1) for k, v in ms["issue_block"]["breakdown"].items() if v}
    return (
        f"Network on {ms['device']} at max_block_txs={block}: issue block ({block} requests, "
        f"one with a forged issuer signature, {ms['sign_rows']} pk signatures in one "
        f"BatchedSchnorrVerifier call) "
        f"{ms['issue_block']['ms']:.1f} ms, cut to finality "
        f"{ms['issue_block']['commit_s'] * 1e3:.1f} ms, breakdown (ms) {ib}; transfer block "
        f"({block} requests, planted faults, a double spend of an earlier tx and a spend of "
        f"the forged issue's outputs) "
        f"{ms['transfer_block']:.1f} ms, cut to finality {tb['commit_s'] * 1e3:.1f} ms, "
        f"breakdown (ms) {bd}; {backlog}-tx backlog in "
        f"{ms['blocks_backlog']} blocks from a restored snapshot: pipelined "
        f"{ms['backlog_pipelined']:.1f} ms ({ms['backlog_pipelined_txs_per_s']:.1f} tx/s), "
        f"sequential over the first {ms['backlog_sequential_blocks']} blocks "
        f"{ms['backlog_sequential']:.1f} ms ({ms['backlog_sequential_txs_per_s']:.1f} tx/s), "
        f"restores "
        f"{ms['backlog_pipelined_restore']:.1f} / {ms['backlog_sequential_restore']:.1f} ms; "
        f"recover {ms['recover']:.1f} ms. Statuses equal validation with the batched "
        f"verdicts, the forged issue and the later double spend rejected, the backlog's runs equal, recovery "
        f"exact; {ms['batched']} transfer records batched, {ms['host']} on the host; no host "
        f"re-verification, breakers {ms['breakers']}; phase {ms['phase'] / 1e3:.1f} s")


MESH_SHAPES = {"(2, 1)": (2, 1), "(2, 2)": (4, 2)}  # [mesh-block]: (devices, mp)


def mesh_block_phase(pp, ctx, rblock, rbatch, batch_want, preq, prove_seed, verify_launches,
                     prove_launches, block=BLOCK_TXS, device=None) -> dict:
    """The verify, prove and block paths bound to logical meshes of the
    card (`make_mesh(..., devices=[device] * n)`), (2, 1) and (2, 2):

    1. `[ledger]`'s transfer block (its planted faults, the intra-block
       double spend and the spend of the forged issue's outputs) through
       `Network(..., mesh=mesh)` restored from the snapshot `[ledger]`
       took before it: statuses, state, spent set and statuses of every
       tx equal the unbound run's; every kernel of the 2-in/2-out verify
       launched dp times as often (`verify_launches` x dp) and the stage
       calls counted as sharded (`stages.sharded_calls`).
    2. The `len(rbatch)`-tx 2-in/2-out batch through `BatchedTransferVerifier`
       unbound and bound to (2, 2): the verdicts `batch_want` on both
       sides, launches `verify_launches` and x dp, each side's time and
       kernel time by CUDA events (the dispatch ledger's).
    3. `TransferProver.batch` of the `len(preq)` requests with the prover
       unbound and bound to (2, 2), one seed: equal proof bytes, launches
       `prove_launches` and x dp, times as above.
    4. The fused product's two modes through a bound verifier's
       `fused=True` on the `rblock` block: the tail after a gather of
       Miller values over mp on (2, 2), the whole product a row group on
       (2, 1); verdicts equal the unbound ones.
    5. `multichip_torch.main(["--logical", "--devices", "4", "--mp", "2",
       "--result", ...])` in this process: rc 0 and `ok: true`.
    Any host re-verification, fallback or launch count off plan fails
    the phase. Returns the times (ms) and launches."""
    import tempfile

    import torch

    import multichip_torch
    from fabric_token_sdk_tpu_torch.api.validator import RequestValidator
    from fabric_token_sdk_tpu_torch.crypto import transfer as tr
    from fabric_token_sdk_tpu_torch.crypto.batch import BatchedTransferVerifier
    from fabric_token_sdk_tpu_torch.crypto.batch_prove import prover_for
    from fabric_token_sdk_tpu_torch.crypto.serialization import loads
    from fabric_token_sdk_tpu_torch.drivers.zkatdlog import ZKATDLogDriver
    from fabric_token_sdk_tpu_torch.ops import _build
    from fabric_token_sdk_tpu_torch.parallel import make_mesh
    from fabric_token_sdk_tpu_torch.services.network import BlockPolicy, Network
    from fabric_token_sdk_tpu_torch.utils import devobs
    from fabric_token_sdk_tpu_torch.utils import metrics as mx

    dev = torch.device("cuda" if device is None else device)
    on_card = dev.type == "cuda"
    kernel_names = {k.name for k in _build.ALL_KERNELS}
    meshes = {name: make_mesh(n, mp=mp, devices=[dev] * n) for name, (n, mp) in MESH_SHAPES.items()}
    ms, launches = {}, {}
    t_phase = time.perf_counter()

    def times(dp: int, plan: dict) -> dict:
        return {k: v * dp for k, v in plan.items()}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def kernel_ms() -> dict:
        """Each kernel's device time so far by the dispatch ledger (events on
        the card), summed over planes."""
        out = {}
        for (_plane, prog), e in devobs.snapshot().items():
            if prog in kernel_names:
                out[prog] = out.get(prog, 0.0) + e["wall_s"] * 1e3
        return out

    def run(key, fn, expect):
        """`fn()` with every count set to 0 just before and read just after
        (`expect`); its time between two CUDA events (the host clock on the
        CPU) and its kernels' device time."""
        sync()
        k0 = kernel_ms()
        for k in _build.ALL_KERNELS:
            k.launches = 0
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t = time.perf_counter()
        out = fn()
        if on_card:
            end.record()
        sync()
        ms[key] = start.elapsed_time(end) if on_card else (time.perf_counter() - t) * 1e3
        counts = {k.name: k.launches for k in _build.ALL_KERNELS if k.launches}
        launches[key] = counts
        if counts != {k: v for k, v in expect.items() if v}:
            fail(f"[mesh-block] {key} launched {counts}, expected "
                 f"{ {k: v for k, v in expect.items() if v} }")
        k1 = kernel_ms()
        per = {k: v - k0.get(k, 0.0) for k, v in k1.items() if v - k0.get(k, 0.0) > 0}
        ms[f"{key}_kernel_ms"] = per
        ms[f"{key}_kernels"] = sum(per.values())
        return out

    base = {k: mx.counter(k).value for k in ("ledger.block.batch_errors", "batch.sign.host_fallbacks",
                                             "stages.sharded_calls", "pairing.staged.sharded_calls")}

    # ---------------------------------------------------- 1. the block on bound ledgers
    validator = RequestValidator(ZKATDLogDriver(pp, device=device))
    policy = BlockPolicy(max_block_txs=block, sign_batched=None if on_card else True)
    want_end = ctx["block_end"]
    for name, mesh in meshes.items():
        net = Network.restore(validator, ctx["block_start"], policy=policy, device=device,
                              mesh=mesh)
        sharded0 = mx.counter("stages.sharded_calls").value
        got = run(f"network_{name}", lambda: [(e.tx_id, e.status.value, e.message) for e in
                                               net.submit_many(ctx["block_raws"])],
                  times(mesh.shape["dp"], verify_launches))
        if got != ctx["block_statuses"]:
            bad = [(g, w) for g, w in zip(got, ctx["block_statuses"]) if g != w]
            fail(f"[mesh-block] the block on the {name} mesh: {len(bad)} statuses differ from "
                 f"the unbound run's, e.g. {bad[:2]}")
        end = loads(net.snapshot())
        for key in ("state", "spent", "status"):
            if end[key] != want_end[key]:
                fail(f"[mesh-block] the ledger's {key} on the {name} mesh differs from the "
                     "unbound run's")
        if mx.counter("stages.sharded_calls").value - sharded0 != 18:
            fail(f"[mesh-block] the block on the {name} mesh made "
                 f"{mx.counter('stages.sharded_calls').value - sharded0} sharded stage calls, "
                 "expected 18")
    ms["block_txs"] = len(ctx["block_raws"])

    # ---------------------------------------------------- 2. the batch verify
    mesh22 = meshes["(2, 2)"]
    unbound = BatchedTransferVerifier(pp, device=device)
    bound = BatchedTransferVerifier(pp, device=device, mesh=mesh22)
    for side, v, dp in (("verify_unbound", unbound, 1), ("verify_(2, 2)", bound, 2)):
        got = run(side, lambda: v.verify(rbatch), times(dp, verify_launches))
        if got.tolist() != batch_want:
            fail(f"[mesh-block] {side}: the {len(rbatch)}-tx verdicts differ from the range "
                 "phase's")
    ms["batch_txs"] = len(rbatch)

    # ---------------------------------------------------- 3. the prove
    proofs = {}
    for side, mesh, dp in (("prove_unbound", None, 1), ("prove_(2, 2)", mesh22, 2)):
        prover = prover_for(pp, device=dev, mesh=mesh)
        proofs[side] = run(side, lambda: tr.TransferProver.batch(
            preq, pp, rng=random.Random(prove_seed), min_batch=1, prover=prover),
            times(dp, prove_launches))
    prover_for(pp, device=dev)  # unbound again for later callers
    if proofs["prove_(2, 2)"] != proofs["prove_unbound"]:
        fail("[mesh-block] the bound prover's proof bytes differ from the unbound prover's")
    ms["prove_requests"] = len(preq)

    # ---------------------------------------------------- 4. the fused product's modes
    want_block = unbound.verify(rblock).tolist()
    fused_plan = {k: v for k, v in verify_launches.items()
                  if k not in ("miller", "gt_product", "final_exp")}
    m = verify_launches.get("miller", 0)  # one staged product a verify (0: no plan)
    for name, extra in (("(2, 2)", {"miller": 4 * m, "gt_product_final_exp": 2 * m}),
                        ("(2, 1)", {"pairing_product": 2 * m})):
        v = BatchedTransferVerifier(pp, device=device, mesh=meshes[name], fused=True)
        got = run(f"fused_{name}", lambda: v.verify(rblock), {**times(2, fused_plan), **extra})
        if got.tolist() != want_block:
            fail(f"[mesh-block] the fused bound verify on the {name} mesh differs from unbound")

    # ---------------------------------------------------- 5. multichip_torch.py
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "multichip.result.json")
        t = time.perf_counter()
        rc = multichip_torch.main(["--logical", "--device", str(dev), "--devices", "4", "--mp",
                                   "2", "--result", result])
        ms["multichip"] = (time.perf_counter() - t) * 1e3
        with open(result) as fh:
            doc = json.loads(fh.read())
    if rc != 0 or doc.get("ok") is not True:
        fail(f"[mesh-block] multichip_torch.py --logical --devices 4 --mp 2 exited {rc}: {doc}")

    for k in ("ledger.block.batch_errors", "batch.sign.host_fallbacks"):
        if mx.counter(k).value != base[k]:
            fail(f"[mesh-block] host re-verification: {k} +{mx.counter(k).value - base[k]}")
    ms.update(phase=(time.perf_counter() - t_phase) * 1e3, launches=launches,
              sharded_calls=mx.counter("stages.sharded_calls").value - base["stages.sharded_calls"],
              staged_pairing_sharded=mx.counter("pairing.staged.sharded_calls").value
              - base["pairing.staged.sharded_calls"])
    return ms


def mesh_block_line(ms: dict) -> str:
    """The `[mesh-block]` phase's checks, launches and times as one line."""
    lc = ms["launches"]
    return (
        f"{ms['block_txs']}-tx transfer block (planted faults, a double spend) through "
        f"Network(mesh=) from [ledger]'s snapshot on the (2, 1) and (2, 2) meshes: statuses, "
        f"state and spent set equal the unbound run's, {ms['network_(2, 1)']:.1f} / "
        f"{ms['network_(2, 2)']:.1f} ms (kernels {ms['network_(2, 1)_kernels']:.1f} / "
        f"{ms['network_(2, 2)_kernels']:.1f} ms), launches {lc['network_(2, 2)']}; "
        f"{ms['batch_txs']}-tx verify unbound {ms['verify_unbound']:.1f} ms (kernels "
        f"{ms['verify_unbound_kernels']:.2f} ms, launches {lc['verify_unbound']}) and on (2, 2) "
        f"{ms['verify_(2, 2)']:.1f} ms (kernels {ms['verify_(2, 2)_kernels']:.2f} ms, launches "
        f"{lc['verify_(2, 2)']}), verdicts equal; {ms['prove_requests']}-request prove unbound "
        f"{ms['prove_unbound']:.1f} ms (kernels {ms['prove_unbound_kernels']:.2f} ms, launches "
        f"{lc['prove_unbound']}) and on (2, 2) {ms['prove_(2, 2)']:.1f} ms (kernels "
        f"{ms['prove_(2, 2)_kernels']:.2f} ms, launches {lc['prove_(2, 2)']}), proof bytes "
        f"equal for one seed; fused=True on the block: (2, 2) {ms['fused_(2, 2)']:.1f} ms "
        f"(launches {lc['fused_(2, 2)']}), (2, 1) {ms['fused_(2, 1)']:.1f} ms (launches "
        f"{lc['fused_(2, 1)']}), verdicts equal; multichip_torch.py --logical --devices 4 --mp 2 "
        f"--result: ok true ({ms['multichip'] / 1e3:.1f} s); {ms['sharded_calls']} sharded "
        f"stage calls, {ms['staged_pairing_sharded']} sharded staged products; no host "
        f"re-verification; phase {ms['phase'] / 1e3:.1f} s; kernel ms by events, unbound / "
        f"(2, 2): verify " + ", ".join(
            f"{k} {v:.3f} / {ms['verify_(2, 2)_kernel_ms'].get(k, 0.0):.3f}"
            for k, v in ms["verify_unbound_kernel_ms"].items()) + "; prove " + ", ".join(
            f"{k} {v:.3f} / {ms['prove_(2, 2)_kernel_ms'].get(k, 0.0):.3f}"
            for k, v in ms["prove_unbound_kernel_ms"].items()))


def ttx_phase(pp, seed, prove_launches, block_launches, sign_launches, n_block=TTX_BLOCK,
              groups=TTX_GROUPS, group=TTX_GROUP, device=None) -> dict:
    """The token transaction services on the card: the quickstart's path
    through `services.ttx`. One `Network(RequestValidator(ZKATDLogDriver(
    pp), auditor), BlockPolicy(max_block_txs=max(group, n_block)), wal_path=
    ...)` with
    an `AuditorService` subscribed; issuer, alice and bob are `Party`s
    with crash-safe vaults (`vault_path=`) and drivers of their own,
    alice and bob anonymous owners (`pp.nym_params`).

    1. The issue block: `n_block` issue `Transaction`s of [100, 55] to
       alice from a non-anonymous issuer, endorsed by the auditor,
       `submit_async`ed, then waited on: one block, whose issuer and
       auditor signatures go through one sign-plane call
       (`sign_launches`).
    2. The transfer block: `n_block` `Transaction.transfer`s alice ->
       bob, each proved on the host, 2-in/2-out by the selector's order
       (two 100s for [120, 80], then two 55s for [60, 50]); one has its
       proof tampered before it is endorsed, so that only the proof plane
       can reject it. One block: the proof plane once and the auditor
       signatures on the sign plane once (`block_launches`); the tampered
       one INVALID with the device plane's message, the ttxdb Confirmed /
       Deleted, the selector empty. Half as many (all of [120, 80]) if
       the host proofs would take longer than `TTX_HOST_PROVE_BUDGET_S`.
    3. The backlog: `groups` x `group` 2-in/2-out transfers alice -> bob
       over 2 x `groups` x `group` minted [100, 55] inputs that enter the
       network by `Network.restore` of a snapshot and alice's vault by its
       store's own delta. A group is a builder: inputs by alice's
       selector, one `transfer_many` (`prove_launches`), the owner's
       signatures, the audit. Once through `pipelined_submit`, once on a
       fresh restore with fresh parties as builders then `submit_many`
       over the first `TTX_SEQ_GROUPS` groups; one block a group
       (`block_launches`).
    4. The services: a redeem; a re-audited replay of a committed
       transfer under a fresh anchor (INVALID, "spent" or "exist"); an NFT
       issue and transfer; a certification, and the refused certification
       of a spent token; `OwnerService` and `QueryService` against the
       sums the phase computed; the auditor's db holding every
       transaction; alice and bob rebuilt from their vault journals with
       the same tokens and balances.
    Any host re-verification, failed plane, open breaker, launch count
    off plan, or wrong status, balance or row fails the phase. Returns
    the times (ms), the blocks' breakdowns and the launch counts."""
    import dataclasses
    import functools
    import tempfile

    from fabric_token_sdk_tpu_torch.api.driver import ValidationError
    from fabric_token_sdk_tpu_torch.api.validator import RequestValidator
    from fabric_token_sdk_tpu_torch.api.wallet import AuditorWallet
    from fabric_token_sdk_tpu_torch.crypto import hostmath as hm, sign as sgn
    from fabric_token_sdk_tpu_torch.crypto import token as tok, transfer as tr
    from fabric_token_sdk_tpu_torch.crypto.rangeproof import RangeProof
    from fabric_token_sdk_tpu_torch.crypto.serialization import dumps, loads
    from fabric_token_sdk_tpu_torch.drivers.zkatdlog import ZKATDLogDriver
    from fabric_token_sdk_tpu_torch.models.token import ID
    from fabric_token_sdk_tpu_torch.ops import _build
    from fabric_token_sdk_tpu_torch.services.auditor import AuditorService
    from fabric_token_sdk_tpu_torch.services.certifier import CertificationService
    from fabric_token_sdk_tpu_torch.services.network import BlockPolicy, Network
    from fabric_token_sdk_tpu_torch.services.nfttx import NFTService
    from fabric_token_sdk_tpu_torch.services.owner import OwnerService
    from fabric_token_sdk_tpu_torch.services.query import QueryService
    from fabric_token_sdk_tpu_torch.services.ttx import Party, Transaction, pipelined_submit
    from fabric_token_sdk_tpu_torch.services.vault import VaultDelta
    from fabric_token_sdk_tpu_torch.services.vault.store import decoded_token
    from fabric_token_sdk_tpu_torch.utils import metrics as mx, resilience

    ms, launches, rng = {}, {}, random.Random(seed)
    # a ring that holds every event of the phase, so no fallback is evicted
    mx.FLIGHT = mx.FlightRecorder(capacity=1 << 20)
    resilience.reset()
    watched = ("ledger.block.batch_errors", "batch.sign.host_fallbacks", "batch.sign.rows",
               "batch.sign.batches", "ledger.validate.batched", "ledger.validate.host")
    base = {k: mx.counter(k).value for k in watched}

    def delta(k):
        return mx.counter(k).value - base[k]

    def zero():
        for k in _build.ALL_KERNELS:
            k.launches = 0

    def read(key, expect):
        counts = {k.name: k.launches for k in _build.ALL_KERNELS}
        launches[key] = counts
        if counts != expect:
            fail(f"[ttx] {key} launched {counts}, expected {expect}")

    @contextlib.contextmanager
    def counted(key, expect):
        """Every count set to 0 just before the block, read just after:
        launches on any thread (the bounded worker, the commit worker)."""
        zero()
        yield
        read(key, expect)

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        ms[key] = (time.perf_counter() - t) * 1e3
        return out

    def times(plan, n):
        return {k: v * n for k, v in plan.items()}

    def plus(*plans):
        return {k: sum(p[k] for p in plans) for k in plans[0]}

    def bump_membership(action):
        d = loads(action)
        p = tr.TransferProof.from_bytes(d["proof"])
        r = RangeProof.from_bytes(p.range_correctness)
        r.membership_proofs[1][0].value_resp = (r.membership_proofs[1][0].value_resp + 1) % hm.R
        d["proof"] = tr.TransferProof(p.wf, r.to_bytes()).to_bytes()
        return dumps(d)

    def statuses(txs):
        """Each transaction's finality by `wait()`: a rejection raises
        `ValidationError` with the ledger's message."""
        out = []
        for tx in txs:
            try:
                e = tx.wait()
                out.append((tx.tx_id, e.status.value, e.message))
            except ValidationError as e:
                out.append((tx.tx_id, "Invalid", str(e)))
        return out

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    path = functools.partial(os.path.join, tmp.name)
    aw = AuditorWallet("auditor", sgn.keygen(rng))
    auditor = AuditorService(ZKATDLogDriver(pp, device=device), aw)
    # the sign plane's auto rule is on for the card; a rehearsal on the CPU
    # forces it on to drive the same path through the plain versions
    policy = BlockPolicy(max_block_txs=max(group, n_block),
                         sign_batched=None if device is None else True)
    validator = RequestValidator(ZKATDLogDriver(pp, device=device), aw.identity)
    net = Network(validator, policy, wal_path=path("ledger.wal"), device=device)
    net.subscribe(auditor.on_finality)

    def party(name, network, vault_path):
        return Party(name, ZKATDLogDriver(pp, device=device), network,
                     auditor_identity=aw.identity, rng=rng, vault_path=vault_path)

    issuer_p, alice_p, bob_p = (party(n, net, path(f"{n}.vault"))
                                for n in ("issuer", "alice", "bob"))
    issuer = issuer_p.new_issuer_wallet("issuer")
    pp.add_issuer(issuer.identity)
    alice = alice_p.new_owner_wallet("alice", anonymous=True, nym_params=pp.nym_params)
    bob = bob_p.new_owner_wallet("bob", anonymous=True, nym_params=pp.nym_params)
    audited = {}  # tx id -> the status the auditor's db must end with

    # ---------------------------------------------------- 1. the issue block
    in_vals = [100, 55]
    issues = []
    t = time.perf_counter()
    for i in range(n_block):
        tx = Transaction(issuer_p, f"ttx-issue{i}")
        tx.issue("issuer", "USD", in_vals, [alice.recipient_identity() for _ in in_vals],
                 anonymous=False)
        tx.collect_endorsements(auditor)
        issues.append(tx)
    ms["issue_assemble"] = (time.perf_counter() - t) * 1e3
    with counted("issue_block", sign_launches):
        t = time.perf_counter()
        for tx in issues:
            tx.submit_async()
        got = statuses(issues)
        ms["issue_block"] = (time.perf_counter() - t) * 1e3
    if got != [(tx.tx_id, "Valid", "") for tx in issues] or net.height() != 1:
        fail(f"[ttx] issue block: {got[:2]}, height {net.height()}")
    if delta("batch.sign.batches") != 1 or delta("batch.sign.rows") != 2 * n_block:
        fail(f"[ttx] issue block: {delta('batch.sign.batches')} sign-plane calls over "
             f"{delta('batch.sign.rows')} rows, expected 1 over {2 * n_block}")
    audited.update((tx.tx_id, "Confirmed") for tx in issues)
    issue_block = dict(net.last_block)
    want_alice = n_block * sum(in_vals)
    if alice_p.balance("USD") != want_alice:
        fail(f"[ttx] alice holds {alice_p.balance('USD')} after the issues, not {want_alice}")

    # ---------------------------------------------------- 2. the transfer block
    half = n_block // 2

    def shape(i):  # by the selector's order: two 100s, then two 55s
        return [120, 80] if i < half else [60, 50]

    def host_transfer(i):
        tx = Transaction(alice_p, f"ttx-pay{i}")
        tx.transfer("alice", "USD", shape(i), [bob.recipient_identity() for _ in range(2)])
        return tx

    t = time.perf_counter()
    pays = [host_transfer(0)]
    ms["host_prove_transaction"] = (time.perf_counter() - t) * 1e3
    ms["transfer_block_predicted_s"] = ms["host_prove_transaction"] * n_block / 1e3
    if ms["transfer_block_predicted_s"] > TTX_HOST_PROVE_BUDGET_S:
        n_block = half  # the 100s alone: [120, 80] each
    pays += [host_transfer(i) for i in range(1, n_block)]
    ms["transfer_assemble"] = (time.perf_counter() - t) * 1e3
    ms["transfer_block_txs"] = n_block
    planted = min(3, n_block - 1)
    rec = pays[planted].request.transfers[0]
    rec.action = bump_membership(rec.action)
    for tx in pays:
        tx.collect_endorsements(auditor)
    if any(len(tx.request.transfers[0].input_ids) != 2
           or len(loads(tx.request.transfers[0].action)["outputs"]) != 2 for tx in pays):
        fail("[ttx] a transfer of the block is not 2-in/2-out")
    with counted("transfer_block", block_launches):
        t = time.perf_counter()
        for tx in pays:
            tx.submit_async()
        got = statuses(pays)
        ms["transfer_block"] = (time.perf_counter() - t) * 1e3
    want = [(tx.tx_id, "Valid", "") for tx in pays]
    want[planted] = (pays[planted].tx_id, "Invalid",
                     f"tx {pays[planted].tx_id} rejected: invalid transfer proof")
    if got != want or net.height() != 2:
        bad = [(g, w) for g, w in zip(got, want) if g != w]
        fail(f"[ttx] transfer block: {len(bad)} statuses differ, e.g. {bad[:2]}; "
             f"height {net.height()}")
    transfer_block = dict(net.last_block)
    sent = sum(sum(shape(i)) for i in range(n_block) if i != planted)
    for tx in pays:
        st = "Deleted" if tx is pays[planted] else "Confirmed"
        audited[tx.tx_id] = st
        if alice_p.db.status(tx.tx_id) != st:
            fail(f"[ttx] alice's ttxdb has {tx.tx_id} {alice_p.db.status(tx.tx_id)}, not {st}")
    if (alice_p.balance("USD"), bob_p.balance("USD")) != (want_alice - sent, sent):
        fail(f"[ttx] balances after the transfer block: alice {alice_p.balance('USD')}, bob "
             f"{bob_p.balance('USD')}, expected {want_alice - sent}, {sent}")
    if alice_p.selectors.locker.locked_count():
        fail(f"[ttx] the selector holds {alice_p.selectors.locker.locked_count()} tokens")

    # ---------------------------------------------------- 3. the backlog, twice
    n_mint = groups * group
    t = time.perf_counter()
    minted, stores = {}, []
    opener = ZKATDLogDriver(pp, device=device)
    for m in range(n_mint):
        coms, wits = tok.tokens_with_witness(in_vals, "USD", pp.ped_params, rng)
        owner = alice.recipient_identity()
        for k, (c, wit) in enumerate(zip(coms, wits)):
            raw = tok.Token(owner=owner, data=c).to_bytes()
            meta = tok.Metadata("USD", wit.value, wit.bf, owner=owner).to_bytes()
            minted[ID(f"mint{m}", k).key()] = raw
            stores.append(decoded_token(opener.output_to_unspent, ID(f"mint{m}", k), raw, meta))
    snapshot = dumps({"state": minted, "spent": [], "blocks": [], "status": {}})
    ms["backlog_mint"] = (time.perf_counter() - t) * 1e3
    if any(st.decoded is None for st in stores):
        fail("[ttx] a minted token does not open")

    def values_of(g):  # the 100s first, then the 55s (the selector's order)
        return [120, 80] if g < groups // 2 else [60, 50]

    def builder(owner_p, tag, g):
        """Group g: `Transaction.transfer_group` (each transaction's inputs
        by the owner's selector, one `transfer_many` for the group, the
        owner's signatures and the audit); every selection must take two
        inputs and give no change."""
        values = values_of(g)

        def build():
            txs = Transaction.transfer_group(owner_p, "alice", "USD", [
                (f"{tag}-g{g}-{j}", values, [bob.recipient_identity() for _ in values])
                for j in range(group)], auditor, rng)
            for tx in txs:
                rec = tx.request.transfers[0]
                if len(rec.input_ids) != 2 or len(rec.receivers) != len(values):
                    fail(f"[ttx] {tx.tx_id} took {len(rec.input_ids)} inputs for "
                         f"{len(rec.receivers)} outputs")
            return [tx.request.to_bytes() for tx in txs]

        return build

    def time_proving(owner_p, tag):
        """Time the party driver's `transfer_many` calls into
        ms["backlog_<tag>_transfer_many"]."""
        prove = owner_p.driver.transfer_many

        def timed_prove(*args, **kwargs):
            t = time.perf_counter()
            out = prove(*args, **kwargs)
            ms.setdefault(f"backlog_{tag}_transfer_many", []).append(
                (time.perf_counter() - t) * 1e3)
            return out

        owner_p.driver.transfer_many = timed_prove

    backlog = {}
    for run in ("pipelined", "sequential"):
        n_groups = groups if run == "pipelined" else min(groups, TTX_SEQ_GROUPS)
        moved = sum(sum(values_of(g)) for g in range(n_groups)) * group
        net_b = timed(f"backlog_{run}_restore", lambda: Network.restore(
            validator, snapshot, policy=policy, device=device))
        net_b.subscribe(auditor.on_finality)
        a_b = party("alice", net_b, path(f"alice-{run}.vault"))
        b_b = party("bob", net_b, path(f"bob-{run}.vault"))
        a_b.wallets.owners["alice"] = alice
        b_b.wallets.owners["bob"] = bob
        a_b.vault.store.apply(VaultDelta("mint", stores=stores))
        time_proving(a_b, run[0])
        builders = [builder(a_b, run[0], g) for g in range(n_groups)]
        n_dev = len([e for e in mx.FLIGHT.tail() if e["kind"] == "verify.device"])
        plan = times(plus(prove_launches, block_launches), n_groups)
        if run == "pipelined":
            mx.gauge("ttx.pipeline.overlap_frac").set(-1.0)
            zero()
            t = time.perf_counter()
            results = pipelined_submit(net_b, builders)
            ms["backlog_pipelined"] = (time.perf_counter() - t) * 1e3
            read("backlog_pipelined", plan)
            ms["overlap_frac"] = mx.gauge("ttx.pipeline.overlap_frac").value
        else:
            results, t = [], time.perf_counter()
            for g, build in enumerate(builders):
                with counted(f"backlog_sequential_group{g}", prove_launches):
                    raws = build()
                with counted(f"backlog_sequential_block{g}", block_launches):
                    results.append(net_b.submit_many(raws))
            ms["backlog_sequential"] = (time.perf_counter() - t) * 1e3
        n_dev = len([e for e in mx.FLIGHT.tail() if e["kind"] == "verify.device"]) - n_dev
        got = [(e.tx_id, e.status.value) for evs in results for e in evs]
        want = [(f"{run[0]}-g{g}-{j}", "Valid") for g in range(n_groups) for j in range(group)]
        if got != want or net_b.height() != n_groups or n_dev != n_groups:
            bad = [(x, y) for x, y in zip(got, want) if x != y]
            fail(f"[ttx] backlog {run}: {len(bad)} statuses differ ({bad[:2]}), "
                 f"{net_b.height()} blocks, {n_dev} batched verifies, expected {n_groups}")
        if (a_b.balance("USD"), b_b.balance("USD")) != (n_mint * sum(in_vals) - moved, moved):
            fail(f"[ttx] backlog {run}: balances {a_b.balance('USD')}, {b_b.balance('USD')}")
        if a_b.selectors.locker.locked_count() or any(
                a_b.db.status(tx) != "Confirmed" for tx, _ in want):
            fail(f"[ttx] backlog {run}: a token stays locked or a ttxdb row is not Confirmed")
        audited.update((tx, "Confirmed") for tx, _ in want)
        ms[f"backlog_{run}_txs_per_s"] = len(want) / (ms[f"backlog_{run}"] / 1e3)
        backlog[run] = dict(commit_s=net_b.last_block["commit_s"],
                            breakdown=net_b.last_block["breakdown"])
        for p in (a_b, b_b):
            p.vault.store.close()

    # ---------------------------------------------------- 4. services, recovery
    t = time.perf_counter()
    redeem = Transaction(alice_p, "ttx-redeem")
    redeem.redeem("alice", "USD", 50)
    redeem.collect_endorsements(auditor)
    if redeem.submit().status.value != "Valid":
        fail("[ttx] the redeem was rejected")
    audited["ttx-redeem"] = "Confirmed"
    replay = dataclasses.replace(pays[0].request, anchor="ttx-replay")
    auditor.audit(replay)
    ev = net.submit(replay.to_bytes())
    if ev.status.value != "Invalid" or not ("spent" in ev.message or "exist" in ev.message):
        fail(f"[ttx] the re-audited replay gave {ev.status.value} {ev.message!r}")
    audited["ttx-replay"] = "Deleted"
    state = {"artist": "banksy", "work": "ttx smoke"}
    nft_type = NFTService(issuer_p).issue("issuer", state, alice.recipient_identity(), auditor,
                                          tx_id="ttx-nft-issue")
    if NFTService(alice_p).my_nfts() != [nft_type] or not NFTService(alice_p).state_matches(
            nft_type, state):
        fail("[ttx] alice does not hold the NFT")
    NFTService(alice_p).transfer("alice", nft_type, bob.recipient_identity(), auditor,
                                 tx_id="ttx-nft-xfer")
    if NFTService(alice_p).my_nfts() or NFTService(bob_p).my_nfts() != [nft_type]:
        fail("[ttx] the NFT did not move to bob")
    audited.update({"ttx-nft-issue": "Confirmed", "ttx-nft-xfer": "Confirmed"})
    certifier = CertificationService(net, rng=rng)
    bob_tok = next(i for i in bob_p.vault.token_ids() if i.tx_id.startswith("ttx-pay"))
    certifier.certify_into(bob_p.vault, bob_tok)
    certifier.verify(bob_tok, net.resolve_input(bob_tok), bob_p.vault.certification(bob_tok))
    try:
        certifier.certify(pays[0].request.transfers[0].input_ids[0])
        fail("[ttx] a spent token was certified")
    except ValidationError:
        pass
    alice_usd = want_alice - sent - 50
    owner_a, owner_b = OwnerService(alice_p.db), OwnerService(bob_p.db)
    checks = {
        "alice's payments": (owner_a.payments("alice", "USD"), sent + 50),
        "alice's holdings": (owner_a.holdings("alice", "USD"), alice_usd),
        "bob's holdings": (owner_b.holdings("bob", "USD"), sent),
        "alice's confirmed history": (len(owner_a.history("Confirmed")), n_block - 1 + 2),
        "alice's deleted history": ([r.tx_id for r in owner_a.history("Deleted")],
                                    [pays[planted].tx_id]),
        "alice's balances": (QueryService(alice_p.vault).balances_by_type(), {"USD": alice_usd}),
        "bob's balances": (QueryService(bob_p.vault).balances_by_type(),
                           {"USD": sent, nft_type: 1}),
        "the auditor's db": ({tx: auditor.db.status(tx) for tx in audited}, audited),
    }
    for what, (got_, want_) in checks.items():
        if got_ != want_:
            fail(f"[ttx] {what}: {str(got_)[:300]} != {str(want_)[:300]}")
    if len(auditor.db.transactions()) != len(audited):
        fail(f"[ttx] the auditor's db holds {len(auditor.db.transactions())} transactions, "
             f"not {len(audited)}")
    held = {}
    for name, p in (("alice", alice_p), ("bob", bob_p)):
        held[name] = (sorted(i.key() for i in p.vault.token_ids()), p.vault.balance("USD"))
        p.vault.store.close()
    for name in held:
        p = party(name, net, path(f"{name}.vault"))
        again = (sorted(i.key() for i in p.vault.token_ids()), p.vault.balance("USD"))
        if again != held[name]:
            fail(f"[ttx] {name} rebuilt from the vault journal holds {again[1]} in "
                 f"{len(again[0])} tokens, not {held[name][1]} in {len(held[name][0])}")
        p.vault.store.close()
    ms["services"] = (time.perf_counter() - t) * 1e3

    # ---------------------------------------------------- 5. no host re-verification
    fallbacks = [e for e in mx.FLIGHT.tail()
                 if e["kind"].endswith((".host_fallback", ".device_error"))]
    if delta("ledger.block.batch_errors") or delta("batch.sign.host_fallbacks") or fallbacks:
        fail(f"[ttx] host re-verification: batch_errors {delta('ledger.block.batch_errors')}, "
             f"sign host_fallbacks {delta('batch.sign.host_fallbacks')}, events {fallbacks[:3]}")
    states = resilience.breaker_states()
    if any(v != "closed" for v in states.values()):
        fail(f"[ttx] breakers {states}")
    tmp.cleanup()
    ms.update(phase=(time.perf_counter() - t_phase) * 1e3, device=str(net.device),
              issue_block_last=dict(commit_s=issue_block["commit_s"],
                                    breakdown=issue_block["breakdown"]),
              transfer_block_last=dict(commit_s=transfer_block["commit_s"],
                                       breakdown=transfer_block["breakdown"]),
              backlog_last=backlog, launches=launches, breakers=states,
              sign_rows=delta("batch.sign.rows"), batched=delta("ledger.validate.batched"),
              host=delta("ledger.validate.host"), groups=groups, group=group,
              seq_groups=min(groups, TTX_SEQ_GROUPS), issue_block_txs=len(issues))
    return ms


def ttx_line(ms: dict) -> str:
    """The `[ttx]` phase's times as one line."""
    def bd(block):
        return {k: round(v * 1e3, 1) for k, v in block["breakdown"].items() if v}

    n = ms["groups"] * ms["group"]
    tm = ms.get("backlog_p_transfer_many", [])
    return (
        f"Party/Transaction on {ms['device']}: issue block ({ms['issue_block_txs']} issue "
        f"Transactions, submit_async then wait) {ms['issue_block']:.1f} ms (assembly with the "
        f"host issue proofs {ms['issue_assemble']:.1f} ms), cut to finality "
        f"{ms['issue_block_last']['commit_s'] * 1e3:.1f} ms, breakdown (ms) "
        f"{bd(ms['issue_block_last'])}; host prove a Transaction.transfer "
        f"{ms['host_prove_transaction']:.1f} ms (the block's {ms['transfer_block_txs']} predicted "
        f"{ms['transfer_block_predicted_s']:.1f} s, took {ms['transfer_assemble'] / 1e3:.1f} s); "
        f"transfer block ({ms['transfer_block_txs']} 2-in/2-out, one tampered proof) "
        f"{ms['transfer_block']:.1f} ms, cut to finality "
        f"{ms['transfer_block_last']['commit_s'] * 1e3:.1f} ms, breakdown (ms) "
        f"{bd(ms['transfer_block_last'])}; {n}-tx backlog in {ms['groups']} groups of "
        f"{ms['group']} (selector, one transfer_many, signatures, audit; mint "
        f"{ms['backlog_mint']:.1f} ms): pipelined_submit {ms['backlog_pipelined']:.1f} ms "
        f"({ms['backlog_pipelined_txs_per_s']:.1f} tx/s, ttx.pipeline.overlap_frac "
        f"{ms['overlap_frac']}, transfer_many {statistics.median(tm) if tm else 0:.1f} ms a "
        f"group), sequential over the first {ms['seq_groups']} groups "
        f"{ms['backlog_sequential']:.1f} ms ({ms['backlog_sequential_txs_per_s']:.1f} tx/s), "
        f"last block breakdown (ms) "
        f"pipelined {bd(ms['backlog_last']['pipelined'])} sequential "
        f"{bd(ms['backlog_last']['sequential'])}; services (redeem, replay, NFT, "
        f"certification, owner and query views, vault rebuilds) {ms['services']:.1f} ms. "
        f"Statuses, balances, ttxdb and auditor rows and the rebuilt vaults exact; "
        f"{ms['batched']} transfer records batched, {ms['host']} on the host (lone submits, "
        f"by policy), {ms['sign_rows']} pk signatures on the sign plane; no host "
        f"re-verification, breakers {ms['breakers']}; phase {ms['phase'] / 1e3:.1f} s")


REPL_ISSUE = 16  # the [repl] issue blocks' requests
REPL_GROUP = 64  # the [ledger] backlog in submit_many groups of one block each
REPL_KILL_GROUP = 8  # the group in flight (0-based) when the leader is killed
REPL_PROBE_GROUP = 3  # the group during which ops.health is probed
REPL_NODE_TIMEOUT_S = 300.0  # a node's start to READY, at most
REPL_SHIP_DEADLINE_S = 120.0  # the killed group's block on the follower, at most


def repl_node(role: str, work: str, port: int, peer: str, device, block: int,
              pairing: bool) -> int:
    """One ledger node of the `[repl]` phase, run by it as
    `chip_smoke.py --repl-node ROLE --repl-work DIR ...`: reads the public
    parameters the phase wrote, builds the zkatdlog `RequestValidator`,
    runs `warmup()` (every extension built or loaded, each kernel launched
    once) and builds the zkatdlog driver's batched verifier, then a `Network` at
    `max_block_txs=block` on `device` (None: the card). The leader is
    recovered from `DIR/leader.wal` (a snapshot and no journal: the
    backlog's minted inputs), waits for the follower's `LedgerServer` and
    attaches to it as the replication leader, then waits until the
    follower is streaming (bootstrapped); the follower starts empty and
    attaches as a follower. Prints `READY <port> <json>` (its times and the
    extensions built and loaded), then serves until SIGTERM (an orderly
    stop, which flushes its metrics and flight sidecars to
    `DIR/<role>.metrics.json` and `.flight.json` for `[ops]`) or
    SIGKILL. Spans are on, and a `Heartbeat` records the node's phases
    (warmup, tables, serve). A node without CUDA, or whose build fails,
    exits non-zero."""
    import signal
    import socket
    import threading

    t_start = time.perf_counter()
    import torch

    if device is None and not torch.cuda.is_available():
        fail(f"[repl] {role}: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from fabric_token_sdk_tpu_torch.api.validator import RequestValidator
    from fabric_token_sdk_tpu_torch.crypto.setup import PublicParams
    from fabric_token_sdk_tpu_torch.drivers.zkatdlog import ZKATDLogDriver
    from fabric_token_sdk_tpu_torch.ops import warmup as wu
    from fabric_token_sdk_tpu_torch.services.network import (
        BlockPolicy, LedgerServer, Network, replication,
    )
    from fabric_token_sdk_tpu_torch.services.network.remote import _recv_msg, _send_msg
    from fabric_token_sdk_tpu_torch.utils import metrics as mx

    t_import = time.perf_counter() - t_start
    mx.enable(True)  # spans, for the post-failover trace [ops] stitches
    mx.REGISTRY.set_meta("entry", f"chip_smoke --repl-node {role}")
    heartbeat = mx.Heartbeat(tag=f"fts-{role}", interval_s=60.0).start()
    with open(os.path.join(work, "pp.bin"), "rb") as fh:
        pp = PublicParams.deserialize(fh.read())
    validator = RequestValidator(ZKATDLogDriver(pp, device=device))
    heartbeat.set_phase("warmup")
    t = time.perf_counter()
    summary = wu.warmup(device=device, include_pairing=pairing)
    warm_s = time.perf_counter() - t
    heartbeat.set_phase("tables", programs=summary["programs"])
    t = time.perf_counter()
    validator.driver.batch_verifier()  # its tables, off the first block
    verifier_s = time.perf_counter() - t
    policy = BlockPolicy(max_block_txs=block, sign_batched=None if device is None else True)
    wal = os.path.join(work, f"{role}.wal")
    if role == "leader":
        net = Network.recover(validator, wal, policy=policy, device=device)
    else:
        net = Network(validator, policy, wal_path=wal, device=device)
    server = LedgerServer(network=net, port=port).start()
    if role == "follower":
        replication.attach_follower(net)
    else:
        host, _, fport = peer.rpartition(":")
        deadline = time.monotonic() + REPL_NODE_TIMEOUT_S
        while True:  # the follower's server up: an ops.health answer
            try:
                with socket.create_connection((host, int(fport)), timeout=2.0) as sock:
                    _send_msg(sock, {"op": "ops.health"})
                    if (_recv_msg(sock) or {}).get("ok"):
                        break
            except OSError:
                pass
            if time.monotonic() > deadline:
                fail("[repl] leader: the follower never answered")
            time.sleep(0.05)
        state = replication.attach_leader(net, [(host, int(fport))])
        while state.shipper.link_states()[0]["state"] != "streaming":
            if time.monotonic() > deadline:
                fail(f"[repl] leader: the link never streamed: {state.shipper.link_states()}")
            time.sleep(0.02)
    heartbeat.set_phase("serve")
    sidecar = os.path.join(work, f"{role}.metrics.json")
    signal.signal(signal.SIGTERM, lambda *_: (server.stop(), heartbeat.stop(),
                                               mx.flush_sidecar(sidecar), os._exit(0)))
    print("READY", server.address[1], json.dumps({
        "role": role, "pid": os.getpid(), "device": str(net.device), "height": net.height(),
        "import_s": t_import, "warmup_s": warm_s, "verifier_s": verifier_s,
        "ready_s": time.perf_counter() - t_start, "programs": summary["programs"],
        "built": summary["built"], "loaded": summary["loaded"]}), flush=True)
    threading.Event().wait()
    return 0


def repl_phase(pp, ctx, range_launches, sign_launches, block=BLOCK_TXS, n_issue=REPL_ISSUE,
               group=REPL_GROUP, kill_group=REPL_KILL_GROUP, probe_group=REPL_PROBE_GROUP,
               device=None, pairing=True) -> dict:
    """The replicated ledger on the card, over the wire: two node
    processes (`repl_node`), the smoke's process the client.

    The leader starts from the snapshot `[ledger]`'s backlog started from
    (its minted inputs, under one empty genesis block, so that the empty
    follower's catch-up is a `repl.bootstrap`); a `RemoteNetwork(
    endpoints=[leader, follower])` sends an issue block of `n_issue` of
    `[drivers]`' issue requests, one with a forged issuer signature (the
    sign plane), then the backlog as `submit_many` groups of `group` (a
    block each, the proof plane). `ops.health` is probed from another
    client while group `probe_group` validates. The leader is
    SIGKILLed as soon as the follower holds group `kill_group`'s block,
    while the leader waits for that ship's answer and before its acks go
    out; the follower is promoted over the wire; the client resolves the
    killed group exactly once by adopting the verdicts the new leader
    holds (`status` of each of its txs, which fails the client over),
    then sends the rest of the backlog and a second issue block, all
    validated on the promoted node's card.

    Fails unless: every acknowledged status equals `[ledger]`'s for the
    same request (the forged issues rejected by the sign plane, the rest
    valid); no tx is committed twice and none acknowledged is lost (the
    promoted node's journal recovered on the CPU with `Network.recover`,
    which re-verifies nothing); its state equals `[ledger]`'s backlog end
    state plus the valid issues' outputs; the follower's height at the
    kill covers every group acknowledged before it; each node's kernel
    launches (`kernel.launches.*` over `ops.metrics`, the leader's just
    before the kill) equal the plan, the follower's none before its
    promotion; no host re-verification, no `DevicePlaneError`, every
    breaker closed; `ops.health` answered while a block validated;
    `device.mem.bytes` above 0 and below the card's memory. Returns the
    times."""
    import select
    import signal
    import socket
    import tempfile
    import threading

    import torch

    from fabric_token_sdk_tpu_torch.api.request import IssueRecord, TokenRequest
    from fabric_token_sdk_tpu_torch.api.validator import RequestValidator
    from fabric_token_sdk_tpu_torch.crypto.serialization import dumps, loads
    from fabric_token_sdk_tpu_torch.drivers.zkatdlog import ZKATDLogDriver
    from fabric_token_sdk_tpu_torch.ops import _build
    from fabric_token_sdk_tpu_torch.services.network import Network, RemoteNetwork
    from fabric_token_sdk_tpu_torch.utils import metrics as mx

    ms = {}
    t_phase = time.perf_counter()
    if device is None:
        torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the nodes
    tmp = tempfile.TemporaryDirectory()
    work = tmp.name
    with open(os.path.join(work, "pp.bin"), "wb") as fh:
        fh.write(pp.serialize())
    minted = loads(ctx["backlog_minted"])
    minted["blocks"] = [[0, [], 0.0]]  # the genesis block: height 1
    with open(os.path.join(work, "leader.wal.snap"), "wb") as fh:
        fh.write(dumps(minted))
    with socket.socket() as s:  # the follower's port, known to the leader at spawn
        s.bind(("127.0.0.1", 0))
        fport = s.getsockname()[1]

    def spawn(role, port, peer):
        cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--repl-node", role,
               "--repl-work", work, "--repl-port", str(port), "--repl-peer", peer,
               "--repl-block", str(block)]
        if device is not None:
            cmd += ["--repl-device", str(device)]
        if not pairing:
            cmd += ["--repl-no-pairing"]
        err = open(os.path.join(work, f"{role}.err"), "w")
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err, text=True), err

    def tail(role):
        with open(os.path.join(work, f"{role}.err")) as fh:
            return fh.read()[-3000:]

    procs = {}
    try:
        t_spawn = time.perf_counter()
        procs["follower"] = spawn("follower", fport, "-")
        procs["leader"] = spawn("leader", 0, f"127.0.0.1:{fport}")
        nodes = {}
        deadline = time.monotonic() + REPL_NODE_TIMEOUT_S
        while len(nodes) < 2:
            for role, (proc, _err) in procs.items():
                if role in nodes:
                    continue
                if proc.poll() is not None:
                    fail(f"[repl] the {role} exited with {proc.returncode}:\n{tail(role)}")
                ready, _, _ = select.select([proc.stdout], [], [], 0.05)
                if ready:
                    line = proc.stdout.readline()
                    if not line.startswith("READY"):
                        fail(f"[repl] the {role} printed {line!r}:\n{tail(role)}")
                    _, port, info = line.split(" ", 2)
                    nodes[role] = dict(json.loads(info), port=int(port),
                                       spawn_to_ready_s=time.perf_counter() - t_spawn)
            if time.monotonic() > deadline:
                fail(f"[repl] nodes not ready: {sorted(nodes)}")
        for role, info in nodes.items():
            if info["device"] != str(torch.device("cuda" if device is None else device)):
                fail(f"[repl] the {role} runs on {info['device']}")
        ms["nodes"] = nodes
        leader_addr = ("127.0.0.1", nodes["leader"]["port"])
        follower_addr = ("127.0.0.1", nodes["follower"]["port"])
        client = RemoteNetwork(endpoints=[leader_addr, follower_addr], timeout=600.0,
                               retries=8, backoff_s=0.05)
        to_leader = RemoteNetwork(leader_addr, timeout=600.0)
        to_follower = RemoteNetwork(follower_addr, timeout=600.0, retries=8, backoff_s=0.1)

        def launches(remote_net):
            c = remote_net.ops_metrics()["counters"]
            return {k.name: c.get(f"kernel.launches.{k.name}", 0) for k in _build.ALL_KERNELS}

        def minus(a, b):
            return {k: a[k] - b[k] for k in a}

        def times(plan, n):
            return {k: v * n for k, v in plan.items()}

        def plus(a, b):
            return {k: a[k] + b[k] for k in a}

        base = {"leader": launches(to_leader), "follower": launches(to_follower)}
        if nodes["follower"]["height"] != 0 or to_follower.height() != 1:
            fail("[repl] the follower did not bootstrap the leader's genesis snapshot")

        # ------------------------------------------------ the issue blocks
        def issue_block(k0, forge):
            reqs = list(ctx["issue_reqs"][k0:k0 + n_issue])
            genuine = reqs[forge].issues[0]
            forged = TokenRequest(anchor=reqs[forge].anchor)
            forged.issues.append(IssueRecord(
                action=genuine.action, issuer=genuine.issuer,
                outputs_metadata=list(genuine.outputs_metadata),
                receivers=list(genuine.receivers),
                signature=reqs[(forge + 1) % len(reqs)].issues[0].signature))
            reqs[forge] = forged
            want = [(r.anchor, "Valid", "") for r in reqs]
            want[forge] = (forged.anchor, "Invalid",
                           "invalid issuer signature: rejected by the batched signature plane")
            return reqs, want

        def statuses(events):
            return [(e.tx_id, e.status.value, e.message) for e in events]

        issues1, want_i1 = issue_block(0, 3 % n_issue)
        t = time.perf_counter()
        got = statuses(client.submit_many([r.to_bytes() for r in issues1]))
        ms["issue_block_1"] = (time.perf_counter() - t) * 1e3
        if got != want_i1:
            fail(f"[repl] issue block 1: {[(g, w) for g, w in zip(got, want_i1) if g != w][:2]}")

        # ------------------------------------------------ the backlog, to the kill
        reqs_b = ctx["reqs_b"]
        want_b = {s[0]: s for s in ctx["backlog_statuses"]}
        groups = [reqs_b[i:i + group] for i in range(0, len(reqs_b), group)]
        if len(groups) <= kill_group + 1:
            fail(f"[repl] {len(groups)} groups: the kill needs more")
        acked, group_ms = {}, []

        def submit(g):
            """The wire call alone (threads run it; checks stay in the main
            thread, where `fail` exits)."""
            t_ = time.perf_counter()
            evs = statuses(client.submit_many([r.to_bytes() for r in groups[g]]))
            group_ms.append((time.perf_counter() - t_) * 1e3)
            return evs

        def record(g, evs):
            for e in evs:
                if e != want_b[e[0]]:
                    fail(f"[repl] group {g}: {e}, [ledger] gave {want_b[e[0]]}")
                if e[0] in acked:
                    fail(f"[repl] {e[0]} acknowledged twice")
                acked[e[0]] = e

        def in_thread(g, box):
            try:
                box["events"] = submit(g)
            except Exception as e:  # noqa: BLE001 -- judged by the caller
                box["error"] = e
            finally:
                box["done"].set()

        probes = []
        t = time.perf_counter()
        for g in range(kill_group):
            if g != probe_group:
                record(g, submit(g))
                continue
            prober = RemoteNetwork(leader_addr, timeout=60.0)
            box = {"done": threading.Event()}
            thread = threading.Thread(target=in_thread, args=(g, box))
            thread.start()
            while not box["done"].is_set():  # probes during the block, on their own connection
                t_ = time.perf_counter()
                h = prober.ops_health()
                probes.append(((time.perf_counter() - t_) * 1e3, box["done"].is_set(),
                               h["inflight"]))
                time.sleep(0.01)
            thread.join()
            prober.close()
            if "error" in box:
                fail(f"[repl] group {g}: {box['error']!r}")
            record(g, box["events"])
        ms["backlog_before_s"] = time.perf_counter() - t
        ms["backlog_before_txs_per_s"] = kill_group * group / ms["backlog_before_s"]
        during = [p for p in probes if not p[1]]
        if not during or not any(p[2] for p in during):
            fail(f"[repl] no ops.health answer while a block was in flight: {probes[:4]}")
        lat = sorted(p[0] for p in during)
        ms["probe_ms"] = {"n": len(lat), "median": statistics.median(lat),
                          "p95": lat[int(0.95 * (len(lat) - 1))], "max": lat[-1]}
        acked_before = len(acked)

        # ------------------------------------------------ the leader, just before the kill
        lh = to_leader.ops_health()
        lsnap = to_leader.ops_metrics()
        lflight = to_leader.ops_flight(1 << 20)
        plan_l = plus(times(range_launches, kill_group), sign_launches)
        got_l = minus(launches(to_leader), base["leader"])
        if got_l != plan_l:
            fail(f"[repl] leader launches {got_l}, planned {plan_l}")
        ship = lsnap["histograms"].get("repl.ship.wait.seconds", {})
        if ship.get("count", 0) < kill_group + 1:
            fail(f"[repl] {ship.get('count')} ship waits for {kill_group + 1} blocks")
        ms["ship_wait_ms"] = {k: ship[k] * 1e3 for k in ("p50", "p95", "max", "mean")}
        degraded = {k: lsnap["counters"].get(k, 0) for k in (
            "repl.ship.ack_timeouts", "repl.ship.unsynced", "repl.ship.dropped",
            "repl.link.errors")}
        if any(degraded.values()):
            fail(f"[repl] the leader's shipping degraded: {degraded}, links {lh['repl']}")
        ms["leader_links"] = lh["repl"]["followers"]
        checks = {"leader": (lh, lsnap, lflight)}
        h_acked = 2 + kill_group  # genesis, the issue block, the acknowledged groups
        if lh["height"] != h_acked:
            fail(f"[repl] leader at height {lh['height']}, expected {h_acked}")

        # ------------------------------------------------ kill, promote, fail over
        outcome = {"done": threading.Event()}
        thread = threading.Thread(target=in_thread, args=(kill_group, outcome))
        thread.start()
        # the kill on replication state: once the follower holds the
        # group's block, the leader is inside its ship wait and the acks
        # are not yet out, so the client must adopt the replicated verdicts
        h_ship = h_acked + 1
        deadline = time.monotonic() + REPL_SHIP_DEADLINE_S
        while to_follower.height() < h_ship:
            if time.monotonic() > deadline:
                fail(f"[repl] the follower never reached height {h_ship}:\n"
                     f"{tail('follower')}")
            time.sleep(0.002)
        t_kill = time.perf_counter()
        procs["leader"][0].send_signal(signal.SIGKILL)
        procs["leader"][0].wait(timeout=60)
        thread.join(timeout=120)
        if thread.is_alive():
            fail("[repl] the in-flight group never returned after the kill")
        if "events" in outcome:  # acks out before the kill, or verdicts adopted by the client
            record(kill_group, outcome["events"])
            h_acked += 1
        h_kill = to_follower.height()
        if h_kill != h_ship:
            rc = {k: v for k, v in lsnap["counters"].items() if k.startswith("repl.")}
            fail(f"[repl] follower at height {h_kill} at the kill, {h_acked} acknowledged; "
                 f"leader links {lh['repl']}, counters {rc}:\n{tail('follower')}")
        if minus(launches(to_follower), base["follower"]) != times(range_launches, 0):
            fail("[repl] the follower launched kernels before its promotion")
        t = time.perf_counter()
        epoch = to_follower.promote()
        ms["promote_ms"] = (time.perf_counter() - t) * 1e3
        if epoch != 1:
            fail(f"[repl] promoted at epoch {epoch}")
        # the killed group, exactly once: what the new leader holds is adopted
        killed = groups[kill_group]
        known = [client.status(r.anchor) for r in killed]  # fails the client over
        if client.address != follower_addr:
            fail(f"[repl] the client did not fail over: {client.address}")
        held = [r for r, k in zip(killed, known) if k is not None]
        if len(held) != len(killed):
            fail(f"[repl] {len(held)} of the killed group's {len(killed)} txs on the new leader")
        for r, k in zip(killed, known):
            e = (r.anchor, k.status.value, k.message)
            if e != want_b[r.anchor]:
                fail(f"[repl] killed group: {e}, [ledger] gave {want_b[r.anchor]}")
            if r.anchor in acked and acked[r.anchor] != e:
                fail(f"[repl] {r.anchor} acknowledged {acked[r.anchor]}, held {e}")
            acked[r.anchor] = e
        ms["adopted_s"] = time.perf_counter() - t_kill
        t = time.perf_counter()
        t_first = None
        for g in range(kill_group + 1, len(groups)):
            traced = g == len(groups) - 1  # [ops] stitches a tx of the last group
            mx.enable(traced)
            try:
                record(g, submit(g))
            finally:
                mx.enable(False)
            if traced:
                mx.flush_sidecar(os.path.join(work, "client.metrics.json"))
            if t_first is None:
                t_first = time.perf_counter()
        blocks_new = len(groups) - kill_group - 1
        ms["failover_s"] = t_first - t_kill
        ms["backlog_after_s"] = time.perf_counter() - t
        ms["backlog_after_txs_per_s"] = (sum(map(len, groups[kill_group + 1:]))
                                         / ms["backlog_after_s"])
        ms["killed_group"] = {"held": len(held),
                              "client_saw": "events" if "events" in outcome else
                              type(outcome.get("error")).__name__}
        issues2, want_i2 = issue_block(n_issue, 5 % n_issue)
        t = time.perf_counter()
        got = statuses(client.submit_many([r.to_bytes() for r in issues2]))
        ms["issue_block_2"] = (time.perf_counter() - t) * 1e3
        if got != want_i2:
            fail(f"[repl] issue block 2: {[(g, w) for g, w in zip(got, want_i2) if g != w][:2]}")
        if len(acked) != len(reqs_b) or acked_before != sum(map(len, groups[:kill_group])):
            fail(f"[repl] {len(acked)} of {len(reqs_b)} backlog txs acknowledged")

        # ------------------------------------------------ the promoted node
        fh = to_follower.ops_health()
        fsnap = to_follower.ops_metrics()
        checks["follower"] = (fh, fsnap, to_follower.ops_flight(1 << 20))
        plan_f = plus(times(range_launches, blocks_new), sign_launches)
        got_f = minus(launches(to_follower), base["follower"])
        if got_f != plan_f:
            fail(f"[repl] promoted follower launches {got_f}, planned {plan_f}")
        ms["launches"] = {"leader": got_l, "follower": got_f}
        total = torch.cuda.get_device_properties(0).total_memory if device is None else None
        ms["device_mem_bytes"] = {}
        for role, (h, snap, flight) in checks.items():
            c = snap["counters"]
            bad = {k: c.get(k, 0) for k in ("ledger.block.batch_errors",
                                            "batch.sign.host_fallbacks",
                                            "remote.dispatch.errors.submit_many",
                                            "remote.dispatch.errors.submit")}
            events = [e["kind"] for e in flight
                      if e["kind"].endswith((".host_fallback", ".device_error"))]
            if any(bad.values()) or events:
                fail(f"[repl] {role}: host re-verification or a failed plane: {bad}, {events[:3]}")
            if any(v != "closed" for v in h["breakers"].values()):
                fail(f"[repl] {role}: breakers {h['breakers']}")
            mem = snap["gauges"].get("device.mem.bytes")
            ms["device_mem_bytes"][role] = mem
            if device is None and not (mem and 0 < mem < total):
                fail(f"[repl] {role}: device.mem.bytes {mem} (card {total})")
        if fh["repl"]["role"] != "leader" or fh["repl"]["epoch"] != 1:
            fail(f"[repl] the promoted node reports {fh['repl']}")
        t_ops = time.perf_counter()
        ms["ops"] = ops_node(follower_addr, to_follower, nodes["follower"], fsnap, work)
        t_ops = time.perf_counter() - t_ops
        height = to_follower.height()
        for c in (client, to_leader, to_follower):
            c.close()
        # an orderly stop, then its journal recovered on the CPU
        proc = procs["follower"][0]
        proc.send_signal(signal.SIGTERM)
        if proc.wait(timeout=60) != 0:
            fail(f"[repl] the follower stopped with {proc.returncode}:\n{tail('follower')}")
        t = time.perf_counter()
        ms["ops"].update(ops_trace(work, groups[-1][0].anchor,
                                   (os.getpid(), nodes["follower"]["pid"])))
        ms["ops"]["phase_s"] = t_ops + time.perf_counter() - t
    finally:
        for proc, err in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            err.close()
    t = time.perf_counter()
    cpu_validator = RequestValidator(ZKATDLogDriver(pp, device="cpu"))
    rec = Network.recover(cpu_validator, os.path.join(work, "follower.wal"), device="cpu")
    ms["recover_cpu_ms"] = (time.perf_counter() - t) * 1e3
    if rec.height() != height:
        fail(f"[repl] the promoted node's journal recovers {rec.height()} blocks of {height}")
    seen = {}
    for number in range(rec.height()):
        for tx in rec.block(number).txs:
            seen[tx] = seen.get(tx, 0) + 1
    twice = [tx for tx, n in seen.items() if n > 1]
    lost = [tx for tx in list(acked) + [r.anchor for r in issues1 + issues2] if tx not in seen]
    if twice or lost:
        fail(f"[repl] committed twice {twice[:3]}, acknowledged and lost {lost[:3]}")
    for tx, e in list(acked.items()) + [(w[0], w) for w in want_i1 + want_i2]:
        got = rec.status(tx)
        if (tx, got.status.value, got.message) != e:
            fail(f"[repl] recovered status of {tx}: {got}, acknowledged {e}")
    end, want_end = loads(rec.snapshot()), ctx["backlog_end"]
    valid_issues = {r.anchor: len(r.issues[0].outputs_metadata)
                    for r, w in zip(issues1 + issues2, want_i1 + want_i2) if w[1] == "Valid"}
    extra = {k for k in end["state"] if k not in want_end["state"]}
    if ({k: v for k, v in end["state"].items() if k in want_end["state"]} != want_end["state"]
            or sorted(end["spent"]) != sorted(want_end["spent"])
            or {k.rsplit(".", 1)[0] for k in extra} != set(valid_issues)
            or len(extra) != sum(valid_issues.values())):
        fail("[repl] the promoted node's state is not [ledger]'s backlog end state plus the "
             "valid issues' outputs")
    tmp.cleanup()
    ms.update(phase=(time.perf_counter() - t_phase) * 1e3, height=height, h_kill=h_kill,
              h_acked=h_acked, blocks_new=blocks_new, group_ms=group_ms, kill_group=kill_group,
              acked=len(acked) + len(valid_issues))
    return ms


def repl_line(ms: dict) -> str:
    """The `[repl]` phase's times as one line."""
    n = ms["nodes"]
    node = "; ".join(
        f"{r} start to READY {n[r]['spawn_to_ready_s']:.1f} s (import {n[r]['import_s']:.1f}, "
        f"warmup {n[r]['warmup_s']:.2f} s over {n[r]['programs']} programs, extensions built "
        f"{n[r]['built']} / loaded {n[r]['loaded']}, verifier tables "
        f"{n[r]['verifier_s']:.2f} s)" for r in ("leader", "follower"))
    p = ms["probe_ms"]
    return (
        f"{node}; issue block {ms['issue_block_1']:.1f} ms (one forged signature rejected by "
        f"the leader's sign plane); backlog over the wire before the kill "
        f"{ms['backlog_before_txs_per_s']:.1f} tx/s, after {ms['backlog_after_txs_per_s']:.1f} "
        f"tx/s (groups median {statistics.median(ms['group_ms']):.1f} ms); ship wait a block "
        f"(ms) {ms['ship_wait_ms']}; ops.health during a block {p['n']} probes, median "
        f"{p['median']:.2f} ms, p95 {p['p95']:.2f} ms, max {p['max']:.2f} ms; leader SIGKILLed "
        f"in group "
        f"{ms['kill_group'] + 1} at height {ms['h_acked']} (follower at {ms['h_kill']}), "
        f"killed group {ms['killed_group']}, promote {ms['promote_ms']:.1f} ms, its verdicts "
        f"adopted {ms['adopted_s']:.2f} s after the kill, failover (kill to the new leader's "
        f"first block acknowledged) {ms['failover_s']:.2f} s; second issue block "
        f"{ms['issue_block_2']:.1f} ms; launches leader {ms['launches']['leader']}, promoted "
        f"follower {ms['launches']['follower']} ({ms['blocks_new']} transfer blocks); "
        f"device.mem.bytes {ms['device_mem_bytes']}; journal recovered on the CPU in "
        f"{ms['recover_cpu_ms']:.1f} ms at height {ms['height']}; every acknowledged status "
        f"equals [ledger]'s, none lost or doubled, end state exact, no host re-verification; "
        f"phase {ms['phase'] / 1e3:.1f} s")


OPS_RUNS = 9  # [ops]: the 64-tx verify with the ledger on, and off, interleaved
OPS_PROGRAM_RUNS = 5  # [ops]: verifies for each program's ledger time at block rows
OPS_MAX_COST = 0.05  # [ops]: the ledger on may cost this share of the verify's median, ...
# ... or lie inside the off runs' own spread
OPS_TRACE_NEEDLES = ("remote.submit", "orderer.queue", "network.validate", "critical path",
                     "device_verify", "wal", "finality")


def ledger_cost(verifier, txs, runs=OPS_RUNS, program_runs=OPS_PROGRAM_RUNS) -> dict:
    """`[ops]` in this process: `runs` verifies of `txs` with the dispatch
    ledger on and `runs` with it off, interleaved (on-off, then off-on),
    verdicts equal throughout; then `program_runs` verifies alone, each
    program's device time a dispatch by the ledger's event pairs (the
    median over the runs) beside its dispatches and rows. Fails when
    the on median exceeds the off median by more than `OPS_MAX_COST`
    and lies outside the off runs' spread, or when a verify's dispatches
    differ from its launches."""
    import torch

    from fabric_token_sdk_tpu_torch.ops import _build
    from fabric_token_sdk_tpu_torch.utils import devobs

    walls = {True: [], False: []}
    want = None
    before = {k.name: k.launches for k in _build.ALL_KERNELS}
    try:
        for i in range(runs):
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                devobs.enable(on)
                t = time.perf_counter()
                got = verifier.verify(txs)
                torch.cuda.synchronize()
                walls[on].append(time.perf_counter() - t)
                want = got if want is None else want
                if list(got) != list(want):
                    fail(f"[ops] the verdicts moved with the ledger {'on' if on else 'off'}")
    finally:
        devobs.enable(True)
    launches = {k.name: k.launches - before[k.name] for k in _build.ALL_KERNELS}
    on_med, off_med = statistics.median(walls[True]), statistics.median(walls[False])
    if on_med > off_med * (1 + OPS_MAX_COST) and on_med > max(walls[False]):
        fail(f"[ops] the ledger costs the verify {100 * (on_med / off_med - 1):.1f}%: median "
             f"{on_med * 1e3:.1f} ms on, {off_med * 1e3:.1f} off (off runs "
             f"{min(walls[False]) * 1e3:.1f}-{max(walls[False]) * 1e3:.1f} ms)")
    per_run = {}
    for _ in range(program_runs):
        devobs.reset()
        before = {k.name: k.launches for k in _build.ALL_KERNELS}
        verifier.verify(txs)
        torch.cuda.synchronize()
        snap = devobs.snapshot()
        if {prog for pl, prog in snap} != {k for k, v in launches.items() if v} or any(
                pl != "verify" for pl, _prog in snap):
            fail(f"[ops] a verify's ledger frames {sorted(snap)}")
        for (_pl, prog), e in snap.items():
            n = next(k for k in _build.ALL_KERNELS if k.name == prog).launches - before[prog]
            if e["dispatches"] != n:
                fail(f"[ops] {prog}: {e['dispatches']} dispatches, {n} launches")
            per_run.setdefault(prog, []).append((e["wall_s"] * 1e3 / e["dispatches"],
                                                 e["rows"] // e["dispatches"], e["dispatches"]))
    devobs.reset()
    programs = {prog: {"ms": statistics.median(r[0] for r in runs_), "rows": runs_[0][1],
                       "dispatches": runs_[0][2], "ms_min": min(r[0] for r in runs_),
                       "ms_max": max(r[0] for r in runs_)}
                for prog, runs_ in per_run.items()}
    return {"on_ms": [w * 1e3 for w in walls[True]], "off_ms": [w * 1e3 for w in walls[False]],
            "on_median_ms": on_med * 1e3, "off_median_ms": off_med * 1e3,
            "cost_frac": on_med / off_med - 1, "launches": launches, "programs": programs}


def ops_node(addr, remote_net, node: dict, snap_before: dict, work: str) -> dict:
    """`[ops]` against the promoted node, before its orderly stop, with no
    new node process: `ftstop devices HOST:PORT --once` as an operator
    runs it (a subprocess), `top --once`, `ftsmetrics show --prometheus`
    and `diff` (its `ops.metrics` snapshots before and after) in this
    process; its `device` section: every kernel it launched listed, each
    program's dispatches over planes equal to `kernel.launches.<name>`,
    a p50 by events above zero a program, the builds and loads equal to
    its warmup's `built`/`loaded`; `tokengen gen dlog --base 16
    --exponent 2` and a `ZKATDLogDriver` over those parameters building
    its batched verifier on the card. Returns the times and counts."""
    import io

    from fabric_token_sdk_tpu_torch.cmd import ftsmetrics, ftstop, tokengen
    from fabric_token_sdk_tpu_torch.crypto.setup import PublicParams
    from fabric_token_sdk_tpu_torch.drivers.zkatdlog import ZKATDLogDriver
    from fabric_token_sdk_tpu_torch.ops import _build

    ms = {}
    target = f"{addr[0]}:{addr[1]}"

    def captured(fn, *a):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = fn(*a)
        return rc, out.getvalue()

    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "fabric_token_sdk_tpu_torch.cmd.ftstop",
                          "devices", target, "--once"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    ms["ftstop_devices_s"] = time.perf_counter() - t
    if res.returncode != 0:
        fail(f"[ops] ftstop devices exited {res.returncode}: {res.stderr[-2000:]}")
    listed = {line.split()[1] for line in res.stdout.strip().splitlines()[2:]}
    health, snap = remote_net.ops_health(), remote_net.ops_metrics()
    dev = health["device"]
    counts = {k.name: snap["counters"].get(f"kernel.launches.{k.name}", 0)
              for k in _build.ALL_KERNELS}
    dispatched, p50 = {}, {}
    for row in dev["programs"].values():
        if row["dispatches"]:
            dispatched[row["program"]] = dispatched.get(row["program"], 0) + row["dispatches"]
            if not (row["p50_s"] and row["p50_s"] > 0 and row["wall_s"] > 0):
                fail(f"[ops] {row['plane']}:{row['program']} has no device time: {row}")
            p50[f"{row['plane']}:{row['program']}"] = row["p50_s"] * 1e3
    launched = {k: v for k, v in counts.items() if v}
    if dispatched != launched:
        fail(f"[ops] the node's ledger dispatches {dispatched}, its kernels launched {launched}")
    if not set(launched) <= listed:
        fail(f"[ops] ftstop devices lists {sorted(listed)}, the node launched {sorted(launched)}")
    progs = dev["programs"].values()
    builds = (sum(r["compiles"] for r in progs),
              sum(r["cache_hits"] + r["cache_misses"] for r in progs))
    if builds != (node["built"], node["loaded"]):
        fail(f"[ops] the ledger's builds/loads {builds}, warmup's {node['built']}/{node['loaded']}")
    ms.update(dispatches=dispatched, p50_ms=p50, planes=sorted(dev["planes"]),
              builds=builds, device_name=dev["name"])
    rc, out = captured(ftstop.main, ["top", target, "--once"])
    if rc != 0 or "repl=leader@e1" not in out or "dev_mem=" not in out:
        fail(f"[ops] ftstop top: rc {rc}, {out!r}")
    paths = []
    for name, doc in (("ops_a", snap_before), ("ops_b", snap)):
        paths.append(os.path.join(work, f"{name}.metrics.json"))
        with open(paths[-1], "w") as fh:
            json.dump(doc, fh)
    rc, prom = captured(ftsmetrics.main, ["show", "--prometheus", paths[1]])
    for needle in ("# TYPE fts_device_dispatch_seconds histogram",
                   "fts_device_dispatch_seconds_p50", "fts_kernel_launches_miller ",
                   "fts_device_verify_occupancy_count"):
        if rc != 0 or needle not in prom:
            fail(f"[ops] ftsmetrics show --prometheus: rc {rc}, no {needle!r}")
    rc, diff = captured(ftsmetrics.main, ["diff", *paths])  # the ops calls served between
    if rc != 0 or not diff.startswith("== ") or "remote.server.dispatch.seconds" not in diff:
        fail(f"[ops] ftsmetrics diff: rc {rc}, {diff[:500]!r}")
    ms["prometheus_lines"] = len(prom.splitlines())
    arts = os.path.join(work, "arts")
    t = time.perf_counter()
    rc, _ = captured(tokengen.main, ["gen", "dlog", "--output", arts, "--base", "16",
                                     "--exponent", "2", "--seed", "7"])
    ms["tokengen_s"] = time.perf_counter() - t
    with open(os.path.join(arts, "zkatdlog_pp.json"), "rb") as fh:
        pp2 = PublicParams.deserialize(fh.read())
    pp2.validate()
    t = time.perf_counter()
    v = ZKATDLogDriver(pp2).batch_verifier()
    ms["tokengen_verifier_s"] = time.perf_counter() - t
    if v.device.type != "cuda":
        fail(f"[ops] the driver over tokengen's parameters verifies on {v.device}")
    return ms


def ops_trace(work: str, tx: str, pids: tuple) -> dict:
    """`[ops]` after the promoted node's orderly stop: `ftstrace timeline`
    stitches `tx` (a post-failover transfer) from this process's sidecar
    and the node's, flushed on SIGTERM (client submit, orderer queue,
    validation, the block's critical path with its device verify, WAL,
    finality), each side's spans present; `export` writes Chrome trace
    events; `ftsmetrics show` prints the node's heartbeat phases."""
    import io

    from fabric_token_sdk_tpu_torch.cmd import ftsmetrics, ftstrace

    paths = [os.path.join(work, f"{side}.{kind}.json") for side in ("client", "follower")
             for kind in ("metrics", "flight")]
    for p in paths:
        if not os.path.exists(p):
            fail(f"[ops] no sidecar {os.path.basename(p)}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ftstrace.main(["timeline", tx, *paths])
        rc_x = ftstrace.main(["export", "-o", os.path.join(work, "trace.json"), *paths])
        rc_m = ftsmetrics.main(["show", paths[2]])
    text = out.getvalue()
    timeline = text.split("\n== ")[0] if text.startswith("== trace") else text
    missing = [n for n in OPS_TRACE_NEEDLES if n not in timeline]
    if rc != 0 or missing:
        fail(f"[ops] ftstrace timeline {tx}: rc {rc}, missing {missing}:\n{timeline[-3000:]}")
    sides = [p for p in pids if f"pid={p} " in timeline or f"pid={p}]" in timeline]
    if len(sides) != 2:
        fail(f"[ops] the timeline of {tx} holds the spans of pids {sides} of {list(pids)}")
    with open(os.path.join(work, "trace.json")) as fh:
        events = len(json.load(fh)["traceEvents"])
    if rc_x != 0 or not events:
        fail(f"[ops] ftstrace export: rc {rc_x}, {events} events")
    if rc_m != 0 or "\nphases\n" not in text or " serve " not in text or " warmup " not in text:
        fail("[ops] ftsmetrics show: no heartbeat phases in the node's sidecar")
    return {"timeline_rows": sum(1 for line in timeline.splitlines() if line.startswith("  +")),
            "export_events": events}


def ops_cost_line(cost: dict) -> str:
    """The `[ops]` measurements in this process as one line."""
    progs = "; ".join(f"{p} {v['ms']:.4f} ms ({v['ms_min']:.4f}-{v['ms_max']:.4f}) x "
                      f"{v['dispatches']} at {v['rows']} rows"
                      for p, v in sorted(cost["programs"].items()))
    return (
        f"64-tx 2-in/2-out verify, {len(cost['on_ms'])} runs each, interleaved: ledger on "
        f"median {cost['on_median_ms']:.1f} ms ({min(cost['on_ms']):.1f}-"
        f"{max(cost['on_ms']):.1f}), off {cost['off_median_ms']:.1f} ms "
        f"({min(cost['off_ms']):.1f}-{max(cost['off_ms']):.1f}): "
        f"{100 * cost['cost_frac']:+.1f}%, verdicts equal; each program's device time a "
        f"dispatch by the ledger's events at the block's rows (median of {OPS_PROGRAM_RUNS} "
        f"verifies): {progs}")


def ops_node_line(node: dict) -> str:
    """The `[ops]` checks on the promoted node as one line."""
    return (
        f"the promoted node: ftstop devices (a subprocess) {node['ftstop_devices_s']:.1f} s, "
        f"dispatches over planes {node['planes']} equal to kernel.launches {node['dispatches']}, "
        f"p50 by events (ms) {{{', '.join(f'{k}: {v:.4f}' for k, v in node['p50_ms'].items())}}}"
        f", builds/loads {node['builds']} as warmup's; ftstop top, ftsmetrics show --prometheus "
        f"({node['prometheus_lines']} lines) and diff; ftstrace timeline of a post-failover tx "
        f"over the client's and the node's sidecars, {node['timeline_rows']} rows, export "
        f"{node['export_events']} events; tokengen dlog {node['tokengen_s']:.2f} s, its "
        f"driver's verifier on the card {node['tokengen_verifier_s']:.2f} s; phase "
        f"{node['phase_s']:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261017)
    # a [repl] ledger node: the phase spawns two, as `chip_smoke.py --repl-node ...`
    ap.add_argument("--repl-node", choices=("leader", "follower"), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--repl-work", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--repl-port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--repl-peer", default="-", help=argparse.SUPPRESS)
    ap.add_argument("--repl-block", type=int, default=BLOCK_TXS, help=argparse.SUPPRESS)
    ap.add_argument("--repl-device", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--repl-no-pairing", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.repl_node:
        return repl_node(args.repl_node, args.repl_work, args.repl_port, args.repl_peer,
                         args.repl_device, args.repl_block, not args.repl_no_pairing)

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
    say("build", f"{len(_build.SOURCES)} sources with nvcc sm_90a in {t_build:.1f} s ("
        + ", ".join(f"{src} {sec:.1f} s" for src, sec in sorted(
            _build.BUILD_SECONDS.items(), key=lambda x: -x[1])) + "); " + " | ".join(regs))

    def ptxas_of(source: str, only: str = "") -> str:
        """The stack/spill and register lines of a source's entry points
        (those whose mangled name holds `only`)."""
        lines = _build.BUILD_LOG.get(source, "").splitlines()
        return " | ".join(" ".join(x.split(":", 1)[-1].strip() for x in lines[i + 2:i + 4])
                          for i, ln in enumerate(lines)
                          if "Compiling entry function" in ln and only in ln)

    def built_config(source: str, n: int) -> tuple:
        """The compile-time lane counts (and sizes) of a source's kernel as
        its built library reports them (`fts_<kernel>_config`): what the
        timed kernel was built with."""
        fn = getattr(_build.build_all()[source], f"fts_{source[:-3]}_config")
        fn.restype = ctypes.c_int
        vals = [ctypes.c_int() for _ in range(n)]
        if fn(*(ctypes.byref(v) for v in vals)) != 0:
            fail(f"{source}: its config entry failed")
        return tuple(v.value for v in vals)

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
        # g1_mul: scalars 0, 1, r-1, every digit 15 below the top, an
        # infinite point, some rows redundant
        pts = rand_points(rows, [pool[0], pool[1], pool[2], pool[3], None])
        ks = [rng.randrange(hm.R) for _ in range(rows)]
        ks[:5] = [0, 1, hm.R - 1, LADDER_EDGE_K, 5]
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
    g2p = redundant(torch.from_numpy(cv2.encode_points(
        rand_points(n, [q0, q1, q0, q1, None], pool2))).to(dev), range(4, 9))
    ks = [0, 1, hm.R - 1, LADDER_EDGE_K, 5] + [rng.randrange(hm.R) for _ in range(n - 5)]
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
        f"exactly on infinity operands, P+P, P-P, scalars 0/1/r-1/16^63-1, a (0, 0) leg, GT "
        f"one and values in [p, 2p)")

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

    msm_rows_fn, sub_rows_fn = st.g1_msm_rows, st.g1_sub_rows

    def verify_counted(txs):
        """One verify with every count set to 0 just before it and read
        just after, recording each range kernel's inputs and those of every
        g1_msm and g1_sub call (under "g1_msm" and "g1_sub", lists)."""
        captured.clear()
        msm_calls, sub_calls = [], []

        def msm_capturing(*a):
            msm_calls.append(tuple(x.clone() for x in a))
            return msm_rows_fn(*a)

        def sub_capturing(*a):
            sub_calls.append(tuple(x.clone() for x in a))
            return sub_rows_fn(*a)

        for name in RANGE_KERNELS:
            setattr(st, f"{name}_rows", capturing(name))
        st.g1_msm_rows, st.g1_sub_rows = msm_capturing, sub_capturing
        for k in _build.ALL_KERNELS:
            k.launches = 0
        try:
            t = time.perf_counter()
            got = verifier.verify(txs)
            wall = time.perf_counter() - t
        finally:
            for name, fn in originals.items():
                setattr(st, f"{name}_rows", fn)
            st.g1_msm_rows, st.g1_sub_rows = msm_rows_fn, sub_rows_fn
        counts = {k.name: k.launches for k in _build.ALL_KERNELS}
        if counts != RANGE_LAUNCHES:
            fail(f"a {len(txs)}-tx 2-in/2-out verify launched {counts}, expected {RANGE_LAUNCHES}")
        return got, wall, counts, {**captured, "g1_msm": msm_calls, "g1_sub": sub_calls}

    # every g1_mul and g2_mul call of the block verify and of the block and
    # batch proves, inputs and output, held against the plain versions in
    # the ladder phase
    ladder_calls = {name: [] for name in LADDERS}

    @contextlib.contextmanager
    def recording_ladders(tag):
        saved = {name: getattr(st, f"{name}_rows") for name in LADDERS}

        def recorder(name):
            fn = saved[name]

            def wrapper(*a):
                out = fn(*a)
                ladder_calls[name].append((tag, tuple(x.clone() for x in a), out.clone()))
                return out
            return wrapper

        for name in LADDERS:
            setattr(st, f"{name}_rows", recorder(name))
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(st, f"{name}_rows", fn)

    with recording_ladders("verify"):
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

    # the verify's own g1_msm launches (WF, membership x2, equality x2):
    # each held against its plain version at the block's rows, timed at
    # both sizes beside its bound
    verify_msm = []
    for ab, abig in zip(inputs_block["g1_msm"], inputs_batch["g1_msm"]):
        got = st.g1_msm_rows(*ab)
        want = st.g1_msm_plain(*ab)
        if not torch.equal(got, want):
            fail(f"g1_msm disagrees with its plain version on the verify's inputs "
                 f"({ab[1].shape[0]} x {ab[1].shape[1]}; max |err| {max_abs_err(got, want)})")
        # the batch's rows are copies of the block's: each output row equals
        # the block output of the row with the same scalar words
        index = {bytes(r): i for i, r in enumerate(ab[1].cpu().numpy().reshape(len(got), -1))}
        at = [index.get(bytes(r)) for r in abig[1].cpu().numpy().reshape(abig[1].shape[0], -1)]
        if None in at or not torch.equal(st.g1_msm_rows(*abig),
                                         got[torch.tensor(at, device=got.device)]):
            fail("g1_msm at the batch's rows does not repeat its block output")
        row = {"nbases": ab[1].shape[1], "rows_block": ab[1].shape[0],
               "rows_batch": abig[1].shape[0], "ms_block": timed(lambda: st.g1_msm_rows(*ab), 10),
               "ms_batch": timed(lambda: st.g1_msm_rows(*abig), 10)}
        for size, (table, scal) in (("block", ab), ("batch", abig)):
            nb, ks = scal.shape[1], lb.batch_words_to_ints(scal)
            row[f"bound_{size}"] = bound_ms(
                msm_products(ks[r * nb:(r + 1) * nb] for r in range(scal.shape[0])),
                table.numel() * 4 + scal.shape[0] * (nb * SCALAR_BYTES + POINT_BYTES))[0]
        verify_msm.append(row)
    say("msm", "the 2-in/2-out verify's g1_msm launches, each equal to its plain version on the "
        "block's inputs and repeating it on the batch's; ms at block/batch rows: " + ", ".join(
            f"{v['rows_block']}/{v['rows_batch']} x {v['nbases']} {v['ms_block']:.4f}/"
            f"{v['ms_batch']:.4f} (bound {v['bound_block']:.4f}/{v['bound_batch']:.4f})"
            for v in verify_msm) + "; sum " + "/".join(
            f"{sum(v[f'ms_{z}'] for v in verify_msm):.4f}" for z in ("block", "batch"))
        + f" ms, bound {sum(v['bound_batch'] for v in verify_msm):.4f} ms at batch [{card}]")

    # the verify's own four g1_sub launches (WF, membership, equality) and
    # its g2_add, block and batch: each bit for bit its plain version
    checked = []
    for tag, inputs in (("block", inputs_block), ("batch", inputs_batch)):
        calls = [("g1_sub", a, st.g1_sub_rows, lambda x, y: st.g1_addsub_plain(x, y, True))
                 for a in inputs["g1_sub"]]
        calls.append(("g2_add", inputs["g2_add"], originals["g2_add"], st.g2_add_plain))
        for name, (a, b), fn, plain in calls:
            got, want = fn(a, b), plain(a, b)
            if not torch.equal(got, want):
                fail(f"{name} disagrees with its plain version on the {tag} verify's inputs "
                     f"({a.shape[0]} rows; max |err| {max_abs_err(got, want)})")
            checked.append(f"{name} {a.shape[0]}")
    say("adds", f"the 2-in/2-out verify's g1_sub and g2_add launches, block and batch "
        f"({', '.join(checked)} rows), each equal to its plain version bit for bit [{card}]")

    range_medians = medians("2-in/2-out", zip((rblock, rbatch), VERIFY_REPS["2-in/2-out"]))
    range_spans = wf_spans + ("batch.membership.verify", "batch.membership.parse",
                              "batch.membership.device", "batch.membership.decode",
                              "batch.membership.challenge", "batch.range.parse",
                              "batch.range.device", "batch.range.decode", "batch.range.challenge")
    names = breakdown("2-in/2-out", lambda: verifier.verify(rbatch), _build.PATH_KERNELS,
                      range_spans, f"{len(rbatch)}-tx verify")
    want_names = sorted(n for n, c in RANGE_LAUNCHES.items() for _ in range(c))
    if sorted(names) != want_names:
        fail(f"profiled 2-in/2-out verify launched {sorted(names)}")
    # [ops] here, on the warm verifier: the dispatch ledger's cost and times
    ops_cost = ledger_cost(verifier, rblock)
    if ops_cost["launches"] != {k: v * 2 * OPS_RUNS for k, v in RANGE_LAUNCHES.items()}:
        fail(f"[ops] the ledger's verifies launched {ops_cost['launches']}")
    say("ops", ops_cost_line(ops_cost) + f" [{card}]")

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
        capture = {**prove_capture, "g2_add": "g2_add_rows"}  # g2_add: held below, no row
        captured = {name: [] for name in capture}
        saved = {name: getattr(st, fn) for name, fn in capture.items()}

        def recording(name):
            fn = saved[name]

            def wrapper(*a, **kw):
                captured[name].append(tuple(x.clone() for x in a))
                return fn(*a, **kw)
            return wrapper

        for name, fn in capture.items():
            setattr(st, fn, recording(name))
        for k in _build.ALL_KERNELS:
            k.launches = 0
        try:
            t = time.perf_counter()
            proofs = prove(reqs)
            wall = time.perf_counter() - t
        finally:
            for name, fn in capture.items():
                setattr(st, fn, saved[name])
        counts = {k.name: k.launches for k in _build.ALL_KERNELS}
        if counts != expect:
            fail(f"a {len(reqs)}-tx prove launched {counts}, expected {expect}")
        return proofs, wall, counts, captured

    with recording_ladders("prove block"):
        proofs_block, t_pblock, launches_p, pin_block = prove_counted(preq_block, PROVE_LAUNCHES)
    with recording_ladders("prove batch"):
        proofs_batch, t_pbatch, launches_pb, pin_batch = prove_counted(preq_batch, PROVE_LAUNCHES)
    proofs_wf, t_pwf, launches_pwf, _ = prove_counted(preq_wf, PROVE_WF_LAUNCHES)

    # acceptance: the host verifier on the first PROVE_HOST_SAMPLE proofs of
    # the 2-in/2-out group and every 1-in/1-out one, the batched verifier on
    # the card on all of them
    t_phost = {}
    for key, reqs, proofs in (("2in2out", preq_block[:PROVE_HOST_SAMPLE],
                               proofs_block[:PROVE_HOST_SAMPLE]),
                              ("1in1out", preq_wf, proofs_wf)):
        t = time.perf_counter()
        for (_, _, ins, outs), raw in zip(reqs, proofs):
            try:
                tr.TransferVerifier(ins, outs, pp).verify(raw)
            except Exception as exc:  # noqa: BLE001
                fail(f"the host verifier rejects a proof made on the card: {exc}")
        t_phost[key] = time.perf_counter() - t

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
        f"1-in/1-out {BLOCK_TXS}-tx {t_pwf * 1e3:.1f} ms; the host verifier accepts the first "
        f"{PROVE_HOST_SAMPLE} of the 2-in/2-out group ({t_phost['2in2out']:.1f} s) and all "
        f"{BLOCK_TXS} 1-in/1-out ({t_phost['1in1out']:.1f} s), the batched verifier all "
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
    # the prove's g2_add (the membership commitments' sum), block and batch
    for tag, pin in (("block", pin_block), ("batch", pin_batch)):
        for a, b in pin["g2_add"]:
            got, want = st.g2_add_rows(a, b), st.g2_add_plain(a, b)
            if not torch.equal(got, want):
                fail(f"g2_add disagrees with its plain version on the {tag} prove's inputs "
                     f"({a.shape[0]} rows; max |err| {max_abs_err(got, want)})")
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
        "the 64-tx prove's inputs, g2_add also on the 1,024-tx prove's; g1_msm_select ms on "
        "zero / random scalars, gather beside it: "
        + ", ".join(f"{v['rows']} rows select {v['select_zero']:.3f} / {v['select_random']:.3f}, "
                    f"gather {v['gather_zero']:.3f} / {v['gather_random']:.3f}"
                    for v in zero_random.values()) + f" [{card}]")

    # ---------------------------------------------------------------- ladder
    # g1_mul and g2_mul (the window ladder, TPI lanes a row): every call of
    # the block verify and of both proves against the plain version in
    # one plain call a kernel; each kernel's ptxas line, its times at the
    # path's rows beside the bound, and its share of that bound
    ladder = {}
    for name in LADDERS:
        calls = ladder_calls[name]
        pts = torch.cat([a[0] for _, a, _ in calls])
        ks = torch.cat([a[1] for _, a, _ in calls])
        got = torch.cat([o for _, _, o in calls])
        want, p_ms = plain_timed(lambda: getattr(st, f"{name}_plain")(pts, ks))
        if not torch.equal(got, want):
            fail(f"{name} disagrees with its plain version on the verify's and prove's inputs "
                 f"(max |err| {max_abs_err(got, want)})")
        prove_args = [a for tag, a, _ in calls if tag == "prove batch"][0]
        fin = finite(prove_args[0])
        ks_p = lb.batch_words_to_ints(prove_args[1])
        if name == "g1_mul":
            rows_b, rows_B = BLOCK_TXS * ROWS_PER_TX, BATCH_TXS * ROWS_PER_TX
            ms_b, ms_B = stats[name][rows_b][0], stats[name][rows_B][0]
            bound_b, bound_B = stats[name][rows_b][3][0], stats[name][rows_B][3][0]
            prove_bound = bound_ms(mul_products(fin, ks_p), prove_args[1].shape[0]
                                   * (2 * POINT_BYTES + SCALAR_BYTES))
        else:
            v = range_stats[name]
            rows_b, rows_B, ms_b, ms_B = v["rows_block"], v["rows_batch"], v["ms_block"], v["ms_batch"]
            bound_b, bound_B = v["bound_block"][0], v["bound_batch"][0]
            prove_bound = bound_ms(mul_products(fin, ks_p, G2_MULS_WINDOW_TABLE, G2_MULS_DOUBLE,
                                                G2_MULS_ADD), prove_args[1].shape[0]
                                   * (2 * G2_BYTES + SCALAR_BYTES))
        fn = getattr(st, f"{name}_rows")
        ladder[name] = {
            "tpi": built_config(f"{name}.cu", 1)[0], "ptxas": ptxas_of(f"{name}.cu"),
            "calls_checked": len(calls), "rows_checked": pts.shape[0], "plain_ms": p_ms,
            "rows_block": rows_b, "rows_batch": rows_B, "ms_block": ms_b, "ms_batch": ms_B,
            "bound_block": bound_b, "bound_batch": bound_B,
            "share_block": bound_b / ms_b, "share_batch": bound_B / ms_B,
            "prove_rows": prove_args[1].shape[0], "prove_ms": timed(lambda: fn(*prove_args), 5),
            "prove_bound": prove_bound[0],
        }
    say("ladder", "; ".join(
        f"{name} (TPI {v['tpi']}; ptxas {v['ptxas']}): {v['rows_block']}/{v['rows_batch']} rows "
        f"{v['ms_block']:.4f}/{v['ms_batch']:.4f} ms, bound {v['bound_block']:.4f}/"
        f"{v['bound_batch']:.4f} ms, {100 * v['share_block']:.2f}%/{100 * v['share_batch']:.2f}% "
        f"of bound; the 1,024-tx prove's {v['prove_rows']} rows {v['prove_ms']:.4f} ms (bound "
        f"{v['prove_bound']:.4f}); {v['calls_checked']} calls of the 64-tx verify and the "
        f"proves ({v['rows_checked']} rows) equal the plain version exactly "
        f"(plain {v['plain_ms']:.0f} ms)" for name, v in ladder.items()) + f" [{card}]")

    # secret scalars: the kernels that take them on the prove path, timed
    # on all-zero, all-0xF (every 4-bit digit 15, words as given) and
    # random scalars at the 1,024-tx prove's rows, in turns in one phase;
    # the spread is (max - min) / min over the three
    secret = {}
    wf_table, wf_scal = pin_batch["g1_msm_select"][0]
    for name, fn, args_ in (
            ("g1_mul", st.g1_mul_rows, [a for tag, a, _ in ladder_calls["g1_mul"]
                                        if tag == "prove batch"][0]),
            ("g2_mul", st.g2_mul_rows, [a for tag, a, _ in ladder_calls["g2_mul"]
                                        if tag == "prove batch"][0]),
            ("g1_msm_select", st.g1_msm_select_rows, (wf_table, wf_scal))):
        pts, scal = args_
        kinds = {"zero": torch.zeros_like(scal), "0xF": torch.full_like(scal, -1), "random": scal}
        ms = {kind: timed(lambda: fn(pts, k), 5) for kind, k in kinds.items()}
        secret[name] = {"rows": scal.shape[0], **ms,
                        "spread": (max(ms.values()) - min(ms.values())) / min(ms.values())}
    # the to-affine kernels invert Z (on the prove path g2_to_affine's Z
    # derives from secrets): each launched directly (its wrapper's host cost
    # a call is of the kernel's own order) on Z words 1 and p - 1 (a G2 Z of
    # (w, 0)) and on the verify's own Z at the 1,024-tx verify's rows, in
    # AFFINE_ROUNDS rounds of one turn a kind in a shuffled order (seeded);
    # a kind's time is the mean of its turns, `repeat` the largest gap
    # between two turns of one kind, `slowest` the rounds each kind was
    # the slowest in (a third each if the kinds do not differ)
    order = random.Random(args.seed)

    def shuffled_turns(name, rows, kinds, launch):
        """`launch(kind)` timed (100 launches a turn) in AFFINE_ROUNDS rounds
        of one turn a kind in a shuffled order, into secret[name]."""
        turns = {label: [] for label in kinds}
        slowest = {label: 0 for label in kinds}
        for _ in range(AFFINE_ROUNDS):
            labels = list(kinds)
            order.shuffle(labels)
            this_round = {}
            for label in labels:
                this_round[label] = timed(lambda: launch(label), 100)
                turns[label].append(this_round[label])
            slowest[max(this_round, key=this_round.get)] += 1
        ms = {label: sum(t) / len(t) for label, t in turns.items()}
        secret[name] = {"rows": rows, **ms,
                        "spread": (max(ms.values()) - min(ms.values())) / min(ms.values()),
                        "repeat": max((max(t) - min(t)) / min(t) for t in turns.values()),
                        "slowest": slowest}

    for name in ("g1_to_affine", "g2_to_affine"):
        (pts,) = inputs_batch[name]
        kinds = {}
        for label, word in (("Z = 1", 1), ("Z = p-1", P - 1)):
            z = pts.clone()
            w = torch.from_numpy(lb.int_to_words(word)).to(dev)
            if name == "g1_to_affine":
                z[:, 2] = w
            else:
                z[:, 2, 0], z[:, 2, 1] = w, 0
            kinds[label] = z
        kinds["random"] = pts
        kern = kernels_by_name[name]
        out = torch.empty((pts.shape[0], 2) + tuple(pts.shape[2:]), dtype=torch.int32, device=dev)
        shuffled_turns(name, pts.shape[0], kinds, lambda label: kern.launch(
            dev, kinds[label].data_ptr(), out.data_ptr(), pts.shape[0]))
    # the prove's adds (g1_add: S^r + P^sig_bf, g2_add: the membership
    # commitments' sum) launched directly at the 1,024-tx prove's rows on
    # its own operands, on P + P, on P + (-P) and with Q at infinity, in
    # the same shuffled rounds
    def negated(points):
        """The same points with Y negated (G1 (n, 3, 8), G2 (n, 3, 2, 8))."""
        out = points.clone()
        ys = lb.batch_words_to_ints(points[:, 1])
        out[:, 1] = torch.from_numpy(lb.ints_to_words([(P - y % P) % P for y in ys])).reshape(
            points[:, 1].shape).to(dev)
        return out

    for name, kern, extra in (("g1_add", kernels_by_name["g1_addsub"], (0,)),
                              ("g2_add", kernels_by_name["g2_add"], ())):
        a, b = pin_batch[name][0]
        kinds = {"random": (a, b), "P+P": (a, a), "P+(-P)": (a, negated(a)),
                 "Q at infinity": (a, torch.zeros_like(b))}
        out = torch.empty_like(a)
        shuffled_turns(name, a.shape[0], kinds, lambda label: kern.launch(
            dev, kinds[label][0].data_ptr(), kinds[label][1].data_ptr(), out.data_ptr(),
            a.shape[0], *extra))
    say("secret-scalars", "; ".join(
        f"{name} {v['rows']} rows: " + ", ".join(
            f"{k} {t:.4f}" for k, t in v.items() if k not in ("rows", "spread", "repeat", "slowest"))
        + f" ms, spread {100 * v['spread']:.2f}%"
        + (f" (two turns of one kind up to {100 * v['repeat']:.2f}% apart; slowest in "
           + ", ".join(f"{k} {c}" for k, c in v["slowest"].items())
           + f" of {AFFINE_ROUNDS} rounds)" if "repeat" in v else "")
        for name, v in secret.items()) + f" [{card}]")

    # the kernels redesigned for the H100: lanes, ptxas, times beside the bound
    v_sel, v_fe = prove_stats["g1_msm_select"][0], range_stats["final_exp"]
    small, big = BLOCK_TXS * ROWS_PER_TX, BATCH_TXS * ROWS_PER_TX
    (msm_s,), (fe_g, fe_smem) = built_config("g1_msm.cu", 1), built_config("final_exp.cu", 2)
    (mil_g, mil_smem), (gtp_g, gtp_smem) = (built_config("miller.cu", 2),
                                            built_config("gt_product.cu", 2))
    v_mil, v_k4, v_k2 = (range_stats["miller"], range_stats["gt_product"],
                         prove_stats["gt_product_k2"][0])

    def occupancy(source: str) -> int:
        """Blocks of a source's kernel an SM holds at once, as the card
        counts them (`fts_<kernel>_occupancy`)."""
        fn = getattr(_build.build_all()[source], f"fts_{source[:-3]}_occupancy")
        fn.restype = ctypes.c_int
        blocks = ctypes.c_int()
        if fn(ctypes.byref(blocks)) != 0:
            fail(f"{source}: its occupancy entry failed")
        return blocks.value

    redesign = {
        "g1_msm": {
            "lanes": f"S {msm_s}",
            "ptxas": ptxas_of("g1_msm.cu", "ILb0E"),  # SELECT = false
            "rows": f"{small}/{big} x 3",
            "ms": (stats["g1_msm"][small][0], stats["g1_msm"][big][0]),
            "bound": (stats["g1_msm"][small][3][0], stats["g1_msm"][big][3][0])},
        "g1_msm_select": {
            "lanes": f"S {msm_s}",
            "ptxas": ptxas_of("g1_msm.cu", "ILb1E"),  # SELECT = true
            "rows": f"{v_sel['rows_block']}/{v_sel['rows_batch']} x {v_sel['nbases']}",
            "ms": (v_sel["ms_block"], v_sel["ms_batch"]),
            "bound": (v_sel["bound_block"][0], v_sel["bound_batch"][0])},
        "final_exp": {
            "lanes": f"G {fe_g}, {fe_smem} B dynamic shared memory a block",
            "ptxas": ptxas_of("final_exp.cu"),
            "rows": f"{v_fe['rows_block']}/{v_fe['rows_batch']}",
            "ms": (v_fe["ms_block"], v_fe["ms_batch"]),
            "bound": (v_fe["bound_block"][0], v_fe["bound_batch"][0])},
        "miller": {
            "lanes": f"G {mil_g}, {mil_smem} B dynamic shared memory a block, "
                     f"{occupancy('miller.cu')} blocks an SM",
            "ptxas": ptxas_of("miller.cu"),
            "rows": f"{v_mil['rows_block']}/{v_mil['rows_batch']}",
            "ms": (v_mil["ms_block"], v_mil["ms_batch"]),
            "bound": (v_mil["bound_block"][0], v_mil["bound_batch"][0])},
        "gt_product": {
            "lanes": f"G {gtp_g}, {gtp_smem} B dynamic shared memory a block, "
                     f"{occupancy('gt_product.cu')} blocks an SM",
            "ptxas": ptxas_of("gt_product.cu"),
            "rows": f"K = 4 {v_k4['rows_block']}/{v_k4['rows_batch']}",
            "ms": (v_k4["ms_block"], v_k4["ms_batch"]),
            "bound": (v_k4["bound_block"][0], v_k4["bound_batch"][0])},
        "gt_product_k2": {
            "lanes": f"G {gtp_g}",
            "ptxas": ptxas_of("gt_product.cu"),
            "rows": f"K = 2 {v_k2['rows_block']}/{v_k2['rows_batch']}",
            "ms": (v_k2["ms_block"], v_k2["ms_batch"]),
            "bound": (v_k2["bound_block"][0], v_k2["bound_batch"][0])},
    }
    # the to-affine kernels over csrc/bn254_inv.cuh, beside an empty launch
    # on the same grid (csrc/probe_empty.cu; their bound lies below a
    # launch's cost)
    empty = _build.build_probe("probe_empty.cu").fts_empty_launch
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    empty.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream  # the one `timed` records on
    for name in ("g1_to_affine", "g2_to_affine"):
        v = range_stats[name]
        floor = [timed(lambda: empty(-(-rows // 32), 32, stream), 50)
                 for rows in (v["rows_block"], v["rows_batch"])]
        redesign[name] = {
            "lanes": f"safegcd, a row a lane, {occupancy(f'{name}.cu')} blocks an SM, "
                     f"empty launch {floor[0]:.4f}/{floor[1]:.4f} ms",
            "ptxas": ptxas_of(f"{name}.cu"),
            "rows": f"{v['rows_block']}/{v['rows_batch']}",
            "ms": (v["ms_block"], v["ms_batch"]),
            "bound": (v["bound_block"][0], v["bound_batch"][0])}
    # the adds: g1_addsub (each element split over TPI lanes) and g2_add
    # (the formula's base products split over G lanes), on the verify's
    # own inputs (its first g1_sub, the WF's, and its g2_add) through the
    # wrapper and by direct launches, beside an empty launch on the same
    # grid
    (add_tpi, add_threads), (add_g, add2_threads, add2_smem) = (
        built_config("g1_addsub.cu", 2), built_config("g2_add.cu", 3))
    for name, lanes, threads, what, wrapper, extra in (
            ("g1_addsub", add_tpi, add_threads, f"TPI {add_tpi}, each element split",
             st.g1_sub_rows, (1,)),
            ("g2_add", add_g, add2_threads, f"G {add_g}, the base products split, {add2_smem} B "
             "dynamic shared memory a block", st.g2_add_rows, ())):
        kern, arg = kernels_by_name[name], "g1_sub" if name == "g1_addsub" else name
        calls = [inputs_block[arg][0] if arg == "g1_sub" else inputs_block[arg],
                 inputs_batch[arg][0] if arg == "g1_sub" else inputs_batch[arg]]
        ms, direct, floor, bound = [], [], [], []
        for a, b in calls:
            out, n_rows = torch.empty_like(a), a.shape[0]
            ms.append(timed(lambda: wrapper(a, b), 200))
            direct.append(timed(lambda: kern.launch(
                dev, a.data_ptr(), b.data_ptr(), out.data_ptr(), n_rows, *extra), 200))
            blocks = -(-n_rows * lanes // threads)
            floor.append(timed(lambda: empty(blocks, threads, stream), 200))
            fin = sum(1 for x, y in zip(finite(a), finite(b)) if x and y)
            bound.append(bound_ms(fin * (FP_MULS_ADD if name == "g1_addsub" else G2_MULS_ADD),
                                  n_rows * 3 * (POINT_BYTES if name == "g1_addsub" else G2_BYTES))[0])
        redesign[name] = {
            "lanes": f"{what}, {threads} threads a block, {occupancy(f'{name}.cu')} blocks an SM, "
                     f"direct launches {direct[0]:.4f}/{direct[1]:.4f} ms, empty launch "
                     f"{floor[0]:.4f}/{floor[1]:.4f} ms",
            "ptxas": ptxas_of(f"{name}.cu"),
            "rows": f"{calls[0][0].shape[0]}/{calls[1][0].shape[0]}",
            "ms": tuple(ms), "bound": tuple(bound), "direct_ms": tuple(direct),
            "empty_ms": tuple(floor)}
    for v in redesign.values():
        v["share"] = tuple(b / m for b, m in zip(v["bound"], v["ms"]))
    say("redesign", "; ".join(
        f"{name} ({v['lanes']}; ptxas {v['ptxas']}): {v['rows']} rows {v['ms'][0]:.4f}/"
        f"{v['ms'][1]:.4f} ms, bound {v['bound'][0]:.4f}/{v['bound'][1]:.4f} ms, "
        f"{100 * v['share'][0]:.2f}%/{100 * v['share'][1]:.2f}% of bound"
        for name, v in redesign.items()) + f" [{card}]")

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
    g2_add_fn, ps_adds = st.g2_add_rows, []

    def g2_add_capturing(*a):
        ps_adds.append(tuple(x.clone() for x in a))
        return g2_add_fn(*a)

    for k in _build.ALL_KERNELS:
        k.launches = 0
    st.g2_add_rows = g2_add_capturing
    try:
        t = time.perf_counter()
        ps_got = ps_verifier.verify(ps_msgs, ps_sigs)
        t_ps = time.perf_counter() - t
    finally:
        st.g2_add_rows = g2_add_fn
    launches_ps = {k.name: k.launches for k in _build.ALL_KERNELS}
    if launches_ps != PS_LAUNCHES:
        fail(f"a PS verify launched {launches_ps}, expected {PS_LAUNCHES}")
    if ps_got.tolist() != ps_host:
        fail(f"BatchedPSVerifier verdicts differ from the host's: {ps_got.tolist()}")
    for a, b in ps_adds:  # the public key's tree sum and + pk[0]
        got, want = st.g2_add_rows(a, b), st.g2_add_plain(a, b)
        if not torch.equal(got, want):
            fail(f"g2_add disagrees with its plain version on the PS verify's inputs "
                 f"({a.shape[0]} rows; max |err| {max_abs_err(got, want)})")
    ps_medians = medians("PS", [(ps_sigs, PROVE_REPS[0])],
                         run=lambda sigs: ps_verifier.verify(ps_msgs, sigs), unit="sig")
    say("ps", f"{PS_SIGS} signatures (the signed set, randomised; planted rows {ps_bad}: a "
        f"wrong message, R and S swapped, another value's signature, a wrong message count, "
        f"no signature): verdicts equal the host's; its {len(ps_adds)} g2_add launches equal the "
        f"plain version bit for bit; first verify {t_ps * 1e3:.1f} ms; launches "
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

    def fused_config(k: int) -> tuple:
        """pairing_fused.cu as built, for K legs a row
        (`fts_pairing_fused_config`): GM, GF, then the rows and
        dynamic shared memory a warp of each mode, then the warps of each
        an SM holds (`fts_pairing_fused_occupancy`)."""
        lib = _build.build_all()["pairing_fused.cu"]
        vals, blocks = (ctypes.c_int * 6)(), (ctypes.c_int * 2)()
        if lib.fts_pairing_fused_config(k, vals) != 0 or \
                lib.fts_pairing_fused_occupancy(k, blocks) != 0:
            fail("pairing_fused.cu: its config or occupancy entry failed")
        return tuple(vals) + tuple(blocks)

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
        cfg = fused_config(k)
        for size, (PP, QQ, ff) in (("block", (sP, sQ, fb)), ("batch", (sPb, sQb, fbig))):
            b = PP.shape[0]
            row[f"ms_{size}"] = timed(lambda: st.pairing_product_rows(PP, QQ), 3)
            row[f"tail_ms_{size}"] = timed(lambda: st.gt_product_final_exp_rows(ff), 3)
            # by direct launches (no wrapper), beside an empty launch on the grid
            out_d = torch.empty((b,) + tuple(ff.shape[2:]), dtype=torch.int32, device=dev)
            row[f"direct_ms_{size}"] = timed(lambda: kernels_by_name["pairing_product"].launch(
                dev, PP.data_ptr(), QQ.data_ptr(), None, out_d.data_ptr(), b, k), 3)
            row[f"tail_direct_ms_{size}"] = timed(
                lambda: kernels_by_name["gt_product_final_exp"].launch(
                    dev, ff.data_ptr(), out_d.data_ptr(), b, k), 3)
            grid = (ctypes.c_int * 2)()
            if _build.build_all()["pairing_fused.cu"].fts_pairing_product_grid(b, k, grid) != 0:
                fail("pairing_fused.cu: its grid entry failed")
            row[f"empty_ms_{size}"] = timed(lambda: empty(grid[0], grid[1], stream), 50)
            row[f"grid_{size}"] = tuple(grid)
            row[f"tail_empty_ms_{size}"] = timed(lambda: empty(-(-b // cfg[4]), 32, stream), 50)
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

    ptxas = {}
    lines = _build.BUILD_LOG.get("pairing_fused.cu", "").splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln:
            entry = "pairing_product" if "pairing_product_kernel" in ln else "gt_product_final_exp"
            ptxas[entry] = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 2:i + 4])
    for v in mesh_stats.values():
        c = fused_config(v["k"])
        v["lanes"] = (f"GM {c[0]}, GF {c[1]}, legs side by side, {c[2]} rows and {c[3]} B "
                      f"dynamic shared memory a warp, {c[6]} warps an SM; grid "
                      f"{v['grid_block'][0]} x {v['grid_block'][1]} / "
                      f"{v['grid_batch'][0]} x {v['grid_batch'][1]} threads")
        v["tail_lanes"] = (f"GF {c[1]}, one warp a block, {c[4]} rows, {c[5]} B dynamic shared "
                           f"memory, {c[7]} blocks an SM")
        for prefix in ("", "tail_"):
            v[f"{prefix}share"] = tuple(v[f"{prefix}bound_{size}"][0] / v[f"{prefix}ms_{size}"]
                                        for size in ("block", "batch"))
    say("redesign", "; ".join(
        f"{name} {tag} {v['rows_block']}/{v['rows_batch']} x K={v['k']} ({v[pre + 'lanes']}; "
        f"ptxas {ptxas.get(name)}): {v[pre + 'ms_block']:.4f}/{v[pre + 'ms_batch']:.4f} ms "
        f"through the wrapper, direct launches {v[pre + 'direct_ms_block']:.4f}/"
        f"{v[pre + 'direct_ms_batch']:.4f}, empty launch {v[pre + 'empty_ms_block']:.4f}/"
        f"{v[pre + 'empty_ms_batch']:.4f}, bound {v[pre + 'bound_block'][0]:.4f}/"
        f"{v[pre + 'bound_batch'][0]:.4f}, {100 * v[pre + 'share'][0]:.2f}%/"
        f"{100 * v[pre + 'share'][1]:.2f}% of bound"
        for name, pre in (("pairing_product", ""), ("gt_product_final_exp", "tail_"))
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
    # the staged run, with its result file, is [mesh-block]'s
    rc = multichip_torch.main(["--logical", "--devices", "4", "--mp", "2", "--fused"])
    if rc != 0:
        fail(f"multichip_torch.py --logical --devices 4 --mp 2 --fused exited {rc}")
    say("mesh", f"stage 2: {PS_SIGS} PS rows through sharded_pairing_product(fused=True): valid "
        f"rows accepted and planted rows {ps_bad} rejected on the (2, 2) and the (1, 1) mesh, "
        f"GT values equal the staged path's; launches {fused_launches}; multichip_torch.py "
        f"--logical --devices 4 --mp 2 --fused passes stages 0-3 [{card}]")

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

    # ---------------------------------------------------------------- drivers
    drivers_ms, drivers_ctx = drivers_phase(pp, rng, verifier, PROVE_LAUNCHES, RANGE_LAUNCHES)
    say("drivers", drivers_line(drivers_ms, BLOCK_TXS, BATCH_TXS) + f"; launches a "
        f"transfer_many {PROVE_LAUNCHES}, a batch_verifier().verify {RANGE_LAUNCHES}, a "
        f"validation none [{card}]")

    # ---------------------------------------------------------------- ledger
    ledger_ms = ledger_phase(pp, drivers_ctx, RANGE_LAUNCHES, SIGN_LAUNCHES)
    say("ledger", ledger_line(ledger_ms, BLOCK_TXS, BATCH_TXS) + f"; launches: issue block "
        f"{SIGN_LAUNCHES}, transfer block {RANGE_LAUNCHES}, each backlog block the same "
        f"[{card}]")

    # ---------------------------------------------------------------- mesh-block
    mesh_ms = mesh_block_phase(pp, drivers_ctx, rblock, rbatch, host_r * RANGE_COPIES, preq_batch,
                               args.seed + 17, RANGE_LAUNCHES, PROVE_LAUNCHES)
    say("mesh-block", mesh_block_line(mesh_ms) + f" [{card}]")
    # what the cuts of [drivers] and [ledger] saved for it, at this run's rates
    dms, lms = drivers_ms, ledger_ms
    saved = {
        "drivers_block_host": dms["block_validate_host"] / dms["block_host_sample"]
        * (BLOCK_TXS - dms["block_host_sample"]),
        "drivers_backlog_host": dms["backlog_validate_host"] / dms["backlog_host_sample"]
        * (BLOCK_TXS + 5 - dms["backlog_host_sample"]),
        "ledger_sequential": lms["backlog_sequential"] / lms["backlog_sequential_blocks"]
        * (lms["blocks_backlog"] - lms["backlog_sequential_blocks"]),
        "prove_host": t_phost["2in2out"] * 1e3 / PROVE_HOST_SAMPLE
        * (BLOCK_TXS - PROVE_HOST_SAMPLE),
    }
    mesh_ms["cuts_saved_ms"] = saved
    say("cuts", f"[mesh-block] took {mesh_ms['phase'] / 1e3:.1f} s; the depth cut from "
        f"earlier phases saved about {sum(saved.values()) / 1e3:.1f} s at this run's rates: "
        f"[drivers] host validation of the block on {dms['block_host_sample']} of "
        f"{BLOCK_TXS} requests {saved['drivers_block_host'] / 1e3:.1f} s, of the backlog on "
        f"{dms['backlog_host_sample']} of {BLOCK_TXS + 5} {saved['drivers_backlog_host'] / 1e3:.1f}"
        f" s, [ledger]'s sequential backlog over {lms['backlog_sequential_blocks']} of "
        f"{lms['blocks_backlog']} blocks {saved['ledger_sequential'] / 1e3:.1f} s, [prove]'s "
        f"host acceptance of the 2-in/2-out group on {PROVE_HOST_SAMPLE} of {BLOCK_TXS} "
        f"proofs {saved['prove_host'] / 1e3:.1f} s")

    # ---------------------------------------------------------------- ttx
    ttx_ms = ttx_phase(pp, args.seed + 13, PROVE_LAUNCHES, TTX_BLOCK_LAUNCHES, SIGN_LAUNCHES)
    say("ttx", ttx_line(ttx_ms) + f"; launches: issue block {SIGN_LAUNCHES}, transfer block and "
        f"each backlog block {TTX_BLOCK_LAUNCHES}, each transfer_many {PROVE_LAUNCHES} [{card}]")
    # this process's dispatch ledger so far: the frames whose event pair shared
    # its stream with another thread's ([ledger]'s and [ttx]'s pipelined engines)
    from fabric_token_sdk_tpu_torch.utils import devobs
    dsec = devobs.section()
    overlap = {"dispatches": dsec["dispatches"], "overlapped": dsec["dispatch_overlapped"],
               "by_program": {f"{pl}:{pg}": e["overlapped"]
                              for (pl, pg), e in sorted(devobs.snapshot().items())
                              if e["overlapped"]}}
    say("overlap", f"this process's dispatch ledger after [ttx]: {overlap['dispatches']} "
        f"dispatches, {overlap['overlapped']} of them with an event pair open on a stream while "
        f"another thread's was ({overlap['by_program']}); dispatch p50 "
        f"{dsec['dispatch_p50_s']} s [{card}]")

    # ---------------------------------------------------------------- repl
    repl_ms = repl_phase(pp, drivers_ctx, RANGE_LAUNCHES, SIGN_LAUNCHES)
    say("repl", repl_line(repl_ms) + f"; planned: each issue block {SIGN_LAUNCHES}, each "
        f"transfer block {RANGE_LAUNCHES} [{card}]")
    say("ops", ops_node_line(repl_ms["ops"]) + f" [{card}]")

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
        if k.name in ladder:
            kernels[-1].update({x: ladder[k.name][x] for x in ("tpi", "ptxas", "share_batch")})
        if k.name in redesign:
            v = redesign[k.name]
            kernels[-1].update({"lanes": v["lanes"], "ptxas": v["ptxas"], "share_batch": v["share"][1]})
            if k.name == "g1_msm":
                kernels[-1]["verify_launches"] = verify_msm
            if "direct_ms" in v:
                kernels[-1].update({"redesign_rows": v["rows"], "redesign_ms": v["ms"],
                                    "direct_ms": v["direct_ms"], "empty_ms": v["empty_ms"]})
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
        if name in ladder:
            kernels[-1].update({x: ladder[name][x] for x in ("tpi", "ptxas", "share_batch")})
        if name in redesign:
            v = redesign[name]
            kernels[-1].update({"lanes": v["lanes"], "ptxas": v["ptxas"], "share_batch": v["share"][1]})
            if "direct_ms" in v:
                kernels[-1].update({"direct_ms": v["direct_ms"], "empty_ms": v["empty_ms"]})
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
            row["secret_scalars_ms"] = secret
        if kernel_of[name] in ("g1_addsub",):  # the add: the kernel's redesign figures
            v = redesign[kernel_of[name]]
            row.update({"lanes": v["lanes"], "ptxas": v["ptxas"]})
        elif name in redesign:
            v = redesign[name]
            row.update({"lanes": v["lanes"], "ptxas": v["ptxas"], "share_batch": v["share"][1]})
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
            "ptxas": ptxas.get(name), "lanes": v[f"{prefix}lanes"],
            "direct_ms": [v[f"{prefix}direct_ms_block"], v[f"{prefix}direct_ms_batch"]],
            "empty_ms": [v[f"{prefix}empty_ms_block"], v[f"{prefix}empty_ms_batch"]],
            "share_batch": v[f"{prefix}share"][1],
            "ps_direct_ms": [vp[f"{prefix}direct_ms_block"], vp[f"{prefix}direct_ms_batch"]],
        })
    # the ledger and ttx phases' launches, for the rows that are one kernel each
    for row in kernels:
        if row["name"] in ledger_ms["launches"]["transfer_block"]:
            for key, counts in ledger_ms["launches"].items():
                row[f"launches_ledger_{key}"] = counts[row["name"]]
            for key in ("issue_block", "transfer_block", "backlog_pipelined",
                        "backlog_sequential_group0", "backlog_sequential_block0"):
                row[f"launches_ttx_{key}"] = ttx_ms["launches"][key][row["name"]]
            for node, counts in repl_ms["launches"].items():
                row[f"launches_repl_{node}"] = counts[row["name"]]
            row["launches_ops_verify"] = ops_cost["launches"][row["name"]]
            row["launches_ops_node"] = repl_ms["ops"]["dispatches"].get(row["name"], 0)
        kernel = {"g1_add": "g1_addsub", "gt_product_k2": "gt_product"}.get(row["name"],
                                                                             row["name"])
        for key, counts in mesh_ms["launches"].items():
            row[f"launches_mesh_block_{key}"] = counts.get(kernel, 0)
            row[f"ms_mesh_block_{key}"] = mesh_ms[f"{key}_kernel_ms"].get(kernel, 0.0)
        if row["name"] in ops_cost["programs"]:
            v = ops_cost["programs"][row["name"]]
            row.update(ledger_ms_block=v["ms"], ledger_rows_block=v["rows"])
    print(json.dumps({
        "range_verify_median_ms": {str(k): v * 1e3 for k, v in range_medians.items()},
        "prove_median_ms": {str(k): v * 1e3 for k, v in prove_medians.items()},
        "prove_1in1out_median_ms": {str(k): v * 1e3 for k, v in prove_medians_wf.items()},
        "ps_verify_median_ms": {str(k): v * 1e3 for k, v in ps_medians.items()},
        "schnorr_verify_median_ms": {str(k): v * 1e3 for k, v in sign_medians.items()},
        "drivers_ms": drivers_ms,
        "ledger_ms": {k: v for k, v in ledger_ms.items() if k != "launches"},
        "ttx_ms": {k: v for k, v in ttx_ms.items() if k != "launches"},
        "repl_ms": {k: v for k, v in repl_ms.items() if k not in ("launches", "ops")},
        "mesh_block_ms": {k: v for k, v in mesh_ms.items() if k != "launches"},
        "overlap": overlap,
        "ops": {"cost": {k: v for k, v in ops_cost.items() if k != "launches"},
                "node": repl_ms["ops"]},
        "build_s": t_build}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
