"""Batched verification of zkatdlog transfer proofs on the GPU.

Counterpart of `fabric_token_sdk_tpu/crypto/batch.py`. Whole blocks of
transactions verify through the row stages of `ops/stages.py`, each one
launch over all flat rows: host code parses proofs and lays out scalars
and statements, the card recomputes every Schnorr commitment, and host
code re-derives the Fiat-Shamir challenges.

This slice ports the 1-in/1-out transfer (the reference's ownership
transfer, which carries no range proof, `transfer.go:55-59`): its
verification is the well-formedness proof alone, three kernels in all
(`g1_msm`, `g1_mul`, `g1_addsub`). Other shapes need the range-proof
path (G2, the pairing) and raise `NotImplementedError` naming the
ROADMAP item; they are never verified silently on the host.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import hostmath as hm
from .setup import PublicParams
from .transfer import TransferProof
from .wellformedness import TransferWF, challenge_transfer_wf
from ..ops import curve as cv, limbs as lb, stages as st
from ..utils import metrics as mx

RANGE_PATH_ITEM = (
    "ROADMAP.md A4/B7-B13: the range-proof path (G2, pairing) of the "
    "PyTorch port is not ported yet; only 1-in/1-out transfers verify"
)


def resolve_device(device=None) -> torch.device:
    """None means the card. A CUDA device without CUDA raises: the port
    never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain torch versions"
        )
    return dev


def _spanned(name):
    """Wrap a verify method in a metrics span (no-op when disabled)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with mx.span(name):
                return fn(*args, **kw)

        return wrapper

    return deco


class BatchedWFVerifier:
    """Recomputes all Schnorr commitments of B same-shape transfer WF
    proofs through the row stages, then re-derives challenges on host."""

    def __init__(self, pp: PublicParams, device=None):
        self.pp = pp
        self.device = resolve_device(device)
        self.table = cv.FixedBaseTable(pp.ped_params).to(self.device)

    @_spanned("batch.wf.verify")
    def verify(self, txs: Sequence[Tuple[list, list, bytes]]) -> np.ndarray:
        """txs: (inputs, outputs, wf_bytes) with uniform shapes.
        Returns bool array (B,)."""
        B = len(txs)
        if B == 0:
            return np.zeros(0, dtype=bool)
        mx.counter("batch.wf.txs").inc(B)
        n_in = len(txs[0][0])
        n_out = len(txs[0][1])
        n = n_in + n_out + 2  # + the two aggregate statements
        with mx.span("batch.wf.parse"):
            proofs, stmts, resp, chals = self._layout(txs, n_in, n_out)
        dev = self.device
        with mx.span("batch.wf.encode"):
            stmt_t = torch.from_numpy(cv.encode_points(stmts)).to(dev)
            resp_t = torch.from_numpy(cv.encode_scalars(resp).reshape(B * n, 3, lb.NWORDS)).to(dev)
            chal_t = torch.from_numpy(np.repeat(cv.encode_scalars(chals), n, axis=0)).to(dev)
        # com_j = prod ped_i^{resp_ji} - stmt_j^challenge over B*n flat rows;
        # the span ends when the result is back on the host
        with mx.span("batch.wf.device", rows=B * n):
            fixed = self.table(resp_t)
            sc = st.g1_mul_rows(stmt_t, chal_t)
            coms = st.g1_sub_rows(fixed, sc).cpu().numpy()
        with mx.span("batch.wf.decode"):
            com_pts = cv.decode_points(coms)  # B*n host points
        out = np.zeros(B, dtype=bool)
        with mx.span("batch.wf.challenge"):
            for i, ((inputs, outputs, _), wf) in enumerate(zip(txs, proofs)):
                if wf is None:
                    continue
                row = com_pts[i * n : (i + 1) * n]
                in_coms = row[: n_in + 1]
                out_coms = row[n_in + 1 :]
                chal = challenge_transfer_wf(
                    in_coms[:-1], in_coms[-1], out_coms[:-1], out_coms[-1], inputs, outputs
                )
                out[i] = chal == wf.challenge
        return out

    @staticmethod
    def _layout(txs, n_in: int, n_out: int):
        """Parse the WF proofs and lay out, row by row, the statements, the
        response scalars (3 a row) and the challenges. A proof that does
        not parse or has the wrong shape gets None, infinity statements
        and zero scalars: its row verifies False."""
        n = n_in + n_out + 2
        proofs: List[Optional[TransferWF]] = []
        stmts: List = []
        resp: List[int] = []
        chals: List[int] = []
        for inputs, outputs, raw in txs:
            try:
                wf = TransferWF.from_bytes(raw)
            except Exception:
                wf = None
            if wf is not None and (
                len(wf.input_values) != n_in
                or len(wf.input_bfs) != n_in
                or len(wf.output_values) != n_out
                or len(wf.output_bfs) != n_out
            ):
                wf = None
            proofs.append(wf)
            if wf is None:
                stmts.extend([None] * n)
                resp.extend([0] * (3 * n))
                chals.append(0)
                continue
            stmts.extend(inputs)
            stmts.append(hm.g1_sum(inputs))
            stmts.extend(outputs)
            stmts.append(hm.g1_sum(outputs))
            for k in range(n_in):
                resp.extend([wf.type_resp, wf.input_values[k], wf.input_bfs[k]])
            resp.extend([wf.type_resp * n_in % hm.R, wf.sum_resp, sum(wf.input_bfs) % hm.R])
            for k in range(n_out):
                resp.extend([wf.type_resp, wf.output_values[k], wf.output_bfs[k]])
            resp.extend([wf.type_resp * n_out % hm.R, wf.sum_resp, sum(wf.output_bfs) % hm.R])
            chals.append(wf.challenge)
        return proofs, stmts, resp, chals


class BatchedTransferVerifier:
    """Verifies whole blocks of same-shape zkatdlog transfer proofs.

    Mirrors `transfer.TransferVerifier`, with the group work of ALL
    transactions in one launch per stage. This slice takes 1-in/1-out
    blocks; other shapes raise `NotImplementedError`.
    """

    def __init__(self, pp: PublicParams, device=None):
        self.pp = pp
        self.device = resolve_device(device)
        self.wf = BatchedWFVerifier(pp, device=self.device)
        self.table3 = self.wf.table  # ped 3-base table

    @_spanned("batch.transfer.verify")
    def verify(self, txs: Sequence[Tuple[list, list, bytes]]) -> np.ndarray:
        """txs: (inputs, outputs, transfer_proof_bytes), uniform shapes.
        Returns bool array (B,)."""
        B = len(txs)
        if B == 0:
            return np.zeros(0, dtype=bool)
        n_in, n_out = len(txs[0][0]), len(txs[0][1])
        if (n_in, n_out) != (1, 1) or any(
            (len(t[0]), len(t[1])) != (n_in, n_out) for t in txs
        ):
            raise NotImplementedError(
                f"batched verify of {n_in}-in/{n_out}-out transfers: {RANGE_PATH_ITEM}"
            )
        proofs = []
        ok = np.ones(B, dtype=bool)
        for i, t in enumerate(txs):
            try:
                proofs.append(TransferProof.from_bytes(t[2]))
            except Exception:
                proofs.append(TransferProof(wf=b"", range_correctness=None))
                ok[i] = False
        ok &= self.wf.verify([(t[0], t[1], p.wf) for t, p in zip(txs, proofs)])
        mx.counter("batch.transfer.txs").inc(B)
        return ok
