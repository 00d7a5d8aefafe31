"""Batched verification of zkatdlog transfer proofs on the GPU.

Counterpart of `fabric_token_sdk_tpu/crypto/batch.py`. Whole blocks of
transactions verify through the row stages of `ops/stages.py`, each one
launch over all flat rows: host code parses proofs and lays out scalars
and statements, the card recomputes every Schnorr commitment, and host
code re-derives the Fiat-Shamir challenges.

Every uniform transfer shape verifies. A 1-in/1-out transfer (the
reference's ownership transfer, `transfer.go:55-59`) carries no range
proof: its verification is the well-formedness proof alone, three
kernels (`g1_msm`, `g1_mul`, `g1_addsub`). Any other shape carries a
range proof over its outputs: membership proofs, one a digit, verified
as 4-leg pairing products (`BatchedMembershipVerifier`: G2 ladder, G2
add and to-affine, G1 to-affine, Miller loop, GT product, final
exponentiation), and the equality sigma proof on the G1 kernels. A
block of mixed shapes raises `NotImplementedError`.

`BatchedPSVerifier` checks Pointcheval-Sanders signatures the same way,
as 2-leg pairing products.

Each verifier takes an optional `DeviceMesh` (`mesh=`, `set_mesh`; the
reference's `_MeshBound`, here `parallel.sharding.MeshBound`): its stage
calls then run over the mesh's row groups and its pairing products
through `sharded_pairing_product` (`fused=` picks the fused product, off
by default as in the reference). The window tables are copied to each
device of the mesh when it is bound. Verdicts never depend on the mesh;
`mesh=None` is one launch a stage over all rows.

Spans: `batch.<plane>.verify` around each verify, and inside it
`batch.wf.*`, `batch.membership.*` and `batch.range.*` (parse, encode,
device, decode, challenge), each leaf named by the verifier that opens
it, so no span total holds another verifier's work.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import hostmath as hm, pssign, sigproof
from .rangeproof import RangeProof, RangeVerifier
from .setup import PublicParams
from .transfer import TransferProof
from .wellformedness import TransferWF, challenge_transfer_wf
from ..ops import curve as cv, curve2 as cv2, limbs as lb, pairing as pr, stages as st, tower as tw
from ..parallel.sharding import DeviceMesh, MeshBound as _MeshBound, sharded_pairing_product
from ..utils import devobs
from ..utils import metrics as mx


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
    """Wrap a verify method in a metrics span (no-op when disabled) and
    a dispatch-ledger plane tag (`utils/devobs.py`): every kernel launch
    the method makes is ledgered under the plane named by the span's
    middle token (`batch.sign.verify` -> `sign`, every other
    `batch.*.verify` -> `verify`)."""
    middle = name.split(".")[1] if "." in name else name
    plane = middle if middle in ("sign", "prove") else "verify"

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with devobs.plane(plane), mx.span(name):
                return fn(*args, **kw)

        return wrapper

    return deco


class BatchedWFVerifier(_MeshBound):
    """Recomputes all Schnorr commitments of B same-shape transfer WF
    proofs through the row stages, then re-derives challenges on host."""

    def __init__(self, pp: PublicParams, device=None, mesh: Optional[DeviceMesh] = None):
        self.pp = pp
        self.device = resolve_device(device)
        self.table = cv.FixedBaseTable(pp.ped_params).to(self.device)
        self.set_mesh(mesh)

    def _mesh_tables(self) -> tuple:
        return (self.table.table,)

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
            fixed = self._run(st.g1_msm_rows, resp_t, consts=(self.table.table,))
            sc = self._run(st.g1_mul_rows, stmt_t, chal_t)
            coms = self._run(st.g1_sub_rows, fixed, sc).cpu().numpy()
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


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


class BatchedMembershipVerifier(_MeshBound):
    """Verifies B membership proofs (the per-digit unit of range proofs).

    Device: the GT commitment as 4-leg pairing products and the G1
    commitment as fixed- and variable-base multiexps, one launch per
    stage over all B proofs (a row group of a bound mesh). Host: the
    per-proof Fiat-Shamir challenge.
    """

    def __init__(self, pp: PublicParams, device=None, mesh: Optional[DeviceMesh] = None,
                 fused: bool = False):
        self.pp = pp
        self.device = resolve_device(device)
        self.fused = fused
        rp = pp.range_params
        self.pk = rp.sign_pk
        self.Q = rp.Q
        self.P = pp.ped_gen
        self.ped2 = pp.ped_params[:2]
        dev = self.device
        self.pk12 = _upload(cv2.encode_points(self.pk[1:3]), dev)  # (2, 3, 2, 8)
        self.Q_aff = _upload(pr.encode_g2([self.Q])[0], dev)  # (2, 2, 8)
        self.pk0_aff = _upload(pr.encode_g2([self.pk[0]])[0], dev)
        self.table2 = cv.FixedBaseTable(self.ped2).to(dev)
        self.tableP = cv.FixedBaseTable([self.P]).to(dev)
        self.set_mesh(mesh)

    def _mesh_tables(self) -> tuple:
        return (self.table2.table, self.tableP.table)

    @_spanned("batch.membership.verify")
    def verify(self, proofs: Sequence[sigproof.MembershipProof], commitments: Sequence) -> np.ndarray:
        B = len(proofs)
        if B == 0:
            return np.zeros(0, dtype=bool)
        mx.counter("batch.membership.proofs").inc(B)
        dev = self.device
        with mx.span("batch.membership.parse", rows=B):
            z = np.stack([
                cv.encode_scalars([p.value_resp for p in proofs]),
                cv.encode_scalars([p.hash_resp for p in proofs]),
                cv.encode_scalars([p.sig_bf_resp for p in proofs]),
                cv.encode_scalars([p.challenge for p in proofs]),
            ], axis=1)  # (B, 4, 8): value, hash, sig_bf, challenge
            com_resp = np.stack([z[:, 0], cv.encode_scalars([p.com_bf_resp for p in proofs])], axis=1)
            neg_chal = cv.encode_scalars([-p.challenge for p in proofs])
            S_aff = pr.encode_g1([p.signature.S for p in proofs])
            R_aff = pr.encode_g1([p.signature.R for p in proofs])
            com_jac = cv.encode_points(commitments)
        with mx.span("batch.membership.device", rows=B):
            run = self._run
            z_t = _upload(z, dev)
            S_t, R_t = _upload(S_aff, dev), _upload(R_aff, dev)
            # G2 term: t = PK1^{z_v} + PK2^{z_h}
            bases = self.pk12.unsqueeze(0).expand((B,) + tuple(self.pk12.shape)).reshape(
                (2 * B,) + tuple(self.pk12.shape[1:])).contiguous()
            terms = run(st.g2_mul_rows, bases, z_t[:, 0:2].reshape(2 * B, lb.NWORDS).contiguous())
            terms = terms.reshape((B, 2) + tuple(terms.shape[1:]))
            t_aff = run(st.g2_to_affine_rows, run(st.g2_add_rows, terms[:, 0].contiguous(),
                                                  terms[:, 1].contiguous()))
            # G1 sides: -S^c as S^{r-c}, R^c and P^{z_bf}; one to-affine
            # launch for all three. An affine (0, 0) (S or R at infinity)
            # enters as the Jacobian (0, 0, 1), as in the reference.
            Sj = _upload(st.affine_to_jac_np(S_aff), dev)
            Rj = _upload(st.affine_to_jac_np(R_aff), dev)
            powc = run(st.g1_mul_rows, torch.cat([Sj, Rj]),
                       torch.cat([_upload(neg_chal, dev), z_t[:, 3]]).contiguous())
            Pz = run(st.g1_msm_rows, z_t[:, 2:3].contiguous(), consts=(self.tableP.table,))
            aff = run(st.g1_to_affine_rows, torch.cat([powc, Pz]))
            negSc, Rc, Pz_aff = aff[:B], aff[B : 2 * B], aff[2 * B :]
            # G1 commitment: ped0^{z_v} ped1^{z_cb} - com^c
            fixed = run(st.g1_msm_rows, _upload(com_resp, dev), consts=(self.table2.table,))
            comc = run(st.g1_mul_rows, _upload(com_jac, dev), z_t[:, 3].contiguous())
            com_val = run(st.g1_sub_rows, fixed, comc)
            # 4-leg pairing products; no infinity mask (the reference
            # passes none: a leg at infinity enters the Miller loop as
            # the affine (0, 0))
            Ps = torch.stack([negSc, Rc, R_t, Pz_aff], dim=1)  # (B, 4, 2, 8)
            Qs = torch.stack([self.Q_aff.expand_as(t_aff), self.pk0_aff.expand_as(t_aff), t_aff,
                              self.Q_aff.expand_as(t_aff)], dim=1)  # (B, 4, 2, 2, 8)
            gt = sharded_pairing_product(Ps, Qs, self.mesh, fused=self.fused).cpu().numpy()
            com_np = com_val.cpu().numpy()
        with mx.span("batch.membership.decode", rows=B):
            gt_host = tw.decode_fp12(gt)
            com_host = cv.decode_points(com_np)
        out = np.zeros(B, dtype=bool)
        with mx.span("batch.membership.challenge", rows=B):
            for i, (p, com) in enumerate(zip(proofs, commitments)):
                if p.commitment != com:
                    continue
                mv = sigproof.MembershipVerifier(com, self.P, self.Q, self.pk, self.ped2)
                out[i] = mv._challenge(gt_host[i], com_host[i], p.signature) == p.challenge
        return out


class BatchedPSVerifier(_MeshBound):
    """Verifies B Pointcheval-Sanders signatures on l-message vectors:
    e(-S, Q) * e(R, H) == 1 with H = PK0 + sum PK_i^{m_i} + PK_{l+1}^{hash}
    built on the card (G2 ladder, a host-folded tree of G2 adds, to-affine)
    and the two legs through the staged K = 2 pairing product. Rows that
    do not parse (wrong message count, no signature) verify False."""

    def __init__(self, pk, Q, device=None, mesh: Optional[DeviceMesh] = None,
                 fused: bool = False):
        self.pk_host = list(pk)
        self.Q_host = Q
        self.device = resolve_device(device)
        self.fused = fused
        self.pk = _upload(cv2.encode_points(self.pk_host), self.device)  # (l+2, 3, 2, 8)
        self.Q_aff = _upload(pr.encode_g2([Q])[0], self.device)  # (2, 2, 8)
        self.set_mesh(mesh)

    @_spanned("batch.ps.verify")
    def verify(self, messages_rows: Sequence[Sequence[int]], sigs) -> np.ndarray:
        """-> bool array (B,). Raises nothing; invalid rows are False."""
        B = len(sigs)
        if B == 0:
            return np.zeros(0, dtype=bool)
        mx.counter("batch.ps.sigs").inc(B)
        l = len(self.pk_host) - 2
        k = l + 1
        scal = np.zeros((B, k, lb.NWORDS), dtype=np.int32)
        negS, R = [], []
        malformed = np.zeros(B, dtype=bool)
        for i, (msgs, sig) in enumerate(zip(messages_rows, sigs)):
            try:
                if len(msgs) != l:
                    raise ValueError("PS batch: message count mismatch")
                scal[i] = cv.encode_scalars(list(msgs) + [pssign.hash_messages(msgs)])
                s_neg, r = hm.g1_neg(sig.S), sig.R
                negS.append(s_neg)
                R.append(r)
            except Exception:
                malformed[i] = True
                negS.append(hm.G1_GEN)  # placeholder; the row is forced False
                R.append(hm.G1_GEN)
        dev = self.device
        shape = tuple(self.pk.shape[1:])
        bases = self.pk[1:].unsqueeze(0).expand((B, k) + shape).reshape((B * k,) + shape)
        run = self._run
        terms = run(st.g2_mul_rows, bases.contiguous(), _upload(scal.reshape(B * k, lb.NWORDS), dev))
        acc = run(st.g2_tree_sum_rows, terms.reshape((B, k) + shape))
        acc = run(st.g2_add_rows, acc.contiguous(), self.pk[0].expand_as(acc).contiguous())
        H_aff = run(st.g2_to_affine_rows, acc)  # (B, 2, 2, 8)
        Ps = _upload(np.stack([pr.encode_g1(negS), pr.encode_g1(R)], axis=1), dev)
        Qs = torch.stack([self.Q_aff.expand_as(H_aff), H_aff], dim=1)  # (B, 2, 2, 2, 8)
        gt = sharded_pairing_product(Ps, Qs, self.mesh, fused=self.fused)
        out = pr.gt_is_one_host(gt.cpu().numpy())
        out[malformed] = False
        return out


class BatchedTransferVerifier(_MeshBound):
    """Verifies whole blocks of same-shape zkatdlog transfer proofs.

    Mirrors `transfer.TransferVerifier`, with the group and pairing work
    of ALL transactions in one launch per stage (a row group of a bound
    mesh): the well-formedness proofs, then (unless the shape is
    1-in/1-out) the range proofs' membership proofs, flattened over (tx,
    output, digit), and their equality proofs. A block of mixed shapes
    raises NotImplementedError.
    """

    def __init__(self, pp: PublicParams, device=None, mesh: Optional[DeviceMesh] = None,
                 fused: bool = False):
        self.pp = pp
        self.device = resolve_device(device)
        self.wf = BatchedWFVerifier(pp, device=self.device)
        self.membership = BatchedMembershipVerifier(pp, device=self.device, fused=fused)
        self.table3 = self.wf.table  # ped 3-base table
        self.table2 = self.membership.table2  # ped[:2]
        self.set_mesh(mesh)

    def set_mesh(self, mesh: Optional[DeviceMesh]) -> None:
        """Bind this verifier and its WF and membership parts to `mesh`
        (None unbinds); the equality proofs share their parts' table
        copies."""
        self.wf.set_mesh(mesh)
        self.membership.set_mesh(mesh)
        self.mesh = self.wf.mesh
        self._replicas = {**self.wf._replicas, **self.membership._replicas}

    @_spanned("batch.transfer.verify")
    def verify(self, txs: Sequence[Tuple[list, list, bytes]]) -> np.ndarray:
        """txs: (inputs, outputs, transfer_proof_bytes), uniform shapes.
        Returns bool array (B,). 1-in/1-out transfers carry no range
        proof (reference transfer.go:55-59)."""
        B = len(txs)
        if B == 0:
            return np.zeros(0, dtype=bool)
        n_in, n_out = len(txs[0][0]), len(txs[0][1])
        if any((len(t[0]), len(t[1])) != (n_in, n_out) for t in txs):
            shapes = sorted({(len(t[0]), len(t[1])) for t in txs})
            raise NotImplementedError(
                f"batched verify of a block of mixed transfer shapes {shapes}: "
                "split the block by (inputs, outputs)"
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
        if (n_in, n_out) != (1, 1):
            ok &= self._verify_ranges(txs, proofs, n_out)
        mx.counter("batch.transfer.txs").inc(B)
        return ok

    def _verify_ranges(self, txs, proofs, n_out: int) -> np.ndarray:
        """The range proofs of a block: False for a missing or malformed
        proof, a failed membership proof or a failed equality proof."""
        B = len(txs)
        ok = np.ones(B, dtype=bool)
        rp = self.pp.range_params
        exponent, base = rp.exponent, rp.base
        with mx.span("batch.range.parse", rows=B):
            ranges: List[Optional[RangeProof]] = []
            for i, p in enumerate(proofs):
                rpf = None
                if p.range_correctness is not None:
                    try:
                        rpf = RangeProof.from_bytes(p.range_correctness)
                        if (
                            len(rpf.membership_proofs) != n_out
                            or len(rpf.digit_commitments) != n_out
                            or any(len(r) != exponent for r in rpf.membership_proofs)
                            or any(len(r) != exponent for r in rpf.digit_commitments)
                            or len(rpf.value_resps) != n_out
                            or len(rpf.token_bf_resps) != n_out
                            or len(rpf.com_bf_resps) != n_out
                        ):
                            rpf = None
                    except Exception:
                        rpf = None
                ok[i] = rpf is not None
                ranges.append(rpf)
            # membership proofs, flattened over (tx, output, digit)
            mem_proofs, mem_coms, mem_idx = [], [], []
            for i, rpf in enumerate(ranges):
                if rpf is None:
                    continue
                for k in range(n_out):
                    for d in range(exponent):
                        mem_proofs.append(rpf.membership_proofs[k][d])
                        mem_coms.append(rpf.digit_commitments[k][d])
                        mem_idx.append(i)
        if mem_proofs:
            mem_ok = self.membership.verify(mem_proofs, mem_coms)
            for j, i in enumerate(mem_idx):
                if not mem_ok[j]:
                    ok[i] = False

        # equality proofs: token rows (3 bases) and aggregate rows (2)
        live = [i for i in range(B) if ranges[i] is not None]
        if not live:
            return ok
        nl = len(live)
        with mx.span("batch.range.parse", rows=nl):
            tok_resp, tok_stmt, agg_resp, agg_stmt, chals = [], [], [], [], []
            powers = [base**d % hm.R for d in range(exponent)]
            for i in live:
                rpf = ranges[i]
                for k in range(n_out):
                    tok_resp.extend([rpf.type_resp, rpf.value_resps[k], rpf.token_bf_resps[k]])
                    tok_stmt.append(txs[i][1][k])
                    agg_stmt.append(hm.g1_multiexp(rpf.digit_commitments[k], powers))
                    agg_resp.extend([rpf.value_resps[k], rpf.com_bf_resps[k]])
                chals.append(rpf.challenge)
            rows = nl * n_out
            tok_resp = cv.encode_scalars(tok_resp).reshape(rows, 3, lb.NWORDS)
            agg_resp = cv.encode_scalars(agg_resp).reshape(rows, 2, lb.NWORDS)
            chal_rep = np.repeat(cv.encode_scalars(chals), n_out, axis=0)
            tok_stmt = cv.encode_points(tok_stmt)
            agg_stmt = cv.encode_points(agg_stmt)
        dev = self.device
        with mx.span("batch.range.device", rows=rows):
            chal_t = _upload(chal_rep, dev)
            run = self._run
            com_tok = run(st.g1_sub_rows,
                          run(st.g1_msm_rows, _upload(tok_resp, dev), consts=(self.table3.table,)),
                          run(st.g1_mul_rows, _upload(tok_stmt, dev), chal_t))
            com_val = run(st.g1_sub_rows,
                          run(st.g1_msm_rows, _upload(agg_resp, dev), consts=(self.table2.table,)),
                          run(st.g1_mul_rows, _upload(agg_stmt, dev), chal_t))
            com_tok, com_val = com_tok.cpu().numpy(), com_val.cpu().numpy()
        with mx.span("batch.range.decode", rows=rows):
            com_tok_h = cv.decode_points(com_tok)
            com_val_h = cv.decode_points(com_val)
        with mx.span("batch.range.challenge", rows=nl):
            for li, i in enumerate(live):
                rpf = ranges[i]
                verifier = RangeVerifier(txs[i][1], base, exponent, self.pp.ped_params,
                                         rp.sign_pk, self.pp.ped_gen, rp.Q)
                chal = verifier._challenge(com_tok_h[li * n_out : (li + 1) * n_out],
                                           com_val_h[li * n_out : (li + 1) * n_out],
                                           rpf.digit_commitments)
                if chal != rpf.challenge:
                    ok[i] = False
        return ok
