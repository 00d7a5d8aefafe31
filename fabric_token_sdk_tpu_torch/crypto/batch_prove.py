"""Batched transfer-proof generation on the GPU (the prove plane).

Counterpart of `fabric_token_sdk_tpu/crypto/batch_prove.py`. A
`BatchedTransferProver` takes N same-shape `(n_in, n_out)` witness sets
and generates N transfer proofs in one pass:

* commit phase on the card: every Pedersen commitment, the PS
  signature randomisation and obfuscation, and the membership GT
  pre-commitments, one launch a stage over all rows of the batch
  (`ops/stages.py`), with tensors kept on the card between stages;
* Fiat-Shamir and responses on the host, shared verbatim with the host
  provers through the `draw`/`finish` split of `wellformedness.py`,
  `rangeproof.py` and `sigproof.py`.

The rng is drawn in the reference's order (all WF draws, then all range
draws) and the host work is the reference's, so for the same
`random.Random` seed the proof bytes equal the JAX package's batched
prover's, and the host `TransferVerifier` accepts them.

A prover takes an optional `DeviceMesh` (`mesh=`, `set_mesh`, and
`prover_for(pp, device, mesh)`, which re-binds a cached prover as the
reference's does): each stage then runs over the mesh's row groups, its
committers' tables copied to the mesh's devices when it is bound, and
the K = 2 product through `sharded_pairing_product`. The proof bytes do
not depend on the mesh.

Every scalar the prover multiplies by is secret, so each fixed-base
multiexp takes the select form (`g1_msm_select`: all 16 window entries
read, the digit's kept by a mask), and the variable-base ladders
(`g1_mul`, `g2_mul`) add and select on every bit. Two steps still
depend on secret data, as in the reference: the gather of the signed
set's signature points by digit value (here a device `index_select`)
and the host decode's Fermat inverses.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import hostmath as hm, pssign, rangeproof, sigproof, wellformedness as wf
from .batch import _upload, resolve_device
from .pedersen import BatchedPedersen
from .setup import PublicParams
from .transfer import TransferProof, _skip_range
from ..ops import curve as cv, curve2 as cv2, limbs as lb, pairing as pr, stages as st, tower as tw
from ..parallel.sharding import DeviceMesh, MeshBound, sharded_pairing_product
from ..utils import devobs
from ..utils import metrics as mx


def _scalar_rows(rows: Sequence[Sequence[int]], width: int) -> np.ndarray:
    """Host int rows -> canonical scalar words (N, width, 8)."""
    flat = cv.encode_scalars([s for row in rows for s in row])
    return flat.reshape(len(rows), width, lb.NWORDS)


class BatchedTransferProver(MeshBound, torch.nn.Module):
    """Generates whole batches of same-shape zkatdlog transfer proofs.

    State, all buffers on the prover's device (`.to()` moves them): the
    window tables of the three committers (Pedersen 3-base and 2-base,
    the generator P), the encoded PS public key `pk` (3, 3, 2, 8), `Q`
    affine (2, 2, 8), and the signed set's signature points `sig_R`,
    `sig_S` (base, 3, 8). Building it is the expensive part (host window
    multiples); `prove` calls are cheap and reusable across shapes and
    batch sizes.
    """

    def __init__(self, pp: PublicParams, device=None, mesh: Optional[DeviceMesh] = None):
        super().__init__()
        self.pp = pp
        dev = resolve_device(device)
        self.ped3 = BatchedPedersen(pp.ped_params)
        self.ped2 = BatchedPedersen(pp.ped_params[:2])
        rp = pp.range_params
        self.pedP = BatchedPedersen([pp.ped_gen]) if rp is not None else None
        if rp is not None:
            self.register_buffer("pk", torch.from_numpy(cv2.encode_points(rp.sign_pk)))
            self.register_buffer("Q", torch.from_numpy(pr.encode_g2([rp.Q])[0]))
            self.register_buffer("sig_R", torch.from_numpy(
                cv.encode_points([s.R for s in rp.signed_values])))
            self.register_buffer("sig_S", torch.from_numpy(
                cv.encode_points([s.S for s in rp.signed_values])))
        self.to(dev)
        self.set_mesh(mesh)

    @property
    def device(self) -> torch.device:
        return self.ped3.device

    def set_mesh(self, mesh: Optional[DeviceMesh]) -> None:
        """Bind the prover and its committers to `mesh` (None unbinds)."""
        for ped in (self.ped3, self.ped2, self.pedP):
            if ped is not None:
                ped.set_mesh(mesh)
        super().set_mesh(mesh)

    # ------------------------------------------------------------ helpers

    @staticmethod
    def _check_shapes(reqs) -> Tuple[int, int]:
        shapes = {(len(r[2]), len(r[3])) for r in reqs}
        if len(shapes) != 1:
            raise ValueError(
                f"batched prove needs one uniform (n_in, n_out) shape, got {sorted(shapes)}"
            )
        (n_in, n_out), = shapes
        if n_in == 0 or n_out == 0:
            raise ValueError("batched prove: empty inputs or outputs")
        return n_in, n_out

    # ------------------------------------------------------------ WF phase

    def _prove_wf(self, reqs, n_in: int, n_out: int, rng) -> List[bytes]:
        with mx.span("batch.prove.draw"):
            provers = [
                wf.TransferWFProver(
                    wf.TransferWFWitness(
                        token_type=iw[0].token_type,
                        in_values=[w.value for w in iw],
                        in_bfs=[w.bf for w in iw],
                        out_values=[w.value for w in ow],
                        out_bfs=[w.bf for w in ow],
                    ),
                    self.pp.ped_params, inputs, outputs, rng,
                )
                for iw, ow, inputs, outputs in reqs
            ]
            draws = [p.draw() for p in provers]
            rows: List[List[int]] = []
            for d in draws:
                rows += d.commit_rows(n_in, n_out)
            scalars = _scalar_rows(rows, 3)
        with mx.span("batch.prove.device", rows=len(rows)):
            jac = self.ped3.commit_rows(_upload(scalars, self.device)).cpu().numpy()
        with mx.span("batch.prove.decode", rows=len(rows)):
            coms = cv.decode_points(jac)
        n = n_in + n_out + 2
        out = []
        with mx.span("batch.prove.finish"):
            for i, (p, d) in enumerate(zip(provers, draws)):
                row = coms[i * n : (i + 1) * n]
                chal = wf.challenge_transfer_wf(
                    row[:n_in], row[n_in], row[n_in + 1 : -1], row[-1], p.inputs, p.outputs,
                )
                out.append(p.finish(d, chal))
        return out

    # ------------------------------------------------------------ range phase

    def _prove_range(self, reqs, n_out: int, rng) -> List[bytes]:
        pp, rp = self.pp, self.pp.range_params
        if rp is None:
            raise ValueError("public params carry no range-proof parameters")
        base, exponent = rp.base, rp.exponent
        B = len(reqs)
        M = B * n_out * exponent  # flattened (tx, output, digit) rows
        with mx.span("batch.prove.draw"):
            provers = [
                rangeproof.RangeProver(
                    [rangeproof.TokenWitness(w.token_type, w.value, w.bf) for w in ow],
                    outputs, rp.signed_values, base, exponent,
                    pp.ped_params, rp.sign_pk, pp.ped_gen, rp.Q, rng,
                )
                for _, ow, _, outputs in reqs
            ]
            draws = [p.draw() for p in provers]  # raises on out-of-range values
            digits = [d.digits[k][i] for d in draws for k in range(n_out) for i in range(exponent)]
            digit_bfs = [d.digit_bfs[k][i] for d in draws for k in range(n_out)
                         for i in range(exponent)]
            mems = [d.mem[k][i] for d in draws for k in range(n_out) for i in range(exponent)]
            # ped[:2] rows: digit commitments (d, bf), membership value
            # announcements (rho_v, rho_cb), equality digit-aggregate
            # announcements (rho_v, rho_cb); ped rows: per-token equality
            # announcements
            rows2 = [[digits[j], digit_bfs[j]] for j in range(M)] + [
                [m.rho_v, m.rho_cb] for m in mems]
            rows3: List[List[int]] = []
            for d in draws:
                rows2 += d.equality_value_rows()
                rows3 += d.equality_token_rows()
            # every scalar of the phase, uploaded at once: ped2 rows, ped3
            # rows, r (M), sig_bf then rho_bf (2M), rho_v then rho_h (2M)
            n2, n3 = len(rows2), len(rows3)
            scalars = np.concatenate([
                _scalar_rows(rows2, 2).reshape(-1, lb.NWORDS),
                _scalar_rows(rows3, 3).reshape(-1, lb.NWORDS),
                cv.encode_scalars([m.r for m in mems]),
                cv.encode_scalars([m.sig_bf for m in mems] + [m.rho_bf for m in mems]),
                cv.encode_scalars([m.rho_v for m in mems] + [m.rho_h for m in mems]),
            ])
            digit_idx = np.asarray(digits, dtype=np.int64)

        with mx.span("batch.prove.device", rows=M):
            sc = _upload(scalars, self.device)
            ends = np.cumsum([2 * n2, 3 * n3, M, 2 * M, 2 * M])
            s2, s3, r, pbf, g2s = (sc[a:b] for a, b in zip([0, *ends[:-1]], ends))
            coms2 = self.ped2.commit_rows(s2.reshape(n2, 2, lb.NWORDS))
            coms3 = self.ped3.commit_rows(s3.reshape(n3, 3, lb.NWORDS))
            # signature randomisation (R^r, S^r), then obfuscation
            # S'' = S^r + P^sig_bf; P^rho_bf goes to the transcript
            run = self._run
            dig = _upload(digit_idx, self.device)
            rnd = run(st.g1_mul_rows, torch.cat([self.sig_R.index_select(0, dig),
                                                 self.sig_S.index_select(0, dig)]),
                      torch.cat([r, r]))
            p_bf = self.pedP.commit_rows(pbf.reshape(2 * M, 1, lb.NWORDS))
            obf_S = run(st.g1_add_rows, rnd[M:], p_bf[:M])
            host = torch.cat([coms2, coms3, rnd[:M], obf_S, p_bf[M:]]).cpu().numpy()
            # GT pre-commitments, G2 side: t = PK1^rho_v + PK2^rho_h,
            # queued before the host decode below so that it overlaps it
            g2_bases = torch.cat([self.pk[1].expand((M,) + tuple(self.pk.shape[1:])),
                                  self.pk[2].expand((M,) + tuple(self.pk.shape[1:]))])
            terms = run(st.g2_mul_rows, g2_bases.contiguous(), g2s)
            t_aff = run(st.g2_to_affine_rows, run(st.g2_add_rows, terms[:M], terms[M:]))

        # one host decode pass for every point that enters a transcript
        with mx.span("batch.prove.decode", rows=len(host)):
            pts = cv.decode_points(host)
            digit_coms, mem_com_vals, eq_com_values = pts[:M], pts[M : 2 * M], pts[2 * M : n2]
            eq_com_tokens = pts[n2 : n2 + n3]
            rnd_R, obf_S_h, p_rho = (pts[n2 + n3 + i * M : n2 + n3 + (i + 1) * M]
                                     for i in range(3))
            Ps = np.stack([pr.encode_g1(rnd_R), pr.encode_g1(p_rho)], axis=1)  # (M, 2, 2, 8)

        # com_gt = e(R', t) * e(P^rho_bf, Q): the staged K = 2 product
        with mx.span("batch.prove.device", rows=M):
            Qs = torch.stack([t_aff, self.Q.expand_as(t_aff)], dim=1)  # (M, 2, 2, 2, 8)
            gt = sharded_pairing_product(_upload(Ps, self.device), Qs, self.mesh).cpu().numpy()
        with mx.span("batch.prove.decode", rows=M):
            gts = tw.decode_fp12(gt)

        # host Fiat-Shamir and responses (shared with the host prover)
        with mx.span("batch.prove.finish"):
            mem_proofs_flat: List[sigproof.MembershipProof] = []
            for j in range(M):
                obf = pssign.Signature(rnd_R[j], obf_S_h[j])
                mv = sigproof.MembershipVerifier(
                    digit_coms[j], pp.ped_gen, rp.Q, rp.sign_pk, pp.ped_params[:2])
                chal = mv._challenge(gts[j], mem_com_vals[j], obf)
                w = sigproof.MembershipWitness(rp.signed_values[digits[j]], digits[j], digit_bfs[j])
                mem_proofs_flat.append(sigproof.membership_finish(w, mems[j], obf, chal,
                                                                  digit_coms[j]))
            out = []
            per_tx = n_out * exponent
            for i, (p, d) in enumerate(zip(provers, draws)):
                tx_coms = digit_coms[i * per_tx : (i + 1) * per_tx]
                tx_mems = mem_proofs_flat[i * per_tx : (i + 1) * per_tx]
                dc = [tx_coms[k * exponent : (k + 1) * exponent] for k in range(n_out)]
                mp = [tx_mems[k * exponent : (k + 1) * exponent] for k in range(n_out)]
                chal = p._challenge(eq_com_tokens[i * n_out : (i + 1) * n_out],
                                    eq_com_values[i * n_out : (i + 1) * n_out], dc)
                out.append(p.finish(d, dc, mp, chal))
        return out

    # ------------------------------------------------------------ entry

    def prove(self, reqs: Sequence[tuple], rng=None) -> List[bytes]:
        """reqs: (in_witnesses, out_witnesses, inputs, outputs) tuples of
        ONE uniform `(n_in, n_out)` shape, the arguments of the host
        `TransferProver` constructor. Returns one transfer-proof byte
        string a request, in the host prover's wire format."""
        reqs = list(reqs)
        if not reqs:
            return []
        n_in, n_out = self._check_shapes(reqs)
        with devobs.plane("prove"), mx.span("batch.prove", txs=len(reqs),
                                            shape=f"({n_in},{n_out})"):
            with mx.span("batch.prove.wf"):
                wfs = self._prove_wf(reqs, n_in, n_out, rng)
            if _skip_range(n_in, n_out):
                ranges: List[Optional[bytes]] = [None] * len(reqs)
            else:
                with mx.span("batch.prove.range"):
                    ranges = self._prove_range(reqs, n_out, rng)
        mx.counter("batch.prove.batches").inc()
        mx.counter("batch.prove.txs").inc(len(reqs))
        return [TransferProof(wf=w, range_correctness=rc).to_bytes() for w, rc in zip(wfs, ranges)]


def prover_state_from_reference(arrays) -> dict:
    """The JAX package's prover state as this module's buffers.

    `arrays` maps "ped3", "ped2", "pedP" to the reference committers'
    `table.flat` (nbases*64, 16, 96) and "pk", "Q", "sig_R", "sig_S" to
    its `pk_np`, `Q_np`, `sig_R_np`, `sig_S_np`, all numpy 8-bit limbs.
    Returns a state dict for `BatchedTransferProver.load_state_dict`."""
    state = {f"{name}.table.table": cv.FixedBaseTable.from_reference(arrays[name]).table
             for name in ("ped3", "ped2", "pedP")}
    for name in ("pk", "Q", "sig_R", "sig_S"):
        state[name] = lb.from_reference_limbs(np.asarray(arrays[name]), hm.P)
    return state


# ---------------------------------------------------------------- cache

# The window tables are expensive to build, so repeated
# `TransferProver.batch` calls against the same PublicParams reuse one
# prover a device. PublicParams is an unhashable mutable dataclass: the
# key is object identity with a strong reference, and the cap bounds
# growth.
_CACHE: List[Tuple[PublicParams, torch.device, BatchedTransferProver]] = []
_CACHE_CAP = 4


def prover_for(pp: PublicParams, device=None,
               mesh: Optional[DeviceMesh] = None) -> BatchedTransferProver:
    """The cached prover of `pp` on `device`, built on first use. The cache
    keeps the tables; `mesh` is re-bound on every call, None unbinding, so
    a caller never inherits a mesh another caller bound (the reference's
    contract, `batch_prove.py:309-318`)."""
    dev = resolve_device(device)
    for cached_pp, cached_dev, prover in _CACHE:
        if cached_pp is pp and cached_dev == dev:
            prover.set_mesh(mesh)
            return prover
    prover = BatchedTransferProver(pp, device=dev, mesh=mesh)
    _CACHE.append((pp, dev, prover))
    if len(_CACHE) > _CACHE_CAP:
        _CACHE.pop(0)
    return prover
