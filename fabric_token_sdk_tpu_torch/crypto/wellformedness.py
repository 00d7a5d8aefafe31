"""Well-formedness sigma proofs for transfer and issue actions.

Transfer WF (reference `crypto/transfer/wellformedness.go`): inputs and
outputs are Pedersen commitments to (type, value; bf); the proof shows
knowledge of all openings, equal type across all tokens, and equal total
value of inputs and outputs (shared `sum` response).

Issue WF (reference `crypto/issue/wellformedness.go`): issued tokens are
commitments to (type, value; bf); shows knowledge of openings and a common
type — hidden (anonymous issuer) or in the clear.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from . import hostmath as hm
from . import schnorr
from .serialization import guard, dumps, g1s_bytes, loads


def _rand(rng) -> int:
    return hm.rand_zr(rng)


# ===================================================================
# Transfer well-formedness
# ===================================================================


@dataclass
class TransferWF:
    input_values: List[int]
    input_bfs: List[int]
    output_values: List[int]
    output_bfs: List[int]
    type_resp: int
    sum_resp: int
    challenge: int

    def to_bytes(self) -> bytes:
        return dumps(
            {
                "iv": self.input_values,
                "ib": self.input_bfs,
                "ov": self.output_values,
                "ob": self.output_bfs,
                "t": self.type_resp,
                "s": self.sum_resp,
                "c": self.challenge,
            }
        )

    @classmethod
    def from_bytes(cls, raw: bytes) -> "TransferWF":
        d = loads(raw)
        return cls(d["iv"], d["ib"], d["ov"], d["ob"], d["t"], d["s"], d["c"])


@dataclass
class TransferWFWitness:
    token_type: str
    in_values: List[int]
    in_bfs: List[int]
    out_values: List[int]
    out_bfs: List[int]


@dataclass
class TransferWFDraw:
    """Commit-phase randomness of one transfer WF proof — drawn once,
    consumed by either the host or the batched-device commit path (the
    Fiat-Shamir response math in `finish` is shared by both)."""

    rho_T: int
    rho_sum: int
    rho_iv: List[int]
    rho_ib: List[int]
    rho_ov: List[int]
    rho_ob: List[int]

    def commit_rows(self, n_in: int, n_out: int) -> List[List[int]]:
        """Scalar rows of the commit phase over the 3 Pedersen bases, in
        transcript order: per-input commitments, input sum, per-output
        commitments, output sum. Every commitment is one fixed-base
        3-term multiexp — on host via `hm.g1_multiexp`, on device via the
        `g1_msm3` stage tile (`crypto/batch_prove.py`)."""
        rows = [
            [self.rho_T, self.rho_iv[i], self.rho_ib[i]] for i in range(n_in)
        ]
        rows.append([self.rho_T * n_in, self.rho_sum, sum(self.rho_ib)])
        rows += [
            [self.rho_T, self.rho_ov[i], self.rho_ob[i]] for i in range(n_out)
        ]
        rows.append([self.rho_T * n_out, self.rho_sum, sum(self.rho_ob)])
        return rows


class TransferWFProver:
    def __init__(self, witness: TransferWFWitness, ped_params, inputs, outputs, rng=None):
        self.w = witness
        self.pp = list(ped_params)
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.rng = rng

    def draw(self) -> TransferWFDraw:
        w = self.w
        if len(w.in_values) != len(self.inputs) or len(w.out_values) != len(self.outputs):
            raise ValueError("transfer WF: malformed witness")
        return TransferWFDraw(
            rho_T=_rand(self.rng),
            rho_sum=_rand(self.rng),
            rho_iv=[_rand(self.rng) for _ in self.inputs],
            rho_ib=[_rand(self.rng) for _ in self.inputs],
            rho_ov=[_rand(self.rng) for _ in self.outputs],
            rho_ob=[_rand(self.rng) for _ in self.outputs],
        )

    def finish(self, d: TransferWFDraw, chal: int) -> bytes:
        w = self.w
        t_hash = hm.hash_to_zr(w.token_type.encode())
        return TransferWF(
            input_values=schnorr.respond(w.in_values, d.rho_iv, chal),
            input_bfs=schnorr.respond(w.in_bfs, d.rho_ib, chal),
            output_values=schnorr.respond(w.out_values, d.rho_ov, chal),
            output_bfs=schnorr.respond(w.out_bfs, d.rho_ob, chal),
            type_resp=schnorr.respond([t_hash], [d.rho_T], chal)[0],
            sum_resp=schnorr.respond([sum(w.in_values) % hm.R], [d.rho_sum], chal)[0],
            challenge=chal,
        ).to_bytes()

    def prove(self) -> bytes:
        d = self.draw()
        coms = [
            hm.g1_multiexp(self.pp[:3], [r % hm.R for r in row])
            for row in d.commit_rows(len(self.inputs), len(self.outputs))
        ]
        n_in = len(self.inputs)
        chal = challenge_transfer_wf(
            coms[:n_in], coms[n_in], coms[n_in + 1 : -1], coms[-1],
            self.inputs, self.outputs,
        )
        return self.finish(d, chal)


def challenge_transfer_wf(com_in, in_sum, com_out, out_sum, inputs, outputs) -> int:
    raw = g1s_bytes(com_in, [in_sum], com_out, [out_sum], inputs, outputs)
    return hm.hash_to_zr(raw, b"fts/transfer-wf")


def _side_proofs(tokens, values, bfs, type_resp, sum_resp, challenge):
    """Schnorr proofs for one side (inputs or outputs), incl. the aggregate
    sum proof over Sum(tokens). Reference wellformedness.go:parseProof."""
    if len(values) != len(tokens) or len(bfs) != len(tokens):
        raise ValueError("transfer WF: response count mismatch")
    proofs = [
        schnorr.SchnorrProof(tok, [type_resp, values[i], bfs[i]], challenge)
        for i, tok in enumerate(tokens)
    ]
    agg = hm.g1_sum(tokens)
    proofs.append(
        schnorr.SchnorrProof(
            agg,
            [type_resp * len(tokens) % hm.R, sum_resp, sum(bfs) % hm.R],
            challenge,
        )
    )
    return proofs


class TransferWFVerifier:
    def __init__(self, ped_params, inputs, outputs):
        self.pp = list(ped_params)
        self.inputs = list(inputs)
        self.outputs = list(outputs)

    @guard
    def verify(self, raw: bytes) -> None:
        wf = TransferWF.from_bytes(raw)
        in_proofs = _side_proofs(
            self.inputs, wf.input_values, wf.input_bfs, wf.type_resp, wf.sum_resp, wf.challenge
        )
        out_proofs = _side_proofs(
            self.outputs, wf.output_values, wf.output_bfs, wf.type_resp, wf.sum_resp, wf.challenge
        )
        in_coms = [schnorr.recompute_commitment(self.pp, pr) for pr in in_proofs]
        out_coms = [schnorr.recompute_commitment(self.pp, pr) for pr in out_proofs]
        # the last commitment of each side is the reconstructed sum commitment
        chal = challenge_transfer_wf(
            in_coms[:-1], in_coms[-1], out_coms[:-1], out_coms[-1], self.inputs, self.outputs
        )
        if chal != wf.challenge:
            raise ValueError("invalid transfer well-formedness proof")


def verify_transfer_wfs(ped_params, specs) -> List[Optional[bool]]:
    """Block-level transfer WF verification.

    `specs` are (inputs, outputs, raw_wf) triples — one per proof left to
    the host. Every proof's Schnorr commitment recomputation collapses
    into batched multiexp rows (`schnorr.recompute_commitments`) and every
    Fiat-Shamir challenge into ONE `hm.hash_to_zr_many` dispatch, instead
    of per-proof ctypes/hashlib round trips.

    Returns one entry per spec: True (challenge matches — byte-identical
    to `TransferWFVerifier.verify` accepting), False (challenge mismatch)
    or None (proof this batch could not evaluate). Degrade-only contract:
    callers treat anything but True as "re-verify on the scalar path",
    which owns the precise error message.
    """
    pp = list(ped_params)
    specs = list(specs)
    out: List[Optional[bool]] = [None] * len(specs)
    proofs: List[schnorr.SchnorrProof] = []
    # (spec index, wf, inputs, outputs, com slice start) per parsable spec
    plans = []
    for i, (inputs, outputs, raw) in enumerate(specs):
        try:
            wf = TransferWF.from_bytes(raw)
            start = len(proofs)
            proofs += _side_proofs(
                list(inputs), wf.input_values, wf.input_bfs,
                wf.type_resp, wf.sum_resp, wf.challenge,
            )
            proofs += _side_proofs(
                list(outputs), wf.output_values, wf.output_bfs,
                wf.type_resp, wf.sum_resp, wf.challenge,
            )
        except Exception:
            continue
        plans.append((i, wf, list(inputs), list(outputs), start))
    if not plans:
        return out
    coms = schnorr.recompute_commitments([pp] * len(proofs), proofs)
    transcripts = []
    keep = []  # (spec index, expected challenge) aligned with transcripts
    for i, wf, inputs, outputs, start in plans:
        n_in, n_out = len(inputs), len(outputs)
        in_coms = coms[start : start + n_in + 1]
        out_coms = coms[start + n_in + 1 : start + n_in + n_out + 2]
        try:
            raw = g1s_bytes(
                in_coms[:-1], [in_coms[-1]], out_coms[:-1], [out_coms[-1]],
                inputs, outputs,
            )
        except Exception:
            continue  # un-encodable commitment: scalar path reports it
        transcripts.append((raw, b"fts/transfer-wf"))
        keep.append((i, wf.challenge))
    for (i, expected), got in zip(keep, hm.hash_to_zr_many(transcripts)):
        out[i] = got == expected
    return out


# ===================================================================
# Issue well-formedness
# ===================================================================


@dataclass
class IssueWF:
    type_resp: Optional[int]  # set iff anonymous
    type_clear: Optional[str]  # set iff not anonymous
    values: List[int]
    bfs: List[int]
    challenge: int

    def to_bytes(self) -> bytes:
        return dumps(
            {
                "t": self.type_resp,
                "tc": self.type_clear,
                "v": self.values,
                "b": self.bfs,
                "c": self.challenge,
            }
        )

    @classmethod
    def from_bytes(cls, raw: bytes) -> "IssueWF":
        d = loads(raw)
        return cls(d["t"], d["tc"], d["v"], d["b"], d["c"])


class IssueWFProver:
    def __init__(self, witnesses, tokens, anonymous: bool, ped_params, rng=None):
        """witnesses: list of (type, value, bf) triples with common type."""
        self.witnesses = witnesses
        self.tokens = list(tokens)
        self.anonymous = anonymous
        self.pp = list(ped_params)
        self.rng = rng

    def prove(self) -> bytes:
        token_type = self.witnesses[0][0]
        rho_T = _rand(self.rng) if self.anonymous else 0
        Q = hm.g1_mul(self.pp[0], rho_T) if self.anonymous else None
        rho_v = [_rand(self.rng) for _ in self.tokens]
        rho_b = [_rand(self.rng) for _ in self.tokens]
        coms = [
            hm.g1_add(Q, hm.g1_multiexp(self.pp[1:3], [rho_v[i], rho_b[i]]))
            for i in range(len(self.tokens))
        ]
        chal = challenge_issue_wf(coms, self.tokens)
        values = [w[1] for w in self.witnesses]
        bfs = [w[2] for w in self.witnesses]
        return IssueWF(
            type_resp=(
                schnorr.respond([hm.hash_to_zr(token_type.encode())], [rho_T], chal)[0]
                if self.anonymous
                else None
            ),
            type_clear=None if self.anonymous else token_type,
            values=schnorr.respond(values, rho_v, chal),
            bfs=schnorr.respond(bfs, rho_b, chal),
            challenge=chal,
        ).to_bytes()


def challenge_issue_wf(coms, tokens) -> int:
    return hm.hash_to_zr(g1s_bytes(coms, tokens), b"fts/issue-wf")


class IssueWFVerifier:
    def __init__(self, tokens, anonymous: bool, ped_params):
        self.tokens = list(tokens)
        self.anonymous = anonymous
        self.pp = list(ped_params)

    @guard
    def verify(self, raw: bytes) -> None:
        wf = IssueWF.from_bytes(raw)
        if self.anonymous:
            if wf.type_resp is None:
                raise ValueError("invalid issue proof: missing hidden-type response")
            type_resp = wf.type_resp
        else:
            if not wf.type_clear:
                raise ValueError("invalid issue proof: missing clear type")
            # non-anonymous: type randomness is zero, response = c * hash(type)
            type_resp = wf.challenge * hm.hash_to_zr(wf.type_clear.encode()) % hm.R
        if len(wf.values) != len(self.tokens) or len(wf.bfs) != len(self.tokens):
            raise ValueError("invalid issue proof: response count mismatch")
        proofs = [
            schnorr.SchnorrProof(tok, [type_resp, wf.values[i], wf.bfs[i]], wf.challenge)
            for i, tok in enumerate(self.tokens)
        ]
        coms = [schnorr.recompute_commitment(self.pp, pr) for pr in proofs]
        if challenge_issue_wf(coms, self.tokens) != wf.challenge:
            raise ValueError("invalid issue well-formedness proof")
