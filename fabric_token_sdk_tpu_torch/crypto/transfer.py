"""Transfer action proof: well-formedness + range correctness.

Reference: `crypto/transfer/transfer.go` (Prover/Verifier composition; the
range proof is skipped for 1-in-1-out ownership transfers) and
`crypto/transfer/sender.go` (action assembly).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from . import hostmath as hm, rangeproof, wellformedness as wf
from .setup import PublicParams
from .serialization import guard, dumps, loads
from .token import TokenDataWitness
from ..utils import metrics as mx


@dataclass
class TransferProof:
    wf: bytes
    range_correctness: Optional[bytes]

    def to_bytes(self) -> bytes:
        return dumps({"wf": self.wf, "rc": self.range_correctness})

    @classmethod
    def from_bytes(cls, raw: bytes) -> "TransferProof":
        d = loads(raw)
        return cls(d["wf"], d["rc"])


def _skip_range(n_in: int, n_out: int) -> bool:
    # ownership transfer: single input, single output, conservation is
    # enough (reference transfer.go:55-59)
    return n_in == 1 and n_out == 1


class TransferProver:
    def __init__(
        self,
        in_witnesses: Sequence[TokenDataWitness],
        out_witnesses: Sequence[TokenDataWitness],
        inputs,
        outputs,
        pp: PublicParams,
        rng=None,
    ):
        self.wf_prover = wf.TransferWFProver(
            wf.TransferWFWitness(
                token_type=in_witnesses[0].token_type,
                in_values=[w.value for w in in_witnesses],
                in_bfs=[w.bf for w in in_witnesses],
                out_values=[w.value for w in out_witnesses],
                out_bfs=[w.bf for w in out_witnesses],
            ),
            pp.ped_params,
            inputs,
            outputs,
            rng,
        )
        self.range_prover = None
        if not _skip_range(len(inputs), len(outputs)):
            rp = pp.range_params
            self.range_prover = rangeproof.RangeProver(
                [rangeproof.TokenWitness(w.token_type, w.value, w.bf) for w in out_witnesses],
                outputs,
                rp.signed_values,
                rp.base,
                rp.exponent,
                pp.ped_params,
                rp.sign_pk,
                pp.ped_gen,
                rp.Q,
                rng,
            )

    def prove(self) -> bytes:
        # total proves = path.native + path.python
        mx.counter(
            "transfer.prove.path.native" if hm.NATIVE_G1
            else "transfer.prove.path.python"
        ).inc()
        with mx.span("transfer.prove"):
            return TransferProof(
                wf=self.wf_prover.prove(),
                range_correctness=self.range_prover.prove() if self.range_prover else None,
            ).to_bytes()


class TransferVerifier:
    def __init__(self, inputs, outputs, pp: PublicParams):
        self.wf_verifier = wf.TransferWFVerifier(pp.ped_params, inputs, outputs)
        self.range_verifier = None
        if not _skip_range(len(inputs), len(outputs)):
            rp = pp.range_params
            self.range_verifier = rangeproof.RangeVerifier(
                outputs, rp.base, rp.exponent, pp.ped_params, rp.sign_pk, pp.ped_gen, rp.Q
            )

    @guard
    def verify(self, raw: bytes) -> None:
        mx.counter("transfer.verify.count").inc()
        with mx.span("transfer.verify"):
            proof = TransferProof.from_bytes(raw)
            self.wf_verifier.verify(proof.wf)
            if self.range_verifier is not None:
                if proof.range_correctness is None:
                    raise ValueError("invalid transfer proof: missing range proof")
                self.range_verifier.verify(proof.range_correctness)


def verify_transfer_proofs(specs, pp: PublicParams) -> List[Optional[bool]]:
    """Host-batched transfer proof verification.

    `specs` are (inputs, outputs, raw_proof) triples. Only range-skipped
    shapes (1-in/1-out ownership transfers, the shape that dominates
    traffic) are batch-decidable — for those the WF challenge compare IS
    the whole accept/reject decision, so a True here is exactly a
    `TransferVerifier.verify` accept. Shapes that carry a range proof, and
    proofs the batch cannot parse, return None: degrade-only, the scalar
    verifier re-runs them and owns the precise error.
    """
    specs = list(specs)
    out: List[Optional[bool]] = [None] * len(specs)
    wf_specs, idxs = [], []
    for i, (inputs, outputs, raw) in enumerate(specs):
        if not _skip_range(len(inputs), len(outputs)):
            continue
        try:
            proof = TransferProof.from_bytes(raw)
        except Exception:
            continue
        wf_specs.append((inputs, outputs, proof.wf))
        idxs.append(i)
    if not wf_specs:
        return out
    for i, v in zip(idxs, wf.verify_transfer_wfs(pp.ped_params, wf_specs)):
        out[i] = v
    return out
