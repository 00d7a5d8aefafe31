"""Issue action proof: well-formedness + range correctness.

Reference: `crypto/issue/issue.go` (Issue action + proof composition),
`crypto/issue/issuer.go` (anonymous issuer), `crypto/issue/nonanonym/`
(issuer identity in the clear).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from . import rangeproof, wellformedness as wf
from .setup import PublicParams
from .serialization import guard, dumps, loads
from .token import TokenDataWitness


@dataclass
class IssueProof:
    wf: bytes
    range_correctness: Optional[bytes]

    def to_bytes(self) -> bytes:
        return dumps({"wf": self.wf, "rc": self.range_correctness})

    @classmethod
    def from_bytes(cls, raw: bytes) -> "IssueProof":
        d = loads(raw)
        return cls(d["wf"], d["rc"])


class IssueProver:
    def __init__(
        self,
        witnesses: Sequence[TokenDataWitness],
        tokens,
        anonymous: bool,
        pp: PublicParams,
        rng=None,
    ):
        self.wf_prover = wf.IssueWFProver(
            [(w.token_type, w.value, w.bf) for w in witnesses],
            tokens,
            anonymous,
            pp.ped_params,
            rng,
        )
        rp = pp.range_params
        self.range_prover = rangeproof.RangeProver(
            [rangeproof.TokenWitness(w.token_type, w.value, w.bf) for w in witnesses],
            tokens,
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
        return IssueProof(
            wf=self.wf_prover.prove(), range_correctness=self.range_prover.prove()
        ).to_bytes()


class IssueVerifier:
    def __init__(self, tokens, anonymous: bool, pp: PublicParams):
        self.wf_verifier = wf.IssueWFVerifier(tokens, anonymous, pp.ped_params)
        rp = pp.range_params
        self.range_verifier = rangeproof.RangeVerifier(
            tokens, rp.base, rp.exponent, pp.ped_params, rp.sign_pk, pp.ped_gen, rp.Q
        )

    @guard
    def verify(self, raw: bytes) -> None:
        proof = IssueProof.from_bytes(raw)
        self.wf_verifier.verify(proof.wf)
        if proof.range_correctness is None:
            raise ValueError("invalid issue proof: missing range proof")
        self.range_verifier.verify(proof.range_correctness)
