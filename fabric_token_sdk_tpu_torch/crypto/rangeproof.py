"""Range proofs via PS-signed digit set-membership (reference `crypto/range/proof.go`).

Shows each token value v satisfies 0 <= v < base^exponent:
  v = sum_i d_i * base^i, each digit committed separately, each digit proven
  to carry a PS signature from the public signed set {0..base-1}
  (membership proofs), plus an equality sigma proof tying the token
  commitment to the digit commitments.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from . import hostmath as hm, pssign, schnorr, sigproof
from .serialization import guard, dumps, g1s_bytes, g2s_bytes, loads


@dataclass
class TokenWitness:
    token_type: str
    value: int
    bf: int


@dataclass
class RangeProof:
    challenge: int
    type_resp: int
    value_resps: List[int]
    token_bf_resps: List[int]
    com_bf_resps: List[int]
    # per token: list of digit commitments + their membership proofs
    digit_commitments: List[List[tuple]]
    membership_proofs: List[List[sigproof.MembershipProof]]

    def to_bytes(self) -> bytes:
        return dumps(
            {
                "c": self.challenge,
                "t": self.type_resp,
                "v": self.value_resps,
                "tb": self.token_bf_resps,
                "cb": self.com_bf_resps,
                "dc": self.digit_commitments,
                "mp": [
                    [m.to_bytes() for m in row] for row in self.membership_proofs
                ],
            }
        )

    @classmethod
    def from_bytes(cls, raw: bytes) -> "RangeProof":
        d = loads(raw)
        mps = [
            [sigproof.MembershipProof.from_bytes(m) for m in row] for row in d["mp"]
        ]
        return cls(d["c"], d["t"], d["v"], d["tb"], d["cb"], d["dc"], mps)


def decompose(value: int, base: int, exponent: int) -> List[int]:
    """v -> little-endian digits; raises if out of range."""
    if not 0 <= value < base**exponent:
        raise ValueError("value of token outside authorized range")
    digits = []
    v = value
    for _ in range(exponent):
        digits.append(v % base)
        v //= base
    return digits


class RangeVerifier:
    def __init__(self, tokens, base, exponent, ped_params, pk, P, Q):
        self.tokens = list(tokens)
        self.base = base
        self.exponent = exponent
        self.ped = list(ped_params)  # 3 bases (type, value, bf)
        self.pk = list(pk)  # 3 G2 (PS key for 1 message)
        self.P = P
        self.Q = Q

    def _challenge(self, com_tokens, com_values, digit_commitments) -> int:
        raw = g1s_bytes([self.P], self.tokens, com_tokens, com_values, self.ped)
        raw += g2s_bytes([self.Q], self.pk)
        for row in digit_commitments:
            raw += g1s_bytes(row)
        return hm.hash_to_zr(raw, b"fts/range")

    @guard
    def verify(self, raw: bytes) -> None:
        p = RangeProof.from_bytes(raw)
        n = len(self.tokens)
        if (
            len(p.membership_proofs) != n
            or len(p.digit_commitments) != n
            or len(p.value_resps) != n
            or len(p.token_bf_resps) != n
            or len(p.com_bf_resps) != n
        ):
            raise ValueError("range proof not well formed")
        # 1. each digit commitment carries a signed (in-range) value
        for k in range(n):
            if len(p.digit_commitments[k]) != self.exponent:
                raise ValueError("range proof not well formed")
            if len(p.membership_proofs[k]) != self.exponent:
                raise ValueError("range proof not well formed")
            for i in range(self.exponent):
                mv = sigproof.MembershipVerifier(
                    p.digit_commitments[k][i], self.P, self.Q, self.pk, self.ped[:2]
                )
                mv.verify(p.membership_proofs[k][i])
        # 2. equality proofs: token opens to (type, v, bf) with
        #    v = sum digits * base^i
        com_tokens = []
        com_values = []
        for k in range(n):
            sp = schnorr.SchnorrProof(
                self.tokens[k],
                [p.type_resp, p.value_resps[k], p.token_bf_resps[k]],
                p.challenge,
            )
            com_tokens.append(schnorr.recompute_commitment(self.ped, sp))
            agg = hm.g1_multiexp(
                p.digit_commitments[k],
                [self.base**i % hm.R for i in range(self.exponent)],
            )
            sp2 = schnorr.SchnorrProof(
                agg, [p.value_resps[k], p.com_bf_resps[k]], p.challenge
            )
            com_values.append(schnorr.recompute_commitment(self.ped[:2], sp2))
        if self._challenge(com_tokens, com_values, p.digit_commitments) != p.challenge:
            raise ValueError("invalid range proof")


@dataclass
class RangeDraw:
    """Witness decomposition + commit-phase randomness of one range proof.

    Drawn once, then consumed by either the host commit path
    (`RangeProver.prove`) or the batched device commit path
    (`crypto/batch_prove.py`); the response phase (`RangeProver.finish`)
    is shared, so device proving can only accelerate — never change —
    the emitted proof distribution.
    """

    digits: List[List[int]]  # per token: little-endian digits
    digit_bfs: List[List[int]]  # per (token, digit): commitment blinding
    mem: List[List[sigproof.MembershipDraw]]  # per (token, digit)
    rho_T: int
    rho_v: List[int]
    rho_tb: List[int]
    rho_cb: List[int]
    agg_bfs: List[int]  # per token: sum bf_i * base^i

    def equality_token_rows(self) -> List[List[int]]:
        """Scalar rows of the per-token equality commitments over the 3
        Pedersen bases (host `g1_multiexp` / device `g1_msm3` tile)."""
        return [
            [self.rho_T, self.rho_v[k], self.rho_tb[k]]
            for k in range(len(self.digits))
        ]

    def equality_value_rows(self) -> List[List[int]]:
        """Scalar rows of the per-token digit-aggregate commitments over
        ped[:2] (host `g1_multiexp` / device `g1_msm2` tile)."""
        return [
            [self.rho_v[k], self.rho_cb[k]] for k in range(len(self.digits))
        ]


class RangeProver(RangeVerifier):
    def __init__(
        self, witnesses: Sequence[TokenWitness], tokens, signatures, base, exponent,
        ped_params, pk, P, Q, rng=None,
    ):
        super().__init__(tokens, base, exponent, ped_params, pk, P, Q)
        self.witnesses = list(witnesses)
        self.signatures = list(signatures)  # PS signatures on 0..base-1
        self.rng = rng

    def draw(self) -> RangeDraw:
        n = len(self.tokens)
        digits = [
            decompose(self.witnesses[k].value, self.base, self.exponent)
            for k in range(n)
        ]
        digit_bfs = [
            [hm.rand_zr(self.rng) for _ in range(self.exponent)] for _ in range(n)
        ]
        mem = [
            [sigproof.membership_draw(self.rng) for _ in range(self.exponent)]
            for _ in range(n)
        ]
        agg_bfs = [
            sum(
                digit_bfs[k][i] * (self.base**i) for i in range(self.exponent)
            ) % hm.R
            for k in range(n)
        ]
        return RangeDraw(
            digits=digits,
            digit_bfs=digit_bfs,
            mem=mem,
            rho_T=hm.rand_zr(self.rng),
            rho_v=[hm.rand_zr(self.rng) for _ in range(n)],
            rho_tb=[hm.rand_zr(self.rng) for _ in range(n)],
            rho_cb=[hm.rand_zr(self.rng) for _ in range(n)],
            agg_bfs=agg_bfs,
        )

    def finish(
        self, d: RangeDraw, digit_coms: List[List[tuple]],
        mem_proofs: List[List[sigproof.MembershipProof]], chal: int,
    ) -> bytes:
        type_hash = hm.hash_to_zr(self.witnesses[0].token_type.encode())
        return RangeProof(
            challenge=chal,
            type_resp=schnorr.respond([type_hash], [d.rho_T], chal)[0],
            value_resps=schnorr.respond([w.value for w in self.witnesses], d.rho_v, chal),
            token_bf_resps=schnorr.respond([w.bf for w in self.witnesses], d.rho_tb, chal),
            com_bf_resps=schnorr.respond(d.agg_bfs, d.rho_cb, chal),
            digit_commitments=digit_coms,
            membership_proofs=mem_proofs,
        ).to_bytes()

    def prove(self) -> bytes:
        n = len(self.tokens)
        d = self.draw()
        digit_coms: List[List[tuple]] = []
        mem_proofs: List[List[sigproof.MembershipProof]] = []
        for k in range(n):
            row_coms, row_proofs = [], []
            for i, dig in enumerate(d.digits[k]):
                bf = d.digit_bfs[k][i]
                com = hm.g1_multiexp(self.ped[:2], [dig, bf])
                w = sigproof.MembershipWitness(self.signatures[dig], dig, bf)
                mp = sigproof.MembershipProver(
                    w, com, self.P, self.Q, self.pk, self.ped[:2], self.rng
                )
                row_coms.append(com)
                row_proofs.append(mp.prove(d.mem[k][i]))
            digit_coms.append(row_coms)
            mem_proofs.append(row_proofs)

        # equality sigma proof
        com_tokens = [
            hm.g1_multiexp(self.ped, row) for row in d.equality_token_rows()
        ]
        com_values = [
            hm.g1_multiexp(self.ped[:2], row) for row in d.equality_value_rows()
        ]
        chal = self._challenge(com_tokens, com_values, digit_coms)
        return self.finish(d, digit_coms, mem_proofs, chal)
