"""zkatdlog token data: Pedersen-committed (type, value) + owner.

Reference: `crypto/token/token.go` — Token{Owner, Data}, Metadata openings,
GetTokensWithWitness, GetTokenInTheClear.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from . import hostmath as hm, pedersen
from .serialization import dumps, loads


@dataclass
class Token:
    """On-ledger token: owner identity bytes + commitment to (type, value)."""

    owner: bytes
    data: tuple  # G1 commitment

    def is_redeem(self) -> bool:
        return len(self.owner) == 0

    def to_bytes(self) -> bytes:
        return dumps({"o": self.owner, "d": self.data})

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Token":
        d = loads(raw)
        return cls(d["o"], d["d"])


@dataclass
class Metadata:
    """Opening of a token commitment, shared off-chain with owner/auditor."""

    token_type: str
    value: int
    bf: int
    owner: bytes = b""
    issuer: bytes = b""

    def to_bytes(self) -> bytes:
        return dumps(
            {"t": self.token_type, "v": self.value, "b": self.bf, "o": self.owner, "i": self.issuer}
        )

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Metadata":
        d = loads(raw)
        return cls(d["t"], d["v"], d["b"], d["o"], d["i"])


@dataclass
class TokenDataWitness:
    token_type: str
    value: int
    bf: int


def compute_tokens(witnesses: Sequence[TokenDataWitness], ped_params) -> List[tuple]:
    """Commitments for a batch of witnesses (reference token.go:64-76)."""
    return [
        pedersen.token_commitment(w.token_type, w.value, w.bf, ped_params)
        for w in witnesses
    ]


def tokens_with_witness(
    values: Sequence[int], token_type: str, ped_params, rng=None
) -> Tuple[List[tuple], List[TokenDataWitness]]:
    """Fresh blinded commitments for given values (reference token.go:78-98)."""
    witnesses = [
        TokenDataWitness(token_type, v, hm.rand_zr(rng)) for v in values
    ]
    return compute_tokens(witnesses, ped_params), witnesses


def token_in_the_clear(token: Token, meta: Metadata, ped_params) -> Tuple[str, int, bytes]:
    """Open a token against its metadata; raises on mismatch
    (reference token.go:48-62)."""
    com = pedersen.token_commitment(meta.token_type, meta.value, meta.bf, ped_params)
    if com != token.data:
        raise ValueError("cannot retrieve token in the clear: output does not match provided opening")
    return meta.token_type, meta.value, token.owner
