"""Pseudonym (nym) signatures: signature of knowledge of (sk, bf) with
NYM = g^sk * h^bf. Reference: `crypto/common/nym.go`.

Token owners in zkatdlog sign transfer requests under fresh pseudonyms;
the auditor can link nyms via audit info.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from . import hostmath as hm, schnorr
from .serialization import guard, dumps, g1s_bytes, loads


@dataclass
class NymSignature:
    challenge: int
    sk_resp: int
    bf_resp: int

    def to_bytes(self) -> bytes:
        return dumps({"c": self.challenge, "s": self.sk_resp, "b": self.bf_resp})

    @classmethod
    def from_bytes(cls, raw: bytes) -> "NymSignature":
        d = loads(raw)
        return cls(d["c"], d["s"], d["b"])


def new_nym(sk: int, nym_params, rng=None) -> Tuple[tuple, int]:
    """Fresh pseudonym for a long-term secret key: returns (NYM, bf)."""
    bf = hm.rand_zr(rng)
    return hm.g1_multiexp(list(nym_params), [sk, bf]), bf


@dataclass
class NymSigner:
    sk: int
    bf: int
    nym: tuple
    nym_params: List[tuple]

    def sign(self, message: bytes, rng=None) -> bytes:
        rho_sk = hm.rand_zr(rng)
        rho_bf = hm.rand_zr(rng)
        com = hm.g1_multiexp(self.nym_params, [rho_sk, rho_bf])
        chal = _challenge(self.nym_params, self.nym, com, message)
        z = schnorr.respond([self.sk, self.bf], [rho_sk, rho_bf], chal)
        return NymSignature(chal, z[0], z[1]).to_bytes()


@dataclass
class NymVerifier:
    nym: tuple
    nym_params: List[tuple]

    @guard
    def verify(self, message: bytes, raw: bytes) -> None:
        sig = NymSignature.from_bytes(raw)
        sp = schnorr.SchnorrProof(self.nym, [sig.sk_resp, sig.bf_resp], sig.challenge)
        com = schnorr.recompute_commitment(self.nym_params, sp)
        if _challenge(self.nym_params, self.nym, com, message) != sig.challenge:
            raise ValueError("invalid nym signature")


def _challenge(nym_params, nym, com, message: bytes) -> int:
    return hm.hash_to_zr(message + g1s_bytes(nym_params, [nym, com]), b"fts/nym")
