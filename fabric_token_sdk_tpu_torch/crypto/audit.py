"""Auditing of zkatdlog tokens (reference `crypto/audit/auditor.go`).

The auditor receives token openings (audit info) alongside actions,
recomputes every commitment, inspects owners, and signs the request.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from . import hostmath as hm, pedersen
from .token import Metadata, Token


@dataclass
class TokenDataOpening:
    token_type: str
    value: int
    bf: int


@dataclass
class OwnerOpening:
    owner_info: bytes


@dataclass
class AuditableToken:
    token: Token
    data: TokenDataOpening
    owner: OwnerOpening


def auditable_token(token: Token, owner_info: bytes, token_type: str, value: int, bf: int) -> AuditableToken:
    return AuditableToken(
        token=token,
        data=TokenDataOpening(token_type, value, bf),
        owner=OwnerOpening(owner_info),
    )


class Auditor:
    """Checks openings against commitments and endorses token requests."""

    def __init__(self, ped_params, signer=None, inspect_owner: Optional[Callable] = None):
        self.ped_params = list(ped_params)
        self.signer = signer
        self.inspect_owner = inspect_owner

    def check_token(self, at: AuditableToken) -> None:
        com = pedersen.token_commitment(
            at.data.token_type, at.data.value, at.data.bf, self.ped_params
        )
        if com != at.token.data:
            raise ValueError("audit check failed: opening does not match token commitment")
        if self.inspect_owner is not None and not at.token.is_redeem():
            self.inspect_owner(at)

    def check(self, inputs: Sequence[AuditableToken], outputs: Sequence[AuditableToken]) -> None:
        for at in list(inputs) + list(outputs):
            self.check_token(at)

    def endorse(self, request_bytes: bytes, rng=None) -> bytes:
        """Sign an audited request (reference auditor.go Endorse)."""
        if self.signer is None:
            raise ValueError("auditor has no signing identity")
        return self.signer.sign(request_bytes, rng)
