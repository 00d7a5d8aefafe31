"""Clear-text token model (reference `token/token/token.go`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .quantity import Quantity
from ..crypto.serialization import dumps, loads


@dataclass(frozen=True)
class ID:
    """(creating tx, output index) — unique token identity."""

    tx_id: str
    index: int

    def __str__(self) -> str:
        return f"[{self.tx_id}:{self.index}]"

    def key(self) -> str:
        return f"{self.tx_id}.{self.index}"


@dataclass(frozen=True)
class Owner:
    raw: bytes  # serialized owner identity (or script)


@dataclass
class Token:
    """Result of issue/transfer: owner + type + hex-encoded quantity."""

    owner: Owner
    type: str
    quantity: str  # 0x-hex

    def quantity_as(self, precision: int = 64) -> Quantity:
        return Quantity.from_hex(self.quantity, precision)

    def to_bytes(self) -> bytes:
        return dumps({"o": self.owner.raw, "t": self.type, "q": self.quantity})

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Token":
        d = loads(raw)
        return cls(Owner(d["o"]), d["t"], d["q"])


@dataclass
class UnspentToken:
    id: ID
    owner: Owner
    type: str
    quantity: str  # decimal string (reference parity)


@dataclass
class IssuedToken:
    id: ID
    owner: Owner
    type: str
    quantity: str
    issuer: Optional[Owner] = None


def sum_quantities(tokens: List[Token], precision: int = 64) -> Quantity:
    total = Quantity.zero(precision)
    for t in tokens:
        total = total.add(t.quantity_as(precision))
    return total
