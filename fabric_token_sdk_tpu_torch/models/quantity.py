"""Arbitrary-precision token quantities (reference `token/token/quantity.go`).

Quantities are non-negative integers bounded by a bit precision; the wire
encoding is a 0x-prefixed hex string.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Quantity:
    value: int
    precision: int

    def __post_init__(self):
        if self.precision == 0 or self.precision > 256:
            raise ValueError(f"invalid precision [{self.precision}]")
        if self.value < 0:
            raise ValueError("quantity must be larger than 0")
        if self.value >= (1 << self.precision):
            raise ValueError(f"quantity exceeds precision [{self.precision}]")

    # ------------------------------------------------------------- codecs

    @classmethod
    def from_uint64(cls, v: int, precision: int = 64) -> "Quantity":
        return cls(v, precision)

    @classmethod
    def from_hex(cls, s: str, precision: int = 64) -> "Quantity":
        if not s.startswith("0x"):
            raise ValueError(f"invalid input [{s}]: missing 0x prefix")
        return cls(int(s, 16), precision)

    @classmethod
    def from_decimal(cls, s: str, precision: int = 64) -> "Quantity":
        return cls(int(s, 10), precision)

    @classmethod
    def zero(cls, precision: int = 64) -> "Quantity":
        return cls(0, precision)

    def hex(self) -> str:
        return hex(self.value)

    def decimal(self) -> str:
        return str(self.value)

    # ------------------------------------------------------------- algebra

    def add(self, other: "Quantity") -> "Quantity":
        return Quantity(self.value + other.value, self.precision)

    def sub(self, other: "Quantity") -> "Quantity":
        if other.value > self.value:
            raise ValueError("failed to subtract: negative result")
        return Quantity(self.value - other.value, self.precision)

    def cmp(self, other: "Quantity") -> int:
        return (self.value > other.value) - (self.value < other.value)

    def is_zero(self) -> bool:
        return self.value == 0

    def __str__(self) -> str:
        return self.decimal()
