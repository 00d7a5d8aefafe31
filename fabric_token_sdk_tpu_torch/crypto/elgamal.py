"""ElGamal encryption over G1 (reference: `crypto/elgamal/enc.go`).

Used for audit info and for PS blind-signing requests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from . import hostmath as hm


@dataclass
class Ciphertext:
    c1: tuple  # G1
    c2: tuple  # G1


@dataclass
class PublicKey:
    gen: tuple  # G1 generator g
    h: tuple  # g^x

    def encrypt(self, m, rng=None) -> Tuple[Ciphertext, int]:
        """Encrypt a G1 point; returns (ciphertext, randomness)."""
        r = hm.rand_zr(rng)
        return Ciphertext(hm.g1_mul(self.gen, r), hm.g1_add(m, hm.g1_mul(self.h, r))), r

    def encrypt_zr(self, m: int, base, rng=None) -> Tuple[Ciphertext, int]:
        """Encrypt a scalar as base^m (exponential ElGamal)."""
        return self.encrypt(hm.g1_mul(base, m), rng)


@dataclass
class SecretKey:
    x: int
    pk: PublicKey

    def decrypt(self, c: Ciphertext):
        return hm.g1_add(c.c2, hm.g1_neg(hm.g1_mul(c.c1, self.x)))


def keygen(gen=None, rng=None) -> SecretKey:
    gen = gen if gen is not None else hm.G1_GEN
    x = hm.rand_zr(rng)
    return SecretKey(x, PublicKey(gen, hm.g1_mul(gen, x)))
