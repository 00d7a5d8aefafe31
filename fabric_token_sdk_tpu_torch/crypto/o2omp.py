"""One-out-of-many proofs (Groth–Kohlweiss) — reference `crypto/o2omp/3omp.go`.

Proves knowledge of (index l, randomness r) such that commitments[l] = h^r
(a commitment to 0), without revealing l. Used for graph-hiding /
serial-number style spend proofs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from . import hostmath as hm
from .serialization import guard, dumps, g1s_bytes, loads


@dataclass
class Proof:
    L: List[tuple]
    A: List[tuple]
    B: List[tuple]
    D: List[tuple]
    vL: List[int]
    vA: List[int]
    vB: List[int]
    vD: int

    def to_bytes(self) -> bytes:
        return dumps(
            {"L": self.L, "A": self.A, "B": self.B, "D": self.D,
             "vl": self.vL, "va": self.vA, "vb": self.vB, "vd": self.vD}
        )

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Proof":
        d = loads(raw)
        return cls(d["L"], d["A"], d["B"], d["D"], d["vl"], d["va"], d["vb"], d["vd"])


def _poly_for_index(j: int, nbits: int, bits_l: List[int], a: List[int]) -> List[int]:
    """Coefficients of prod_i f_{j_i}(x), where f1 = b_i x + a_i and
    f0 = (1-b_i) x - a_i; degree nbits, little-endian coefficients."""
    coeffs = [1]
    for i in range(nbits):
        jbit = (j >> i) & 1
        if jbit:
            alpha, beta = bits_l[i], a[i]
        else:
            alpha, beta = 1 - bits_l[i], -a[i] % hm.R
        # multiply coeffs by (alpha x + beta)
        new = [0] * (len(coeffs) + 1)
        for d, c in enumerate(coeffs):
            new[d] = (new[d] + c * beta) % hm.R
            new[d + 1] = (new[d + 1] + c * alpha) % hm.R
        coeffs = new
    return coeffs


def _challenge(proof_coms, commitments, ped, nbits: int, message: bytes) -> int:
    raw = g1s_bytes(*proof_coms, commitments, ped) + str(nbits).encode() + message
    return hm.hash_to_zr(raw, b"fts/o2omp")


class Prover:
    def __init__(self, commitments, message: bytes, ped, nbits: int, index: int,
                 randomness: int, rng=None):
        self.commitments = list(commitments)
        self.message = message
        self.ped = list(ped)  # 2 bases (g, h)
        self.nbits = nbits
        self.index = index
        self.randomness = randomness
        self.rng = rng

    def prove(self) -> bytes:
        n = self.nbits
        if len(self.commitments) != 1 << n:
            raise ValueError("number of commitments is not 2^bitlength")
        g, h = self.ped
        bits_l = [(self.index >> i) & 1 for i in range(n)]
        a = [hm.rand_zr(self.rng) for _ in range(n)]
        r = [hm.rand_zr(self.rng) for _ in range(n)]
        s = [hm.rand_zr(self.rng) for _ in range(n)]
        t = [hm.rand_zr(self.rng) for _ in range(n)]
        rho = [hm.rand_zr(self.rng) for _ in range(n)]

        L = [
            hm.g1_add(hm.g1_mul(h, r[i]), g if bits_l[i] else None) for i in range(n)
        ]
        A = [hm.g1_multiexp([g, h], [a[i], s[i]]) for i in range(n)]
        B = [
            hm.g1_add(hm.g1_mul(h, t[i]), hm.g1_mul(g, a[i]) if bits_l[i] else None)
            for i in range(n)
        ]
        D = []
        polys = [_poly_for_index(j, n, bits_l, a) for j in range(len(self.commitments))]
        for i in range(n):
            di = hm.g1_mul(h, rho[i])
            for j, cj in enumerate(self.commitments):
                if polys[j][i]:
                    di = hm.g1_add(di, hm.g1_mul(cj, polys[j][i]))
            D.append(di)

        chal = _challenge((L, A, B, D), self.commitments, self.ped, n, self.message)

        vL = [(a[i] + (chal if bits_l[i] else 0)) % hm.R for i in range(n)]
        vA = [(s[i] + r[i] * chal) % hm.R for i in range(n)]
        vB = [(t[i] + r[i] * ((chal - vL[i]) % hm.R)) % hm.R for i in range(n)]
        vD = (self.randomness * pow(chal, n, hm.R) - sum(
            rho[i] * pow(chal, i, hm.R) for i in range(n)
        )) % hm.R
        return Proof(L, A, B, D, vL, vA, vB, vD).to_bytes()


class Verifier:
    def __init__(self, commitments, message: bytes, ped, nbits: int):
        self.commitments = list(commitments)
        self.message = message
        self.ped = list(ped)
        self.nbits = nbits

    @guard
    def verify(self, raw: bytes) -> None:
        n = self.nbits
        if len(self.commitments) != 1 << n:
            raise ValueError("number of commitments is not 2^bitlength")
        p = Proof.from_bytes(raw)
        if any(len(x) != n for x in (p.L, p.A, p.B, p.D, p.vL, p.vA, p.vB)):
            raise ValueError("one-out-of-many proof not well formed")
        g, h = self.ped
        chal = _challenge((p.L, p.A, p.B, p.D), self.commitments, self.ped, n, self.message)
        for i in range(n):
            # L_i^c * A_i == g^{vL_i} h^{vA_i}
            lhs = hm.g1_add(hm.g1_mul(p.L[i], chal), p.A[i])
            if lhs != hm.g1_multiexp([g, h], [p.vL[i], p.vA[i]]):
                raise ValueError("one-out-of-many proof: first equation failed")
            # L_i^{c - vL_i} * B_i == h^{vB_i}
            lhs = hm.g1_add(hm.g1_mul(p.L[i], (chal - p.vL[i]) % hm.R), p.B[i])
            if lhs != hm.g1_mul(h, p.vB[i]):
                raise ValueError("one-out-of-many proof: second equation failed")
        acc = None
        for j, cj in enumerate(self.commitments):
            f = 1
            for i in range(n):
                f = f * (p.vL[i] if (j >> i) & 1 else (chal - p.vL[i])) % hm.R
            acc = hm.g1_add(acc, hm.g1_mul(cj, f))
        for i in range(n):
            acc = hm.g1_add(acc, hm.g1_neg(hm.g1_mul(p.D[i], pow(chal, i, hm.R))))
        if acc != hm.g1_mul(h, p.vD):
            raise ValueError("one-out-of-many proof: third equation failed")
