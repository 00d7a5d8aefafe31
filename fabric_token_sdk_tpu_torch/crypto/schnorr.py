"""Schnorr sigma-protocol core: multi-witness proofs over Pedersen bases.

Reference: `crypto/common/schnorr.go` — Prove (p_i = r_i + c*w_i),
RecomputeCommitment (com = prod P_i^{p_i} / Statement^c), ComputeChallenge.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from . import hostmath as hm


@dataclass
class SchnorrProof:
    """ZK proof of knowledge of (w_1..w_n): statement = prod P_i^{w_i}."""

    statement: tuple  # G1
    responses: List[int]  # Zr
    challenge: int  # Zr


def respond(witnesses: Sequence[int], randomness: Sequence[int], challenge: int) -> List[int]:
    """p_i = r_i + c*w_i mod r (reference schnorr.go:36-56)."""
    if len(witnesses) != len(randomness):
        raise ValueError("schnorr: witness/randomness length mismatch")
    return [(r + challenge * w) % hm.R for w, r in zip(witnesses, randomness)]


def recompute_commitment(bases: Sequence, proof: SchnorrProof):
    """com = prod bases[i]^{responses[i]} - statement*challenge.

    This is the verifier's reconstruction of the prover's randomness
    commitment (reference schnorr.go:78-104).
    """
    if len(proof.responses) > len(bases):
        raise ValueError("schnorr: more responses than bases")
    com = hm.g1_multiexp(list(bases[: len(proof.responses)]), proof.responses)
    return hm.g1_add(com, hm.g1_neg(hm.g1_mul(proof.statement, proof.challenge)))


def commit_randomness(bases: Sequence, randomness: Sequence[int]):
    """Prover side: commitment to fresh randomness."""
    return hm.g1_multiexp(list(bases[: len(randomness)]), list(randomness))


def recompute_commitments(bases_rows: Sequence[Sequence],
                          proofs: Sequence[SchnorrProof]) -> List:
    """Batch `recompute_commitment` over many proofs.

    Each proof folds into ONE multiexp row — (bases..., statement) against
    (responses..., -challenge), the statement negation riding the scalar —
    which is the same group element the scalar helper assembles from
    multiexp + add. All rows then go down in single native dispatches via
    `hm.g1_multiexp_rows` instead of one ctypes round trip per proof.
    """
    if len(bases_rows) != len(proofs):
        raise ValueError("schnorr: bases/proofs length mismatch")
    rows_p, rows_s = [], []
    for bases, proof in zip(bases_rows, proofs):
        if len(proof.responses) > len(bases):
            raise ValueError("schnorr: more responses than bases")
        rows_p.append(list(bases[: len(proof.responses)]) + [proof.statement])
        rows_s.append(list(proof.responses) + [(-proof.challenge) % hm.R])
    return hm.g1_multiexp_rows(rows_p, rows_s)
