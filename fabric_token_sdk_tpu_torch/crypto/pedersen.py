"""Pedersen vector commitments: the host half.

Reference: `crypto/common/zkproof.go` ComputePedersenCommitment and the
token commitment computation in `crypto/token/token.go:64-76` (token data =
commit(hash(type), value; bf) over PedParams).
"""

from __future__ import annotations

from typing import Sequence

from . import hostmath as hm


def commit(openings: Sequence[int], bases: Sequence, curve=None):
    """Host: com = prod bases[i]^openings[i]."""
    if len(openings) != len(bases):
        raise ValueError(f"pedersen commit: {len(openings)} openings vs {len(bases)} bases")
    return hm.g1_multiexp(list(bases), [o % hm.R for o in openings])


def token_commitment(token_type: str, value: int, bf: int, ped_params: Sequence):
    """Commitment to (hash(type), value; blinding) — TokenData.

    Reference: token/token.go:68-69.
    """
    return commit([hm.hash_to_zr(token_type.encode()), value, bf], ped_params)
