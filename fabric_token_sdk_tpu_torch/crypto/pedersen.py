"""Pedersen vector commitments: the host path and the batched one on
the card.

Reference: `crypto/common/zkproof.go` ComputePedersenCommitment and the
token commitment computation in `crypto/token/token.go:64-76` (token data =
commit(hash(type), value; bf) over PedParams).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import hostmath as hm
from ..ops import curve as cv, limbs as lb, stages as st
from ..parallel.sharding import DeviceMesh, MeshBound


def commit(openings: Sequence[int], bases: Sequence, curve=None):
    """Host: com = prod bases[i]^openings[i]."""
    if len(openings) != len(bases):
        raise ValueError(f"pedersen commit: {len(openings)} openings vs {len(bases)} bases")
    return hm.g1_multiexp(list(bases), [o % hm.R for o in openings])


class BatchedPedersen(MeshBound, torch.nn.Module):
    """Batched fixed-base committer: B commitments over the same bases in
    one `g1_msm_select` launch (counterpart of the JAX package's
    `crypto/pedersen.py:BatchedPedersen`, the commit engine of the batched
    transfer prover). The openings are secret, so every method goes
    through the select form of the multiexp, never the gather. The
    window table is a submodule buffer: `.to(device)` moves it, and the
    commitments are computed where it lies. Bound to a mesh
    (`set_mesh`, after any `.to`), a commitment batch runs one launch a
    row group, the table copied to each of the mesh's devices when it is
    bound; the select form is constant-time in the digits on every row
    group alike."""

    def __init__(self, bases: Sequence, mesh: Optional[DeviceMesh] = None):
        super().__init__()
        self.bases = list(bases)
        self.table = cv.FixedBaseTable(self.bases)
        self.set_mesh(mesh)

    @property
    def device(self) -> torch.device:
        return self.table.table.device

    def _mesh_tables(self) -> tuple:
        return (self.table.table,)

    def commit_rows(self, scalars: torch.Tensor) -> torch.Tensor:
        """Canonical scalar words (N, nbases, 8) on the table's device ->
        (N, 3, 8) Jacobian words there, over the bound mesh's row groups."""
        return self._run(st.g1_msm_select_rows, scalars, consts=(self.table.table,))

    def commit_ints(self, openings_rows: Sequence[Sequence[int]]):
        """Host int rows -> (host points, Jacobian words on the device):
        one encode and upload, one launch, one copy back and host decode."""
        rows = list(openings_rows)
        flat = cv.encode_scalars([s for row in rows for s in row])
        scalars = torch.from_numpy(flat.reshape(len(rows), len(self.bases), lb.NWORDS))
        jac = self.commit_rows(scalars.to(self.device))
        return cv.decode_points(jac.cpu().numpy()), jac

    def commit_batch(self, openings_rows: Sequence[Sequence[int]]) -> list:
        """Rows of per-base openings -> list of host G1 points."""
        return self.commit_ints(openings_rows)[0]

    def commit_device(self, scalars: torch.Tensor) -> torch.Tensor:
        """Scalars (..., nbases, 8) -> points (..., 3, 8): the reference's
        fused entry point, here the same single launch over the flattened
        leading axes."""
        lead = tuple(scalars.shape[:-2])
        flat = scalars.reshape((-1,) + tuple(scalars.shape[-2:])).contiguous()
        return self.commit_rows(flat).reshape(lead + (3, lb.NWORDS))


def token_commitment(token_type: str, value: int, bf: int, ped_params: Sequence):
    """Commitment to (hash(type), value; blinding) — TokenData.

    Reference: token/token.go:68-69.
    """
    return commit([hm.hash_to_zr(token_type.encode()), value, bf], ped_params)
