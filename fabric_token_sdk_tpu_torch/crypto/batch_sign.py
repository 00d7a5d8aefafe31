"""Batched Schnorr signature verification on the GPU: the sign-side twin
of the batched proof planes.

Counterpart of `fabric_token_sdk_tpu/crypto/batch_sign.py`. A whole
block's signature checks verify as ONE flat-row pass of the G1 stages:

    com_i = g^{z_i} · pk_i^{-c_i}

the fixed-base multiexp over the generator's 1-base table for g^z, the
variable-base `g1_mul` for pk^c and the Jacobian sub: the composition of
`parallel/sharding.py:sharded_schnorr_rows`, spread over the row groups
of a mesh when the verifier has one. The responses and challenges
are public, so the gather form of the multiexp serves, as in the proof
verifiers. The Fiat-Shamir challenge is rebound on the host through
`sign.challenge`, as every batched verifier does.

Verdict contract (the reference's): True or False for each row whose
signature blob parsed, None for a blob that does not parse or that
carries a non-integer or bool `c` or `z` (the host path reports the
precise error). For parsed rows the verdict equals `PublicKey.verify`:
the canonical scalar encoding reduces mod R as the host `g1_mul` does,
and the response equation is `sign.response_commitment`'s.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from . import hostmath as hm, sign
from .batch import _spanned, _upload, resolve_device
from .serialization import loads
from ..ops import curve as cv
from ..parallel.sharding import DeviceMesh, MeshBound, schnorr_rows
from ..utils import metrics as mx


class BatchedSchnorrVerifier(MeshBound):
    """Verifies B long-term Schnorr signatures through the G1 stages.

    Rows are `(pk_point, message, sig_raw)`: the public-key point, the
    exact message bytes the host path would verify, and the raw
    signature blob. The generator's 1-base window table is a device
    buffer, built once per verifier. Bound to a `DeviceMesh` (`mesh=`,
    `set_mesh`) the rows run over its row groups, each on its own device
    with the table copied there when the mesh is bound (the composition
    of `sharded_schnorr_rows`); the verdicts do not change."""

    def __init__(self, device=None, mesh: Optional[DeviceMesh] = None):
        self.device = resolve_device(device)
        self.table = cv.FixedBaseTable([hm.G1_GEN]).to(self.device)
        self.set_mesh(mesh)

    def _mesh_tables(self) -> tuple:
        return (self.table.table,)

    @_spanned("batch.sign.verify")
    def verify(self, rows: Sequence[Tuple[object, bytes, bytes]]) -> List[Optional[bool]]:
        """-> per-row verdicts: True/False, None when the signature blob
        did not parse. Raises only on device failures."""
        B = len(rows)
        if B == 0:
            return []
        mx.counter("batch.sign.batches").inc()
        parsed: List[Optional[Tuple[int, int]]] = []
        for _pk, _msg, sig_raw in rows:
            try:
                d = loads(sig_raw)
                chal, resp = d["c"], d["z"]
                if (not isinstance(chal, int) or isinstance(chal, bool)
                        or not isinstance(resp, int) or isinstance(resp, bool)):
                    raise ValueError("non-integer signature fields")
                parsed.append((chal, resp))
            except Exception:
                parsed.append(None)  # the host path reports the precise error
        live = [i for i in range(B) if parsed[i] is not None]
        verdicts: List[Optional[bool]] = [None] * B
        if not live:
            return verdicts
        dev = self.device
        # flat rows: com = g^z - pk^c
        resp = cv.encode_scalars([parsed[i][1] for i in live])[:, None, :]
        chal = cv.encode_scalars([parsed[i][0] for i in live])
        pks = cv.encode_points([rows[i][0] for i in live])
        coms = self._run(schnorr_rows, _upload(resp, dev), _upload(pks, dev), _upload(chal, dev),
                         consts=(self.table.table,))
        com_pts = cv.decode_points(coms.cpu().numpy())
        # counted on completion only: a device failure above raises first
        mx.counter("batch.sign.rows").inc(len(live))
        for j, i in enumerate(live):
            pk_point, message, _sig = rows[i]
            verdicts[i] = sign.challenge(pk_point, com_pts[j], message) == parsed[i][0]
        return verdicts
