"""Token certification: a certifier attests that tokens exist on ledger.

Counterpart of `fabric_token_sdk_tpu/services/certifier/certifier.py`, by copy.

Reference: `token/services/certifier/*` (dummy + interactive drivers) and
`token/certification.go`. Certifications are signatures over (token id,
output bytes) stored in the vault's certification store.
"""

from __future__ import annotations

from typing import Optional

from ...crypto import sign
from ...crypto.serialization import dumps
from ...models.token import ID
from ..network.ledger import Network
from ..vault.vault import Vault


class CertificationService:
    def __init__(self, network: Network, key: Optional[sign.SigningKey] = None, rng=None):
        self.network = network
        self.key = key or sign.keygen(rng)
        self.rng = rng

    @property
    def public_key(self) -> sign.PublicKey:
        return self.key.public

    def certify(self, token_id: ID) -> bytes:
        """Interactive certification: check existence, sign attestation."""
        output = self.network.resolve_input(token_id)  # raises if spent/missing
        payload = dumps({"id": [token_id.tx_id, token_id.index], "out": output})
        return self.key.sign(payload, self.rng)

    def verify(self, token_id: ID, output: bytes, cert: bytes) -> None:
        payload = dumps({"id": [token_id.tx_id, token_id.index], "out": output})
        self.key.public.verify(payload, cert)

    def certify_into(self, vault: Vault, token_id: ID) -> None:
        vault.store_certification(token_id, self.certify(token_id))
