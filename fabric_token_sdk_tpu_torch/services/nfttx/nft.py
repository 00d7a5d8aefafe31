"""Non-fungible tokens: unique unit-value tokens carrying JSON state.

Counterpart of `fabric_token_sdk_tpu/services/nfttx/nft.py`, by copy.

Reference: `token/services/nfttx/*` (uuid.go, state.go, marshaller, qe.go).
An NFT is a quantity-1 token whose type encodes a unique id + the state's
hash; the JSON state itself travels in request application metadata and is
queryable from the owner's vault.
"""

from __future__ import annotations

import hashlib
import json
import uuid as uuid_mod
from typing import Any, Dict, List, Optional

from ..ttx.party import Party
from ..ttx.transaction import Transaction

NFT_PREFIX = "nft."


def _state_key(state: Dict[str, Any]) -> str:
    canonical = json.dumps(state, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canonical.encode()).hexdigest()[:16]


class NFTService:
    """Issue/transfer/query unique tokens for a party."""

    def __init__(self, party: Party):
        self.party = party

    def issue(self, issuer_wallet: str, state: Dict[str, Any], recipient: bytes,
              auditor=None, tx_id: Optional[str] = None) -> str:
        """Mint a unique token for `state`; returns its token type."""
        unique = uuid_mod.uuid4().hex
        token_type = f"{NFT_PREFIX}{unique}.{_state_key(state)}"
        tx = Transaction(self.party, tx_id)
        tx.issue(issuer_wallet, token_type, [1], [recipient], anonymous=False)
        tx.request.set_application_metadata(
            f"nft.{token_type}", json.dumps(state, sort_keys=True).encode()
        )
        tx.collect_endorsements(auditor)
        tx.submit()
        return token_type

    def transfer(self, owner_wallet: str, token_type: str, recipient: bytes,
                 auditor=None, tx_id: Optional[str] = None) -> None:
        tx = Transaction(self.party, tx_id)
        tx.transfer(owner_wallet, token_type, [1], [recipient])
        tx.collect_endorsements(auditor)
        tx.submit()

    # ------------------------------------------------------------ queries

    def my_nfts(self) -> List[str]:
        return [
            t.type
            for t in self.party.vault.unspent_tokens()
            if t.type.startswith(NFT_PREFIX)
        ]

    def state_matches(self, token_type: str, state: Dict[str, Any]) -> bool:
        """Check a claimed state against the hash committed in the type."""
        return token_type.endswith("." + _state_key(state))
