"""Query service: balances and token listings over a party's vault.

Counterpart of `fabric_token_sdk_tpu/services/query/query.py`, by copy.

Reference: `token/services/query/*` (client.go, handler.go).
"""

from __future__ import annotations

from typing import Dict, List

from ...models.token import UnspentToken
from ..vault.vault import Vault


class QueryService:
    def __init__(self, vault: Vault):
        self.vault = vault

    def balance(self, token_type: str) -> int:
        return self.vault.balance(token_type)

    def all_my_tokens(self) -> List[UnspentToken]:
        return self.vault.unspent_tokens()

    def balances_by_type(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for t in self.vault.unspent_tokens():
            out[t.type] = out.get(t.type, 0) + int(t.quantity)
        return out
