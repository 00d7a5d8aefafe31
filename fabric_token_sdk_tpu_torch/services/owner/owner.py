"""Owner service: transaction history + status tracking for a party.

Counterpart of `fabric_token_sdk_tpu/services/owner/owner.py`, by copy.

Reference: `token/services/owner/*` (manager.go, owner.go).
"""

from __future__ import annotations

from typing import List, Optional

from ..ttxdb.db import TransactionDB, TransactionRecord


class OwnerService:
    def __init__(self, db: TransactionDB):
        self.db = db

    def transaction_status(self, tx_id: str) -> Optional[str]:
        return self.db.status(tx_id)

    def history(self, status: Optional[str] = None) -> List[TransactionRecord]:
        return self.db.transactions(status)

    def payments(self, wallet: str, token_type: Optional[str] = None) -> int:
        return self.db.payments(wallet, token_type)

    def holdings(self, wallet: str, token_type: Optional[str] = None) -> int:
        return self.db.holdings(wallet, token_type)
