"""Auditor service: inspect request openings, record, endorse.

Counterpart of `fabric_token_sdk_tpu/services/auditor/auditor.py`, by copy.

Reference: `token/services/auditor/*` + `zkatdlog/crypto/audit/auditor.go`.
The auditor receives every request before ordering, opens all outputs from
the metadata, checks consistency with the on-ledger commitments, records
the flows, and signs.
"""

from __future__ import annotations

from typing import Optional

from ...api.driver import Driver, ValidationError
from ...api.request import TokenRequest
from ...api.wallet import AuditorWallet
from ...crypto.serialization import loads
from ...models.token import ID
from ..ttxdb.db import TransactionDB, TxType


class AuditorService:
    def __init__(self, driver: Driver, wallet: AuditorWallet, db: Optional[TransactionDB] = None):
        self.driver = driver
        self.wallet = wallet
        self.db = db or TransactionDB()

    @property
    def identity(self) -> bytes:
        return self.wallet.identity

    def audit(self, request: TokenRequest) -> None:
        """Open every output against its metadata; raise on mismatch; sign."""
        for rec in request.issues:
            outputs = loads(rec.action)["outputs"]
            if len(rec.outputs_metadata) != len(outputs):
                raise ValidationError("audit: metadata does not cover all issue outputs")
            total = 0
            token_type = ""
            for idx, (raw, meta) in enumerate(zip(outputs, rec.outputs_metadata)):
                ut = self.driver.output_to_unspent(ID(request.anchor, idx), raw, meta)
                total += int(ut.quantity)
                token_type = ut.type
            self.db.add_transaction(
                request.anchor, TxType.ISSUE, "", "", token_type, total, "Pending"
            )
        for rec in request.transfers:
            outputs = loads(rec.action)["outputs"]
            if len(rec.outputs_metadata) != len(outputs):
                raise ValidationError("audit: metadata does not cover all transfer outputs")
            total = 0
            redeemed = 0
            token_type = ""
            for idx, (raw, meta) in enumerate(zip(outputs, rec.outputs_metadata)):
                # redeem (burn) outputs are audited too: their openings must
                # still match, and the burned amount is recorded
                ut = self.driver.output_to_unspent(ID(request.anchor, idx), raw, meta)
                token_type = ut.type
                if self.driver.output_owner(raw):
                    total += int(ut.quantity)
                else:
                    redeemed += int(ut.quantity)
            self.db.add_transaction(
                request.anchor,
                TxType.REDEEM if redeemed else TxType.TRANSFER,
                "", "", token_type, total + redeemed, "Pending",
            )
        request.auditor_signature = self.wallet.sign(request.marshal_to_audit())

    def on_finality(self, event, request) -> None:
        status = "Confirmed" if event.status.value == "Valid" else "Deleted"
        if self.db.status(event.tx_id) is not None:
            self.db.set_status(event.tx_id, status)
