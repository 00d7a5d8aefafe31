"""Token Management Service: the per-network facade binding driver,
wallets, and request assembly.

Reference: `token/tms.go` + `token/request.go` (Issue/Transfer/Redeem).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .driver import Driver
from .request import IssueRecord, TokenRequest, TransferRecord
from .validator import RequestValidator
from .wallet import IssuerWallet, OwnerWallet, WalletRegistry
from ..models.token import ID, UnspentToken


class ManagementService:
    def __init__(self, driver: Driver, wallets: Optional[WalletRegistry] = None,
                 auditor_identity: bytes = b"", rng=None):
        self.driver = driver
        self.wallets = wallets or WalletRegistry()
        self.auditor_identity = auditor_identity
        self.rng = rng

    # ------------------------------------------------------------ requests

    def new_request(self, anchor: str) -> TokenRequest:
        return TokenRequest(anchor=anchor)

    def add_issue(self, request: TokenRequest, issuer: IssuerWallet, token_type: str,
                  values: Sequence[int], owners: Sequence[bytes],
                  anonymous: bool = True) -> IssueRecord:
        outcome = self.driver.issue(
            issuer.identity, token_type, list(values), list(owners), anonymous
        )
        rec = IssueRecord(
            action=outcome.action_bytes,
            # anonymous issues must not leak the issuer at the request level
            # either — the action already blanks it
            issuer=b""
            if anonymous and self.driver.supports_anonymous_issue
            else issuer.identity,
            outputs_metadata=outcome.metadata,
            receivers=list(owners),
        )
        request.issues.append(rec)
        return rec

    def add_transfer(self, request: TokenRequest, input_ids: Sequence[ID],
                     input_tokens: Sequence[bytes], input_metadata: Sequence[bytes],
                     token_type: str, values: Sequence[int],
                     owners: Sequence[bytes]) -> TransferRecord:
        outcome = self.driver.transfer(
            list(input_ids), list(input_tokens), list(input_metadata),
            token_type, list(values), list(owners),
        )
        senders = [self.driver.output_owner(raw) for raw in input_tokens]
        rec = TransferRecord(
            action=outcome.action_bytes,
            input_ids=list(input_ids),
            senders=senders,
            outputs_metadata=outcome.metadata,
            receivers=list(owners),
        )
        request.transfers.append(rec)
        return rec

    def add_redeem(self, request: TokenRequest, input_ids, input_tokens,
                   input_metadata, token_type: str, redeem_value: int,
                   change_value: int, change_owner: bytes) -> TransferRecord:
        """Redeem = transfer with an empty-owner output (reference
        request.go:315 Redeem)."""
        values = [redeem_value] + ([change_value] if change_value else [])
        owners = [b""] + ([change_owner] if change_value else [])
        return self.add_transfer(
            request, input_ids, input_tokens, input_metadata, token_type, values, owners
        )

    # ------------------------------------------------------------ signing

    def sign_transfers(self, request: TokenRequest) -> None:
        """Each input owner signs the request (CollectEndorsements step)."""
        payload = request.marshal_to_sign()
        for rec in request.transfers:
            rec.signatures = []
            for sender in rec.senders:
                w = self.wallets.wallet_owning(sender)
                if w is None:
                    raise ValueError("no wallet controls a sender identity")
                rec.signatures.append(w.sign(sender, payload))

    def sign_issues(self, request: TokenRequest) -> None:
        payload = request.marshal_to_sign()
        for rec in request.issues:
            if not rec.issuer:
                continue  # anonymous issue: the proof authorizes
            for iw in self.wallets.issuers.values():
                if iw.identity == rec.issuer:
                    rec.signature = iw.sign(payload, self.rng)
                    break
            else:
                raise ValueError("no issuer wallet controls the issue identity")

    def audit(self, request: TokenRequest, auditor_wallet) -> None:
        request.auditor_signature = auditor_wallet.sign(request.marshal_to_audit())

    # ------------------------------------------------------------ validate

    def validator(self) -> RequestValidator:
        return RequestValidator(self.driver, self.auditor_identity)
