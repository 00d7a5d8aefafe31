"""A party (node): wallets + vault + selector + ttxdb bound to a network.

Counterpart of `fabric_token_sdk_tpu/services/ttx/party.py`, by copy.

Reference: fabric-smart-client node hosting the token SDK stack
(`token/services/ttx/*` views run on such nodes).
"""

from __future__ import annotations

from typing import Optional

from ...api.driver import Driver
from ...api.tms import ManagementService
from ...models.token import ID
from ...api.wallet import AuditorWallet, IssuerWallet, OwnerWallet, WalletRegistry
from ...crypto import sign
from ..network.ledger import Network
from ..selector.selector import SelectorManager
from ..ttxdb.db import TransactionDB
from ..vault.vault import Vault


class Party:
    def __init__(self, name: str, driver: Driver, network: Network,
                 auditor_identity: bytes = b"", rng=None,
                 db_path: str = ":memory:",
                 vault_path: Optional[str] = None):
        self.name = name
        self.driver = driver
        self.network = network
        self.rng = rng
        self.wallets = WalletRegistry()
        self.tms = ManagementService(driver, self.wallets, auditor_identity, rng)
        if vault_path:
            # crash-safe vault: recover whatever the journal + snapshot
            # hold (a fresh path recovers to empty) and keep journaling
            self.vault = Vault.recover(vault_path, driver, self._owns_identity)
        else:
            self.vault = Vault(driver, self._owns_identity)
        self.selectors = SelectorManager(self.vault)
        self.db = TransactionDB(db_path)
        network.subscribe(self.vault.on_finality)
        network.subscribe(self._on_finality)

    # ------------------------------------------------------------ wallets

    def new_owner_wallet(self, wid: str, anonymous: bool, nym_params=None) -> OwnerWallet:
        w = OwnerWallet(wid, anonymous, nym_params, self.rng)
        self.wallets.owners[wid] = w
        return w

    def new_issuer_wallet(self, wid: str) -> IssuerWallet:
        w = IssuerWallet(wid, sign.keygen(self.rng))
        self.wallets.issuers[wid] = w
        return w

    def new_auditor_wallet(self, wid: str) -> AuditorWallet:
        w = AuditorWallet(wid, sign.keygen(self.rng))
        self.wallets.auditors[wid] = w
        return w

    def _owns_identity(self, ident: bytes) -> bool:
        return self.wallets.wallet_owning(ident) is not None

    # ------------------------------------------------------------ events

    def _on_finality(self, event, request) -> None:
        status = "Confirmed" if event.status.value == "Valid" else "Deleted"
        if self.db.status(event.tx_id) is not None:
            self.db.set_status(event.tx_id, status)
        elif event.status.value == "Valid":
            self._record_received(event.tx_id, request)
        self.selectors.unlock_by_tx(event.tx_id)

    def _record_received(self, tx_id: str, request) -> None:
        """Record RECEIVED movements for outputs owned by this party's
        wallets (receiver-side bookkeeping). Output indices are global across
        actions, matching Vault.on_finality / Network.submit numbering."""
        from ...crypto.serialization import loads
        from ...utils.tracing import logger
        from ..ttxdb.db import MovementDirection

        out_index = 0
        for rec in list(request.issues) + list(request.transfers):
            outputs = loads(rec.action)["outputs"]
            for raw, meta in zip(outputs, rec.outputs_metadata):
                token_id = ID(tx_id, out_index)
                out_index += 1
                owner = self.driver.output_owner(raw)
                if not owner:
                    continue
                wallet = self.wallets.wallet_owning(owner)
                if wallet is None:
                    continue
                try:
                    ut = self.driver.output_to_unspent(token_id, raw, meta)
                except Exception as e:
                    logger.warning(
                        "party %s: cannot open received output %s: %s",
                        self.name, token_id, e,
                    )
                    continue
                self.db.add_movement(
                    tx_id, wallet.wallet_id, ut.type, int(ut.quantity),
                    MovementDirection.RECEIVED, "Confirmed",
                )

    # ------------------------------------------------------------ queries

    def balance(self, token_type: str) -> int:
        return self.vault.balance(token_type)
