"""Token transaction lifecycle: assemble -> endorse -> order -> finality.

Counterpart of `fabric_token_sdk_tpu/services/ttx/transaction.py`, by copy.

On the card (a `Network` whose device is CUDA) two rules of the block
path show here. A lone `submit()` forms a one-request block, under
`BlockPolicy.min_batch` (2), so its proof is verified on the host by
policy; a group reaches the batched planes only as a block: enqueue its
transactions with `submit_async`, then the first `wait()` drives the
commit of every queued request up to `max_block_txs`. A batched plane
that fails on the card fails the block: `submit`/`wait` raise
`DevicePlaneError`, nothing commits, and the transaction keeps its
selected tokens locked so that it can be submitted again (`abort()`
releases them).

Reference: `token/services/ttx/transaction.go`, `collect.go`, `endorse.go`,
`ordering.go`, `finality.go`. One Transaction wraps one TokenRequest; the
initiating party assembles actions (using its selector for inputs),
collects signatures (owners, issuers, auditor), submits to ordering, and
observes finality.
"""

from __future__ import annotations

import uuid
from typing import List, Optional, Sequence

from ...api.driver import ValidationError
from ...api.request import TokenRequest, TransferRecord
from ...models.token import ID
from ...utils import metrics as mx
from ..network.ledger import FinalityEvent, TxStatus
from ..ttxdb.db import MovementDirection, TxType
from .party import Party


class Transaction:
    def __init__(self, party: Party, tx_id: Optional[str] = None):
        self.party = party
        self.tx_id = tx_id or uuid.uuid4().hex
        self.request: TokenRequest = party.tms.new_request(self.tx_id)
        self._selected: List[ID] = []
        self._submission = None  # set by submit_async
        # distributed trace for this tx's whole lifecycle: minted at
        # assembly, active through endorse/order/finality, propagated
        # across the network boundary by remote.py
        self.trace = mx.new_trace()

    # ------------------------------------------------------------ assembly

    def issue(self, issuer_wallet_id: str, token_type: str, values: Sequence[int],
              recipients: Sequence[bytes], anonymous: bool = True) -> None:
        issuer = self.party.wallets.issuer_wallet(issuer_wallet_id)
        anonymous = anonymous and self.party.driver.supports_anonymous_issue
        with mx.use_trace(self.trace), \
                mx.span("ttx.assemble", tx=self.tx_id, kind="issue"):
            self.party.tms.add_issue(
                self.request, issuer, token_type, values, recipients, anonymous
            )
        self.party.db.add_transaction(
            self.tx_id, TxType.ISSUE, issuer_wallet_id, "", token_type, sum(values)
        )

    def transfer(self, owner_wallet_id: str, token_type: str,
                 values: Sequence[int], recipients: Sequence[bytes]) -> None:
        """Select inputs, build the transfer (+change), record movements."""
        with mx.use_trace(self.trace), \
                mx.span("ttx.assemble", tx=self.tx_id, kind="transfer"):
            self._transfer(owner_wallet_id, token_type, values, recipients)

    def _transfer(self, owner_wallet_id: str, token_type: str,
                  values: Sequence[int], recipients: Sequence[bytes]) -> None:
        spec = self._select_inputs(owner_wallet_id, token_type, values, recipients)
        self.party.tms.add_transfer(self.request, *spec)
        self._record_transfer(owner_wallet_id, token_type, sum(values))

    def _select_inputs(self, owner_wallet_id: str, token_type: str,
                       values: Sequence[int], recipients: Sequence[bytes]) -> tuple:
        """Select inputs by the party's selector, add the change back to
        the sender; returns `driver.transfer`'s positional arguments."""
        amount = sum(values)
        selector = self.party.selectors.new_selector(self.tx_id)
        ids, total = selector.select(amount, token_type)
        self._selected.extend(ids)
        outputs_values = list(values)
        out_owners = list(recipients)
        if total > amount:
            # change back to the sender
            wallet = self.party.wallets.owner_wallet(owner_wallet_id)
            outputs_values.append(total - amount)
            out_owners.append(wallet.recipient_identity())
        tokens, metas = self.party.vault.get_many(ids)
        return ids, tokens, metas, token_type, outputs_values, out_owners

    def _record_transfer(self, owner_wallet_id: str, token_type: str,
                         amount: int) -> None:
        self.party.db.add_transaction(
            self.tx_id, TxType.TRANSFER, owner_wallet_id, "", token_type, amount
        )
        self.party.db.add_movement(
            self.tx_id, owner_wallet_id, token_type, amount, MovementDirection.SENT
        )

    @classmethod
    def transfer_group(cls, party: Party, owner_wallet_id: str, token_type: str,
                       txs: Sequence[tuple], auditor,
                       rng=None) -> List["Transaction"]:
        """Assemble transfers from one wallet, prove them all with ONE
        `driver.transfer_many` (the zkatdlog driver's batched prover on its
        device, whatever the group's size), then endorse each: the builder
        a `PipelinedSubmitter` runs. `txs` holds `(tx_id, values,
        recipients)` a transaction (a None tx_id mints one). Each
        transaction selects its inputs, takes its change and records its
        ttxdb rows as `transfer` does, and is endorsed as
        `collect_endorsements(auditor)` does. If a selection or the
        proving fails, every input is unlocked and the error propagates. The reference has no
        counterpart: its transactions are proved one `transfer` at a time.
        """
        made, specs = [], []
        try:
            for tx_id, values, recipients in txs:
                tx = cls(party, tx_id)
                made.append(tx)
                with mx.use_trace(tx.trace), \
                        mx.span("ttx.assemble", tx=tx.tx_id, kind="transfer"):
                    specs.append(
                        tx._select_inputs(owner_wallet_id, token_type, values, recipients)
                    )
            with mx.span("ttx.prove_group", txs=len(made)):
                outcomes = party.driver.transfer_many(specs, rng=rng, min_batch=1)
        except BaseException:
            for tx in made:
                tx.abort()
            raise
        for tx, (_, values, _), spec, out in zip(made, txs, specs, outcomes):
            ids, tokens, _, _, _, owners = spec
            tx.request.transfers.append(TransferRecord(
                action=out.action_bytes,
                input_ids=list(ids),
                senders=[party.driver.output_owner(raw) for raw in tokens],
                outputs_metadata=out.metadata,
                receivers=list(owners),
            ))
            tx._record_transfer(owner_wallet_id, token_type, sum(values))
            tx.collect_endorsements(auditor)
        return made

    def redeem(self, owner_wallet_id: str, token_type: str, value: int) -> None:
        selector = self.party.selectors.new_selector(self.tx_id)
        ids, total = selector.select(value, token_type)
        self._selected.extend(ids)
        wallet = self.party.wallets.owner_wallet(owner_wallet_id)
        tokens, metas = self.party.vault.get_many(ids)
        self.party.tms.add_redeem(
            self.request, ids, tokens, metas, token_type, value,
            total - value, wallet.recipient_identity() if total > value else b"",
        )
        self.party.db.add_transaction(
            self.tx_id, TxType.REDEEM, owner_wallet_id, "", token_type, value
        )
        self.party.db.add_movement(
            self.tx_id, owner_wallet_id, token_type, value, MovementDirection.SENT
        )

    # ------------------------------------------------------------ endorse

    def collect_endorsements(self, auditor=None) -> None:
        """Owners sign, issuers sign, auditor audits + signs.

        Reference ttx/collect.go + auditor.go: the request is audited
        BEFORE ordering; the auditor signature covers actions + metadata.
        """
        with mx.use_trace(self.trace), mx.span("ttx.endorse", tx=self.tx_id):
            self.party.tms.sign_transfers(self.request)
            self.party.tms.sign_issues(self.request)
            if auditor is not None:
                auditor.audit(self.request)

    # ------------------------------------------------------------ ordering

    def submit(self) -> FinalityEvent:
        """Order + wait for finality (reference ttx/ordering.go then
        finality.go, collapsed for the synchronous caller)."""
        mx.counter("ttx.submitted").inc()
        with mx.use_trace(self.trace), \
                mx.span("ttx.order_and_finality", tx=self.tx_id):
            event = self.party.network.submit(self.request.to_bytes())
        return self._after_finality(event)

    def submit_async(self) -> "Transaction":
        """Enqueue into the network's ordering queue without waiting for
        the block cut — pipelined submission lets many txs land in ONE
        block and ride the batched validation plane. Call `wait()` for
        the finality event."""
        mx.counter("ttx.submitted").inc()
        with mx.use_trace(self.trace), mx.span("ttx.order", tx=self.tx_id):
            self._submission = self.party.network.submit_async(
                self.request.to_bytes()
            )
        return self

    def wait(self, timeout: Optional[float] = None) -> FinalityEvent:
        """Block until the tx's block commits (driving the group commit
        if this caller wins the orderer's race); raise on rejection."""
        if self._submission is None:
            raise RuntimeError(f"tx {self.tx_id} was never submitted")
        with mx.use_trace(self.trace), mx.span("ttx.finality", tx=self.tx_id):
            event = self._submission.result(timeout)
        return self._after_finality(event)

    def _after_finality(self, event: FinalityEvent) -> FinalityEvent:
        if event.status != TxStatus.VALID:
            mx.counter("ttx.rejected").inc()
            self.party.selectors.unlock_by_tx(self.tx_id)
            raise ValidationError(f"tx {self.tx_id} rejected: {event.message}")
        mx.counter("ttx.committed").inc()
        return event

    def abort(self) -> None:
        self.party.selectors.unlock_by_tx(self.tx_id)
