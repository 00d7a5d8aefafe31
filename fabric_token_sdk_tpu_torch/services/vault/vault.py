"""Per-party token vault: owned unspent tokens + certification store.

Counterpart of `fabric_token_sdk_tpu/services/vault/vault.py`, by copy.

Reference: `token/services/vault/*` (token store, query engine,
certification) and `token/vault.go`. The vault subscribes to network
finality events; on every valid tx it deletes spent tokens (dropping
their certifications with them) and stores the outputs owned by this
party's wallets (openings arrive via the request metadata the party
already holds off-chain).

Storage is pluggable (`store.py`): the default `InMemoryTokenStore`
keeps the historical in-process behavior, `PersistentTokenStore` makes
the vault crash-safe (journal-then-apply per finality event, snapshot
compaction, `Vault.recover(path, ...)` after a crash). Every finality
event applies as ONE atomic `VaultDelta` — spends, stores and
certifications land together or not at all, in memory and on disk.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ...api.driver import Driver
from ...api.request import TokenRequest
from ...models.token import ID, UnspentToken
from ...utils import metrics as mx
from ..network.ledger import FinalityEvent, TxStatus
from .store import (
    InMemoryTokenStore,
    PersistentTokenStore,
    StoredToken,
    TokenStore,
    VaultDelta,
    decoded_token,
)


class Vault:
    def __init__(self, driver: Driver, owns_identity: Callable[[bytes], bool],
                 store: Optional[TokenStore] = None):
        self.driver = driver
        self.owns_identity = owns_identity
        self.store = store if store is not None else InMemoryTokenStore()

    @classmethod
    def recover(cls, path: str, driver: Driver,
                owns_identity: Callable[[bytes], bool]) -> "Vault":
        """Rebuild a crashed client's vault from its journal + snapshot
        (`PersistentTokenStore.recover`): every finality event this
        process ever acknowledged is replayed — balances equal the
        acknowledged-finality replay, a torn journal tail is truncated,
        and the vault keeps journaling to the same files."""

        def decode(token_id: ID, output: bytes,
                   metadata: Optional[bytes]) -> UnspentToken:
            return driver.output_to_unspent(token_id, output, metadata)

        store = PersistentTokenStore.recover(path, decode)
        return cls(driver, owns_identity, store=store)

    # ------------------------------------------------------------ process

    def on_finality(self, event: FinalityEvent, request: TokenRequest) -> None:
        """Network finality listener (reference: vault processor)."""
        if event.status != TxStatus.VALID:
            return
        tx_id = event.tx_id
        with mx.span("vault.on_finality", tx=tx_id):
            delta = VaultDelta(tx_id)
            for rec in request.transfers:
                delta.spends.extend(t.key() for t in rec.input_ids)
            # store owned outputs; output indices are global across actions
            out_index = 0
            for rec in list(request.issues) + list(request.transfers):
                metas = rec.outputs_metadata
                outputs = self._action_outputs(rec.action)
                for raw, meta in zip(outputs, metas):
                    st = self._maybe_stored(tx_id, out_index, raw, meta)
                    if st is not None:
                        delta.stores.append(st)
                    out_index += 1
            stats = self.store.apply(delta)
            mx.counter("vault.tokens.spent").inc(stats["spent"])
            mx.counter("vault.certs.dropped").inc(stats["certs_dropped"])
            mx.gauge("vault.tokens.held").set(len(self.store))

    def _action_outputs(self, action_bytes: bytes) -> List[bytes]:
        from ...crypto.serialization import loads

        return loads(action_bytes)["outputs"]

    def _maybe_stored(self, tx_id: str, index: int, output: bytes,
                      metadata: Optional[bytes]) -> Optional[StoredToken]:
        owner = self.driver.output_owner(output)
        if not owner or not self.owns_identity(owner):
            return None
        # decoded_token holds the ONE copy of the open-failure policy
        # (keep raw bytes, flag loudly, token unusable until re-delivered)
        # shared with the recovery path
        st = decoded_token(
            self.driver.output_to_unspent, ID(tx_id, index), output, metadata
        )
        if st.decoded is not None:
            mx.counter("vault.tokens.stored").inc()
        return st

    # ------------------------------------------------------------ queries

    def unspent_tokens(self, token_type: Optional[str] = None) -> List[UnspentToken]:
        return [
            st.decoded
            for st in self.store.tokens()
            if st.decoded is not None
            and (token_type is None or st.decoded.type == token_type)
        ]

    def iter_unspent(self, token_type: str):
        """Quantity-descending candidates of one type, via the
        (type, owner) selection index — the selector's walk touches only
        candidate tokens, never the whole vault. Stale index entries
        (spent since the snapshot) filter out against the live store."""
        for _quantity, key in self.store.candidates(token_type):
            st = self.store.get(key)
            if st is not None and st.decoded is not None:
                yield st.decoded

    def get(self, token_id: ID) -> Optional[StoredToken]:
        return self.store.get(token_id.key())

    def get_many(self, ids) -> Tuple[List[bytes], List[bytes]]:
        outputs, metas = [], []
        for i in ids:
            st = self.store.get(i.key())
            if st is None:
                raise KeyError(f"token {i} not in vault")
            outputs.append(st.output)
            metas.append(st.metadata)
        return outputs, metas

    def balance(self, token_type: str) -> int:
        return sum(int(t.quantity) for t in self.unspent_tokens(token_type))

    def token_ids(self) -> List[ID]:
        return [st.id for st in self.store.tokens()]

    # ------------------------------------------------------------ certify

    def store_certification(self, token_id: ID, cert: bytes) -> None:
        # routed through apply() so a persistent store journals it with
        # the same durability as token state
        self.store.apply(VaultDelta(certs=[(token_id.key(), cert)]))

    def certification(self, token_id: ID) -> Optional[bytes]:
        return self.store.certification(token_id.key())
