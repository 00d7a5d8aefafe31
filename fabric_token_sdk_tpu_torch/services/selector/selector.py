"""Concurrent UTXO selector: indexed candidates, sharded locks,
deadline-aware backoff.

Counterpart of `fabric_token_sdk_tpu/services/selector/selector.py`, by
copy. The environment knobs `FTS_SELECTOR_SHARDS` and
`FTS_SELECTOR_DEADLINE_S` are not ported: `shards` (16) and `deadline_s`
(None, the retry-count budget) are arguments.

Reference: `token/services/selector/*` (manager.go, selector.go, the
sharded in-memory locker). Multiple in-flight transactions compete for
the same unspent tokens; the selector walks the vault's (type, owner)
selection index — quantity-descending, so covering an amount needs the
fewest locks and the walk never touches tokens of other types — locks
candidates through a hash-sharded lock table (concurrent spenders on
different tokens almost never share a mutex), retries with backoff
while tokens are busy, and raises typed errors on insufficient funds or
an exhausted retry/wall-clock budget.

Self-hold semantics (pinned by `tests/test_torch_state_plane.py`): a token
already locked by the SAME tx was earmarked by one of this tx's earlier
selects — it is skipped WITHOUT counting toward the new total (counting
it would let one tx double-commit the same token across two transfer
records) and without flagging retryable contention (it can never free
up before the tx completes). A re-entrant select therefore asks only
for funds beyond what the tx already holds; `selector.self_held` counts
the skips so the condition is observable.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ...models.token import ID
from ...utils import faults
from ...utils import metrics as mx
from ..vault.vault import Vault


class InsufficientFunds(Exception):
    pass


class SelectorTimeout(Exception):
    pass


class _LockShard:
    __slots__ = ("mu", "locked", "by_tx")

    def __init__(self):
        self.mu = threading.Lock()
        self.locked: Dict[str, str] = {}  # token key -> tx id
        self.by_tx: Dict[str, Set[str]] = {}  # tx id -> its keys here


class ShardedLocker:
    """Token-lock table sharded by token-key hash: N independent mutexes
    plus a per-shard per-tx key set, so concurrent spenders contend only
    when they race for the SAME shard and `unlock_by_tx` releases a tx's
    locks in O(shards + locks held) instead of scanning every locked
    token under one global mutex."""

    def __init__(self, shards: int = 16):
        self._n = max(1, int(shards))
        self._shards = [_LockShard() for _ in range(self._n)]

    def _shard(self, key: str) -> _LockShard:
        return self._shards[hash(key) % self._n]

    def try_lock(self, token_id: ID, tx_id: str) -> bool:
        faults.fire("selector.lock")
        key = token_id.key()
        shard = self._shard(key)
        with shard.mu:
            if key in shard.locked:
                return False
            shard.locked[key] = tx_id
            shard.by_tx.setdefault(tx_id, set()).add(key)
            return True

    def holder(self, token_id: ID) -> Optional[str]:
        key = token_id.key()
        shard = self._shard(key)
        with shard.mu:
            return shard.locked.get(key)

    def unlock(self, token_id: ID) -> None:
        key = token_id.key()
        shard = self._shard(key)
        with shard.mu:
            tx_id = shard.locked.pop(key, None)
            if tx_id is not None:
                held = shard.by_tx.get(tx_id)
                if held is not None:
                    held.discard(key)
                    if not held:
                        del shard.by_tx[tx_id]

    def unlock_by_tx(self, tx_id: str) -> None:
        for shard in self._shards:
            with shard.mu:
                for key in shard.by_tx.pop(tx_id, ()):
                    shard.locked.pop(key, None)

    def is_locked(self, token_id: ID) -> bool:
        key = token_id.key()
        shard = self._shard(key)
        with shard.mu:
            return key in shard.locked

    def locked_count(self) -> int:
        """Total locks held (per-shard sums; approximate under races)."""
        return sum(len(s.locked) for s in self._shards)


class Selector:
    """Tx-scoped selector. `retries`/`backoff_s` govern the legacy
    retry-count budget; `deadline_s` switches to a WALL-CLOCK budget — under contention the caller knows
    how long selection may block, not just how many times it looped, and
    each backoff sleep is capped to the remaining budget."""

    def __init__(self, vault: Vault, locker: ShardedLocker, tx_id: str,
                 retries: int = 10, backoff_s: float = 0.02,
                 deadline_s: Optional[float] = None):
        self.vault = vault
        self.locker = locker
        self.tx_id = tx_id
        self.retries = retries
        self.backoff_s = backoff_s
        self.deadline_s = deadline_s

    def select(self, amount: int, token_type: str) -> Tuple[List[ID], int]:
        """Lock unspent tokens of `token_type` totalling >= amount.

        Returns (ids, total). Raises InsufficientFunds / SelectorTimeout.
        """
        t0 = time.monotonic()
        attempt = 0
        try:
            while True:
                picked: List[ID] = []
                total = 0
                scanned = 0
                saw_busy = False
                for ut in self.vault.iter_unspent(token_type):
                    if total >= amount:
                        break
                    scanned += 1
                    if not self.locker.try_lock(ut.id, self.tx_id):
                        if self.locker.holder(ut.id) == self.tx_id:
                            # earmarked by THIS tx's earlier select: never
                            # double-counted, never retryable contention
                            # (see module docstring)
                            mx.counter("selector.self_held").inc()
                        else:
                            saw_busy = True
                            mx.counter("selector.lock.busy").inc()
                        continue
                    mx.counter("selector.lock.acquired").inc()
                    picked.append(ut.id)
                    total += int(ut.quantity)
                # candidates examined this pass — the sub-linearity
                # witness: O(tokens needed + busy skips), not O(vault)
                mx.counter("selector.scanned").inc(scanned)
                if total >= amount:
                    return picked, total
                # not enough: release and maybe retry (tokens may unlock)
                for i in picked:
                    self.locker.unlock(i)
                if not saw_busy:
                    mx.counter("selector.insufficient_funds").inc()
                    raise InsufficientFunds(
                        f"insufficient funds: need {amount} of [{token_type}]"
                    )
                attempt += 1
                elapsed = time.monotonic() - t0
                if self.deadline_s is not None:
                    if elapsed >= self.deadline_s:
                        raise self._timeout(token_type)
                    sleep = min(self.backoff_s * attempt,
                                self.deadline_s - elapsed)
                else:
                    if attempt >= self.retries:
                        raise self._timeout(token_type)
                    sleep = self.backoff_s * attempt
                mx.counter("selector.retry").inc()
                time.sleep(max(0.0, sleep))
        finally:
            mx.histogram("selector.select.seconds").observe(
                time.monotonic() - t0
            )

    def _timeout(self, token_type: str) -> SelectorTimeout:
        mx.counter("selector.timeout").inc()
        return SelectorTimeout(
            f"token selection timed out: tokens busy for [{token_type}]"
        )

    def unselect(self, ids: List[ID]) -> None:
        for i in ids:
            self.locker.unlock(i)


class SelectorManager:
    """Per-party manager handing out tx-scoped selectors over one
    sharded locker."""

    def __init__(self, vault: Vault, shards: int = 16):
        self.vault = vault
        self.locker = ShardedLocker(shards)

    def new_selector(self, tx_id: str, **kw) -> Selector:
        return Selector(self.vault, self.locker, tx_id, **kw)

    def unlock_by_tx(self, tx_id: str) -> None:
        self.locker.unlock_by_tx(tx_id)
