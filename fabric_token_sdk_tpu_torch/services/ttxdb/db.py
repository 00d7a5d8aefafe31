"""Transaction database (sqlite): records, movements, statuses, queries.

Counterpart of `fabric_token_sdk_tpu/services/ttxdb/db.py`, by copy.

Reference: `token/services/ttxdb/*` (db.go + badger/memory drivers):
payment/holding queries over per-wallet movements, transaction records
with status transitions, audit bookkeeping.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import List, Optional


class TxType(Enum):
    ISSUE = "Issue"
    TRANSFER = "Transfer"
    REDEEM = "Redeem"


class MovementDirection(Enum):
    SENT = "Sent"
    RECEIVED = "Received"


@dataclass
class TransactionRecord:
    tx_id: str
    tx_type: str
    sender_eid: str
    recipient_eid: str
    token_type: str
    amount: int
    status: str
    timestamp: float


class TransactionDB:
    """One DB per party (':memory:' or a file path for persistence)."""

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._mu = threading.Lock()
        with self._mu:
            # WAL journaling: crash-consistent file DBs with concurrent
            # readers never blocked by a writer (a no-op for ':memory:')
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.executescript(
                """
                CREATE TABLE IF NOT EXISTS transactions (
                    tx_id TEXT PRIMARY KEY, tx_type TEXT, sender_eid TEXT,
                    recipient_eid TEXT, token_type TEXT, amount TEXT,
                    status TEXT, timestamp REAL
                );
                CREATE TABLE IF NOT EXISTS movements (
                    tx_id TEXT, wallet_eid TEXT, token_type TEXT,
                    amount TEXT, direction TEXT, status TEXT
                );
                CREATE INDEX IF NOT EXISTS mov_wallet_idx
                    ON movements(wallet_eid, direction, status);
                """
            )
            self._conn.commit()

    # ------------------------------------------------------------ writes

    def add_transaction(self, tx_id: str, tx_type: TxType, sender: str,
                        recipient: str, token_type: str, amount: int,
                        status: str = "Pending") -> None:
        with self._mu:
            # tx_id is the PRIMARY KEY: a resubmitted tx UPSERTS its row
            # (fresh status/timestamp) instead of inserting a duplicate
            # that `status()` would silently shadow
            self._conn.execute(
                "INSERT INTO transactions VALUES (?,?,?,?,?,?,?,?) "
                "ON CONFLICT(tx_id) DO UPDATE SET "
                "tx_type=excluded.tx_type, sender_eid=excluded.sender_eid, "
                "recipient_eid=excluded.recipient_eid, "
                "token_type=excluded.token_type, amount=excluded.amount, "
                "status=excluded.status, timestamp=excluded.timestamp",
                (tx_id, tx_type.value, sender, recipient, token_type,
                 str(amount), status, time.time()),
            )
            self._conn.commit()

    def add_movement(self, tx_id: str, wallet: str, token_type: str,
                     amount: int, direction: MovementDirection,
                     status: str = "Pending") -> None:
        with self._mu:
            self._conn.execute(
                "INSERT INTO movements VALUES (?,?,?,?,?,?)",
                (tx_id, wallet, token_type, str(amount), direction.value, status),
            )
            self._conn.commit()

    def set_status(self, tx_id: str, status: str) -> None:
        with self._mu:
            self._conn.execute(
                "UPDATE transactions SET status=? WHERE tx_id=?", (status, tx_id)
            )
            self._conn.execute(
                "UPDATE movements SET status=? WHERE tx_id=?", (status, tx_id)
            )
            self._conn.commit()

    # ------------------------------------------------------------ queries

    def transactions(self, status: Optional[str] = None) -> List[TransactionRecord]:
        q = "SELECT * FROM transactions"
        args: tuple = ()
        if status:
            q += " WHERE status=?"
            args = (status,)
        with self._mu:
            rows = self._conn.execute(q + " ORDER BY timestamp", args).fetchall()
        return [
            TransactionRecord(r[0], r[1], r[2], r[3], r[4], int(r[5]), r[6], r[7])
            for r in rows
        ]

    def status(self, tx_id: str) -> Optional[str]:
        with self._mu:
            row = self._conn.execute(
                "SELECT status FROM transactions WHERE tx_id=? LIMIT 1", (tx_id,)
            ).fetchone()
        return row[0] if row else None

    def payments(self, wallet: str, token_type: Optional[str] = None) -> int:
        """Total confirmed amount sent by `wallet` (reference: payments filter)."""
        return self._sum_movements(wallet, MovementDirection.SENT, token_type)

    def holdings(self, wallet: str, token_type: Optional[str] = None) -> int:
        """Net confirmed holdings of `wallet` = received - sent."""
        return self._sum_movements(
            wallet, MovementDirection.RECEIVED, token_type
        ) - self._sum_movements(wallet, MovementDirection.SENT, token_type)

    def _sum_movements(self, wallet: str, direction: MovementDirection,
                       token_type: Optional[str]) -> int:
        # amounts are stored as TEXT (sqlite INTEGER caps at 2^63): sum in python
        q = ("SELECT amount FROM movements WHERE wallet_eid=? "
             "AND direction=? AND status='Confirmed'")
        args: list = [wallet, direction.value]
        if token_type:
            q += " AND token_type=?"
            args.append(token_type)
        with self._mu:
            rows = self._conn.execute(q, tuple(args)).fetchall()
        return sum(int(r[0]) for r in rows)
