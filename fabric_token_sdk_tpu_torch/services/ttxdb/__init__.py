from .db import MovementDirection, TransactionDB, TxType  # noqa: F401
