from .htlc import HTLCScript, lock, claim, reclaim  # noqa: F401
