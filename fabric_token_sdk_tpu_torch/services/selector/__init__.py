from .selector import (  # noqa: F401
    InsufficientFunds,
    Selector,
    SelectorManager,
    SelectorTimeout,
    ShardedLocker,
)
