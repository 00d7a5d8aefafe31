from .store import (  # noqa: F401
    InMemoryTokenStore,
    PersistentTokenStore,
    StoredToken,
    TokenStore,
    VaultDelta,
)
from .vault import Vault  # noqa: F401
