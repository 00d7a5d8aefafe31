"""Token data model: IDs, owners, quantities, clear tokens, actions, requests.

Reference: `token/token/*.go` (ID, Owner, Token, Quantity) and
`token/request.go` (TokenRequest assembly).
"""

from .token import ID, IssuedToken, Owner, Token, UnspentToken  # noqa: F401
from .quantity import Quantity  # noqa: F401
