"""Token API layer: driver interfaces, token request, management service.

Reference: `token/driver/*.go` (driver SPI) and `token/*.go` (TMS facade,
Request, wallets).
"""

from .driver import Driver, ValidationError  # noqa: F401
from .request import TokenRequest, RequestMetadata  # noqa: F401
from .tms import ManagementService  # noqa: F401
