from .owner import OwnerService  # noqa: F401
