from .driver import FabTokenDriver, FabTokenPublicParams  # noqa: F401
