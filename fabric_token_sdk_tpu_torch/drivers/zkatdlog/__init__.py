from .driver import ZKATDLogDriver  # noqa: F401
