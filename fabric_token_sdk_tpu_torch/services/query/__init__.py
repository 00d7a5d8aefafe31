from .query import QueryService  # noqa: F401
