from .auditor import AuditorService  # noqa: F401
