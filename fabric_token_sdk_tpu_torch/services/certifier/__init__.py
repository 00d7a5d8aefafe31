from .certifier import CertificationService  # noqa: F401
