from .nft import NFTService  # noqa: F401
