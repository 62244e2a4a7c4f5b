from .digest import QuantileDigest

__all__ = ["QuantileDigest"]
