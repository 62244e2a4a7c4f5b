from .registry import get_config, get_smoke_config

__all__ = ["get_config", "get_smoke_config"]
