"""Architecture registry (populated by the per-arch config modules).

Counterpart of `repro.configs.registry`, holding the architectures this
port serves."""
from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}
_SMOKE: Dict[str, Callable] = {}


def register(arch_id: str, full: Callable, smoke: Callable) -> None:
    _REGISTRY[arch_id] = full
    _SMOKE[arch_id] = smoke


def _ensure_loaded() -> None:
    from . import archs  # noqa: F401  (modules register at import)


def get_config(arch_id: str):
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise NotImplementedError(
            f"arch {arch_id!r} is not served by the PyTorch port yet "
            f"(available: {', '.join(sorted(_REGISTRY))})")
    return _REGISTRY[arch_id]()


def get_smoke_config(arch_id: str):
    get_config(arch_id)
    return _SMOKE[arch_id]()
