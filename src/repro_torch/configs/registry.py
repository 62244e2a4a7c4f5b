"""Architecture registry (populated by the per-arch config modules).

Counterpart of `repro.configs.registry`: the same shape table, the same
`long_ok` flags (archs whose attention is sub-quadratic or absent run
`long_500k`), and the lazy `ARCH_IDS` view.  An id the port does not
register raises NotImplementedError, naming the ones it does."""
from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}
_SMOKE: Dict[str, Callable] = {}
_LONG_OK: Dict[str, bool] = {}

SHAPE_IDS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

# (seq_len, global_batch, kind) per assigned shape
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def register(arch_id: str, full: Callable, smoke: Callable,
             long_ok: bool = False) -> None:
    _REGISTRY[arch_id] = full
    _SMOKE[arch_id] = smoke
    _LONG_OK[arch_id] = long_ok


def _ensure_loaded() -> None:
    from . import archs  # noqa: F401  (modules register at import)


def _known(arch_id: str) -> None:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise NotImplementedError(
            f"arch {arch_id!r} is not served by the PyTorch port yet "
            f"(available: {', '.join(sorted(_REGISTRY))})")


def supports_long(arch_id: str) -> bool:
    _known(arch_id)
    return _LONG_OK[arch_id]


def shapes_for(arch_id: str):
    """Shape ids applicable to this arch (long_500k needs sub-quadratic
    attention: skipped for pure full-attention archs)."""
    ids = ["train_4k", "prefill_32k", "decode_32k"]
    if supports_long(arch_id):
        ids.append("long_500k")
    return tuple(ids)


def get_config(arch_id: str):
    _known(arch_id)
    return _REGISTRY[arch_id]()


def get_smoke_config(arch_id: str):
    _known(arch_id)
    return _SMOKE[arch_id]()


class _ArchIds:
    """Lazy tuple-like view over registered arch ids."""

    def __iter__(self):
        _ensure_loaded()
        return iter(sorted(_REGISTRY))

    def __contains__(self, x):
        _ensure_loaded()
        return x in _REGISTRY

    def __len__(self):
        _ensure_loaded()
        return len(_REGISTRY)

    def __repr__(self):
        _ensure_loaded()
        return repr(tuple(sorted(_REGISTRY)))


ARCH_IDS = _ArchIds()


def input_specs(arch_id: str, shape_id: str, multi_pod: bool = False):
    """Meta-tensor stand-ins for every model input of (arch, shape),
    from `launch.specs` (re-exported here for convenience)."""
    from repro_torch.launch.specs import input_specs as _impl
    return _impl(arch_id, shape_id, multi_pod=multi_pod)
