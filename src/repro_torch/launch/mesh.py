"""Production mesh descriptions.

The port's dry-run needs a mesh's axes and their sizes only: a
`{axis: size}` mapping, the description `dist.axes.sanitize_pspec`
takes.  Building one touches no device state.
"""
from __future__ import annotations

from typing import Dict


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """16x16 = 256 devices a pod; multi_pod adds a 2-pod leading axis
    (512)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh() -> Dict[str, int]:
    """Single-device mesh for smoke tests, examples and one card."""
    return {"data": 1, "model": 1}
