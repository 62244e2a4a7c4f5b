"""Logical-axis -> mesh-axis rule tables (the port's copy of
`repro.dist.axes`, with no JAX).

Model code declares LOGICAL axes on every parameter and decode-state
leaf (`batch`, `fsdp`, `tp`, `expert`, `kv_seq`, `seq`, `layers` — see
models/common.py); a `MeshRules` table maps those names onto the
physical mesh axes of a given topology.  A pspec is a plain tuple, one
entry per dim (None, a mesh axis name, or a tuple of names): the
counterpart of JAX's `PartitionSpec(*entries)`.  A mesh is described by
its axis names (`rules_for_mesh`) or by a `{axis: size}` mapping
(`sanitize_pspec`).

An entry naming one mesh axis is that name, never a 1-tuple of it (as
`PartitionSpec` normalizes it).  `sanitize_pspec` drops mesh axes that
do not divide the corresponding array dimension (ragged vocab rows,
tiny norm vectors): a dim that cannot be split evenly is replicated.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

AxisEntry = Union[None, str, Tuple[str, ...]]
PSpec = Tuple[AxisEntry, ...]


@dataclass(frozen=True)
class MeshRules:
    """Mapping from logical axis name to mesh axis (or axes, or None)."""
    table: Dict[str, AxisEntry] = field(default_factory=dict)

    def get(self, name: Optional[str]) -> AxisEntry:
        if name is None:
            return None
        return self.table.get(name)

    def pspec(self, axes: Tuple[Optional[str], ...]) -> PSpec:
        return tuple(_canon(self.get(a)) for a in axes)

    def replace(self, **kw: AxisEntry) -> "MeshRules":
        return MeshRules({**self.table, **kw})


SINGLE_POD_RULES = MeshRules({
    "batch": "data", "fsdp": "data", "tp": "model", "expert": "model",
    "kv_seq": "model", "seq": "data", "layers": None,
})

# Multi-pod: activations batch-shard over (pod, data); params stay
# FSDP-sharded within a pod (each pod holds a full copy -> inter-pod
# traffic is gradients only, which dist/compress.py quantizes to INT8).
MULTI_POD_RULES = MeshRules({
    "batch": ("pod", "data"), "fsdp": "data", "tp": "model",
    "expert": "model", "kv_seq": "model", "seq": "data", "layers": None,
})

# Serving: one engine = one 1-D ("model",) group of `tp` ranks.  Only
# TP-marked dims shard — attention heads / KV-head groups (and their
# INT8 scale pools), FFN width, the vocab dim of embed/head, and the
# head-split dims of StateArena cells.  Everything page- or lane-wise
# (batch lanes, the page axis, block tables, sequence positions) stays
# replicated: block tables live host-side and must be the same on every
# rank, so COW/fork/trim/prefix adoption patch every rank's pools the
# same way.  fsdp/kv_seq/seq map to None (no data axis at serve time);
# the contraction after the O / w_down projections is an all-reduce.
SERVE_RULES = MeshRules({
    "batch": None, "fsdp": None, "tp": "model", "expert": "model",
    "kv_seq": None, "seq": None, "layers": None,
})


def _canon(entry: AxisEntry) -> AxisEntry:
    """A 1-tuple of one mesh axis is that axis."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def rules_for_mesh(axis_names: Iterable[str]) -> MeshRules:
    """The training rules of a mesh with these axis names."""
    return MULTI_POD_RULES if "pod" in tuple(axis_names) \
        else SINGLE_POD_RULES


def axis_size(mesh_shape: Mapping[str, int], entry: AxisEntry) -> int:
    """Ranks an entry spans: the product of its mesh axes' sizes."""
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    n = 1
    for a in names:
        n *= int(mesh_shape[a])
    return n


def sanitize_pspec(spec: PSpec, shape: Tuple[int, ...],
                   mesh_shape: Mapping[str, int]) -> PSpec:
    """Replicate any dim the mesh axes cannot evenly divide."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is not None and dim % axis_size(mesh_shape, entry) != 0:
            entry = None
        out.append(_canon(entry))
    return tuple(out)
