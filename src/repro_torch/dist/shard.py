"""Tensor-parallel serving on `torch.distributed`: what the JAX package's
`qtree_shardings`, `tree_shardings`, `serve_mesh` and `use_mesh_rules` /
`constrain` do under GSPMD, done explicitly.

  leaf_pspec   one pspec for a leaf from its logical axes; a packed
               `QTensor` shards a dim only where the rank count divides
               it in every materialization (orig_shape, packed data,
               group scales), as `qtree_shardings` decides
  shard_tree   each rank's slice of every leaf of a param tree, a
               contiguous copy (so the kernels see aligned scales)
  shard_specs  the rank-local shapes of a ParamSpec tree (the KV pools)
  serve_group  the process group of a tp-way engine, or a ValueError
               naming the count and how to start the ranks
  use_tp       a thread-local context under which `tp_all_reduce` and
               `tp_all_gather` run their collectives on the group;
               outside it both return their input, as `constrain` is a
               no-op without `use_mesh_rules`

A serve "mesh" is one axis, "model", of `tp` ranks, and rank r holds the
r-th contiguous slice of every dim its pspec names.  The model code
(`models/attention.py`, `ffn.py`, `model.py`) reads the local widths off
the tensors it is given: column-parallel q/k/v and gate/up, row-parallel
`wo` and `w_down` followed by `tp_all_reduce`, the rank's experts of
every MoE stack (the routing global, one `tp_all_reduce` a MoE layer),
MLA's heads over whole latent pools, a vocab-parallel table gathered
for the logits (`kernels.ops.row_parallel`, `tp_rank_and_size`).

Collectives run on the group's backend as it is: gloo for ranks on the
CPU and for ranks that share one card (NCCL refuses two ranks on one
device).  Each rank counts the collectives it ran, by kind
(`collective_counts`), and the host seconds spent in them
(`collective_seconds`: on the card a gloo collective waits for the
device, copies through the host and back).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.quant.qarray import QTensor

from .axes import SERVE_RULES, MeshRules, PSpec, axis_size, sanitize_pspec

SERVE_AXIS = "model"

_ctx = threading.local()
_COUNTS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}
_SECONDS: Dict[str, float] = dict.fromkeys(_COUNTS, 0.0)
_COUNT_LOCK = threading.Lock()


def serve_mesh_shape(tp: int) -> Mapping[str, int]:
    """The serve mesh: one "model" axis of `tp` ranks."""
    return {SERVE_AXIS: tp}


# ----------------------------------------------------------------------------
# spec trees -> each rank's slices
# ----------------------------------------------------------------------------
def leaf_pspec(spec, leaf: Any, tp: int,
               rules: MeshRules = SERVE_RULES) -> PSpec:
    """The pspec of one leaf on a `tp`-rank serve mesh: its logical axes
    through `rules`, a dim replicated where `tp` does not divide it.  A
    `QTensor` gets one pspec for its data and scales, a dim sharded only
    where `tp` divides orig_shape, the packed data and the group scales
    alike (the JAX package's `qtree_shardings`): sanitizing them apart
    could split the data while replicating its scales."""
    mesh = serve_mesh_shape(tp)
    entries = rules.pspec(spec.axes)
    if not isinstance(leaf, QTensor):
        return sanitize_pspec(entries, tuple(leaf.shape), mesh)
    shapes = (tuple(leaf.orig_shape), tuple(leaf.data.shape),
              tuple(leaf.scales.shape))
    entries = tuple(entries) + (None,) * len(leaf.orig_shape)
    out = []
    for i, entry in enumerate(entries[:len(leaf.orig_shape)]):
        n = axis_size(mesh, entry)
        if entry is not None and any(s[i] % n for s in shapes):
            entry = None
        out.append(entry)
    return tuple(out)


def _slice(x: torch.Tensor, pspec: PSpec, rank: int, tp: int
           ) -> torch.Tensor:
    """Rank `rank`'s part of x under `pspec`, as a contiguous copy."""
    for dim, entry in enumerate(pspec):
        if entry is not None:
            n = axis_size(serve_mesh_shape(tp), entry)
            size = x.shape[dim] // n
            x = x.narrow(dim, rank * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def shard_leaf(leaf: Any, pspec: PSpec, rank: int, tp: int) -> Any:
    """One leaf's slice for `rank` (a QTensor's data and scales on the
    same dims, its orig_shape shrunk to match)."""
    if not isinstance(leaf, QTensor):
        return _slice(leaf, pspec, rank, tp)
    shape = tuple(s // tp if e is not None else s
                  for s, e in zip(leaf.orig_shape, pspec))
    return QTensor(data=_slice(leaf.data, pspec, rank, tp),
                   scales=_slice(leaf.scales, pspec, rank, tp),
                   bits=leaf.bits, group=leaf.group, axis=leaf.axis,
                   orig_shape=shape)


def shard_tree(params: Any, specs: Any, rank: int, tp: int,
               rules: MeshRules = SERVE_RULES) -> Any:
    """Rank `rank`'s slices of every leaf of `params` (nested dicts
    mirroring the ParamSpec tree `specs`)."""
    if isinstance(specs, dict):
        return {k: shard_tree(params[k], specs[k], rank, tp, rules)
                for k in specs}
    return shard_leaf(params, leaf_pspec(specs, params, tp, rules), rank,
                      tp)


def shard_specs(specs: Any, tp: int, rules: MeshRules = SERVE_RULES) -> Any:
    """A ParamSpec tree at one rank's shapes: every dim its pspec shards
    divided by `tp` (the KV pools of a tp-way engine)."""
    if isinstance(specs, dict):
        return {k: shard_specs(v, tp, rules) for k, v in specs.items()}
    pspec = leaf_pspec(specs, specs, tp, rules)
    shape = tuple(s // tp if e is not None else s
                  for s, e in zip(specs.shape, pspec))
    return dataclasses.replace(specs, shape=shape)


# ----------------------------------------------------------------------------
# the process group and the collectives
# ----------------------------------------------------------------------------
def serve_group(tp: int):
    """The process group a `tp`-way engine runs on: torch.distributed's
    default group, which must hold exactly `tp` ranks (the counterpart
    of JAX's `serve_mesh`, which needs `tp` devices)."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    import torch.distributed as dist
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 0)
    if world != tp:
        have = ("no torch.distributed group is initialized" if not world
                else f"the torch.distributed group has {world} ranks")
        raise ValueError(
            f"tp={tp} needs a torch.distributed group of {tp} ranks but "
            f"{have}; start {tp} ranks (python -m "
            f"repro_torch.launch.serve --tp {tp} spawns them) and call "
            f"torch.distributed.init_process_group('gloo', rank=r, "
            f"world_size={tp}, init_method=...) in each")
    return dist.group.WORLD


def _current():
    return getattr(_ctx, "group", None)


@contextlib.contextmanager
def use_tp(group):
    """Run the collectives of `tp_all_reduce` / `tp_all_gather` on
    `group` in this thread (None: no-ops, as outside the context)."""
    prev = _current()
    _ctx.group = group
    try:
        yield
    finally:
        _ctx.group = prev


def tp_rank_and_size() -> Tuple[int, int]:
    """(rank, ranks) of the active group; (0, 1) outside `use_tp`."""
    group = _current()
    if group is None:
        return 0, 1
    import torch.distributed as dist
    return dist.get_rank(group), dist.get_world_size(group)


def _count(kind: str, t0: float) -> None:
    dt = time.perf_counter() - t0
    with _COUNT_LOCK:
        _COUNTS[kind] += 1
        _SECONDS[kind] += dt


def collective_counts() -> Dict[str, int]:
    """Collectives this process ran since the last reset, by kind."""
    with _COUNT_LOCK:
        return dict(_COUNTS)


def collective_seconds() -> Dict[str, float]:
    """Host seconds spent in those collectives, by kind."""
    with _COUNT_LOCK:
        return dict(_SECONDS)


def reset_collective_counts() -> None:
    with _COUNT_LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0
            _SECONDS[k] = 0.0


def tp_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the active group's ranks (x itself outside
    `use_tp`), in place when x is contiguous.  Every rank gets the same
    bytes."""
    group = _current()
    if group is None:
        return x
    import torch.distributed as dist
    t0 = time.perf_counter()
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    _count("all_reduce", t0)
    return x


def tp_all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' x concatenated along `dim` in rank order (x itself
    outside `use_tp`)."""
    group = _current()
    if group is None:
        return x
    import torch.distributed as dist
    t0 = time.perf_counter()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    _count("all_gather", t0)
    return torch.cat(parts, dim=dim)
