"""Tensor-parallel serving on `torch.distributed`: what the JAX package's
`qtree_shardings`, `tree_shardings`, `serve_mesh` and `use_mesh_rules` /
`constrain` do under GSPMD, done explicitly.

  leaf_pspec   one pspec for a leaf from its logical axes; a packed
               `QTensor` shards a dim only where the rank count divides
               it in every materialization (orig_shape, packed data,
               group scales), as `qtree_shardings` decides
  shard_tree   each rank's slice of every leaf of a param tree, a
               contiguous copy (so the kernels see aligned scales)
  rank_params  `shard_tree` of a full tree; a tree that is the rank's
               already as it is (the replicas of a fleet share it)
  shard_specs  the rank-local shapes of a ParamSpec tree (the KV pools,
               the StateArena; both: `shard_state_specs`)
  recurrent_splits  the split rule of every leaf of the recurrent cells
               (Mamba2, mLSTM, sLSTM) and of their arena state: a leaf
               holding several segments side by side is cut segment by
               segment (`Split`); `shard_tree` and `shard_specs` take it
               before `leaf_pspec`
  serve_group  the process group of a tp-way engine, or a ValueError
               naming the count and how to start the ranks
  replica_groups  one fleet replica's own pair of groups over those
               ranks (its step's collectives, its ticks: `lockstep`)
  fleet_group  the group of the fleet's own channel
               (`lockstep.FleetChannel`: a replica added, the stop)
  use_tp       a thread-local context under which `tp_all_reduce` and
               `tp_all_gather` run their collectives on the group;
               outside it both return their input, as `constrain` is a
               no-op without `use_mesh_rules`; on a `CountingGroup` they
               only count (the dry-run)
  mesh_leaf_pspec, shard_shape  a leaf's pspec and a device's block on
               any `{axis: size}` mesh (the dry-run's production meshes)

A serve "mesh" is one axis, "model", of `tp` ranks, and rank r holds the
r-th contiguous slice of every dim its pspec names, except where
`recurrent_splits` names the leaf.  The model code (`models/attention.py`,
`ffn.py`, `ssm.py`, `model.py`) reads the local widths off the tensors it
is given: column-parallel q/k/v and gate/up, row-parallel `wo` and
`w_down` followed by `tp_all_reduce`, the rank's experts of every MoE
stack (the routing global, one `tp_all_reduce` a MoE layer), MLA's heads
over whole latent pools, a vocab-parallel table gathered for the logits
(`kernels.ops.row_parallel`, `tp_rank_and_size`), and the recurrent
cells on the rank's heads (xlstm, zamba; `recurrent_splits`).

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
import math
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

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
    return mesh_leaf_pspec(spec, leaf, serve_mesh_shape(tp), rules)


def mesh_leaf_pspec(spec, leaf: Any, mesh_shape: Mapping[str, int],
                    rules: MeshRules) -> PSpec:
    """`leaf_pspec` on any mesh given as `{axis: size}` (the dry-run's
    production meshes): JAX's `tree_shardings` for a tensor,
    `qtree_shardings` for a QTensor."""
    entries = rules.pspec(spec.axes)
    if not isinstance(leaf, QTensor):
        return sanitize_pspec(entries, tuple(leaf.shape), mesh_shape)
    shapes = (tuple(leaf.orig_shape), tuple(leaf.data.shape),
              tuple(leaf.scales.shape))
    entries = tuple(entries) + (None,) * len(leaf.orig_shape)
    out = []
    for i, entry in enumerate(entries[:len(leaf.orig_shape)]):
        n = axis_size(mesh_shape, entry)
        if entry is not None and any(s[i] % n for s in shapes):
            entry = None
        out.append(entry)
    return tuple(out)


def shard_shape(shape: Tuple[int, ...], pspec: PSpec,
                mesh_shape: Mapping[str, int]) -> Tuple[int, ...]:
    """A device's block of an array of `shape` under `pspec` (JAX's
    `NamedSharding.shard_shape`)."""
    pspec = tuple(pspec) + (None,) * (len(shape) - len(pspec))
    return tuple(d // axis_size(mesh_shape, e) for d, e in zip(shape, pspec))


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


# ----------------------------------------------------------------------------
# the recurrent cells: a split rule per leaf
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Split:
    """How every rank cuts one leaf along `dim` (negative: stacked layer
    dims come first).  The leaf is `segments` side by side, each (size,
    split): rank r keeps the r-th of tp equal runs of a split segment and
    all of a whole one, and its parts are concatenated in segment order
    into one contiguous leaf.  No split segment: the leaf is whole on
    every rank."""
    dim: int
    segments: Tuple[Tuple[int, bool], ...] = ()

    def splits(self) -> bool:
        return any(split for _, split in self.segments)

    def pieces(self, rank: int, tp: int) -> List[Tuple[int, int]]:
        """(start, length) along `dim` of each of rank r's parts."""
        out, start = [], 0
        for size, split in self.segments:
            n = size // tp if split else size
            out.append((start + rank * n if split else start, n))
            start += size
        return out


WHOLE = Split(-1)


def recurrent_splits(cfg, tp: int) -> Dict[Tuple[str, str], Split]:
    """The split table of the recurrent cells of `cfg` at `tp` ranks,
    keyed by (cell, leaf name): cell "mamba2" (zamba's `mamba` and
    `mamba_tail` stacks), "mlstm" or "slstm" (xlstm's), the leaf a
    parameter of the cell or a leaf of its StateArena state.  {} for a
    family without recurrent cells.

    Mamba2 (di = nh * head_dim channels, one group of ds-wide B / C):
      in_proj [z | x | B | C | dt]  z, x of the rank's nh / tp heads, all
                                    of B and C, dt of its heads
      conv_w, conv_b [x | B | C]    its x channels, all of B and C
      a_log, d_skip, dt_bias        its heads (stored sliced)
      norm                          its channels (the gated RMSNorm takes
                                    its mean of squares over the ranks'
                                    channels gathered)
      out_proj                      its rows: row-parallel
      state (b, nh, hd, ds)         its heads
      conv (b, d_conv - 1, di + 2 ds)  its x channels, all of B and C
    mLSTM (di = nh * dh):
      up_proj [x_m | z]             the columns of its heads in each
      wq, wk, wv (nh, dh, dh)       its heads (dim 0: the experts of
                                    `cim_gemv`'s stack layout)
      w_o (di, di)                  its output columns (its input, x_m,
                                    is gathered whole)
      hnorm                         its channels (mean of squares as
                                    Mamba2's norm)
      down_proj                     its rows: row-parallel
      conv_w, conv_b, w_if, b_if    whole: the gates read every head's
                                    conv output, so the conv runs whole
                                    on the gathered x_m
      C (b, nh, dh, dh), n, m       its heads
      conv (b, conv_width - 1, di)  whole
    sLSTM (d wide, f_up = proj_factor_slstm * d):
      w_gates, r_gates, b_gates, gnorm, c, n, h, m
                                    whole: the cell runs on every rank
                                    (its gates are split out of the
                                    head-major (b, 4d) product, so each
                                    gate reads every head)
      ffn_up [gate | up]            its f_up / tp columns of each
      ffn_down                      its rows: row-parallel

    A cell whose heads tp does not divide (the sLSTM: whose f_up) is
    whole on every rank, every leaf of it.  A packed leaf whose rows a
    rule splits is whole where the rank's rows do not start and end on
    its scale groups and packed bytes (`cut`): the model then gathers
    its input (`kernels.ops.row_parallel`)."""
    # imported here: the models import this module's collectives
    from repro_torch.models.ssm import mamba2_dims, mlstm_dims, slstm_dims
    if cfg.family not in ("xlstm", "zamba") or tp <= 1:
        return {}
    out: Dict[Tuple[str, str], Split] = {}

    def cell(name, split, rules):
        for leaf, (dim, segments) in rules.items():
            out[name, leaf] = (Split(dim, tuple(segments)) if split
                               else WHOLE)

    if cfg.family == "zamba":
        di, nh, ds = mamba2_dims(cfg)
        heads = [(di, True)]
        xbc = [(di, True), (ds, False), (ds, False)]
        cell("mamba2", nh % tp == 0, {
            "in_proj": (-1, [(di, True)] + xbc + [(nh, True)]),
            "conv_w": (-1, xbc), "conv_b": (-1, xbc),
            "a_log": (-1, [(nh, True)]), "d_skip": (-1, [(nh, True)]),
            "dt_bias": (-1, [(nh, True)]),
            "norm": (-1, heads), "out_proj": (-2, heads),
            "state": (-3, [(nh, True)]), "conv": (-1, xbc)})
        return out
    di, nh, _ = mlstm_dims(cfg)
    heads = [(di, True)]
    cell("mlstm", nh % tp == 0, {
        "up_proj": (-1, heads * 2), "w_o": (-1, heads),
        "wq": (-3, [(nh, True)]), "wk": (-3, [(nh, True)]),
        "wv": (-3, [(nh, True)]),
        "hnorm": (-1, heads), "down_proj": (-2, heads),
        "C": (-3, [(nh, True)]), "n": (-2, [(nh, True)]),
        "m": (-1, [(nh, True)])})
    for leaf in ("conv_w", "conv_b", "w_if", "b_if", "conv"):
        out["mlstm", leaf] = WHOLE
    d = slstm_dims(cfg)[0]
    f_up = int(cfg.ssm.proj_factor_slstm * d)
    cell("slstm", f_up % tp == 0, {
        "ffn_up": (-1, [(f_up, True)] * 2),
        "ffn_down": (-2, [(f_up, True)])})
    for leaf in ("w_gates", "r_gates", "b_gates", "gnorm",
                 "c", "n", "h", "m"):
        out["slstm", leaf] = WHOLE
    return out


# the top-level keys of the recurrent stacks (params and arena alike)
_CELL_OF = {"mamba": "mamba2", "mamba_tail": "mamba2", "mlstm": "mlstm",
            "slstm": "slstm"}


def _split_of(splits, path: Tuple[str, ...]) -> Optional[Split]:
    """The table's rule of the leaf at `path`, or None."""
    if not splits or not path:
        return None
    return splits.get((_CELL_OF.get(path[0]), path[-1]))


def _pieces(x: torch.Tensor, dim: int, pieces) -> torch.Tensor:
    parts = [x.narrow(dim, s, n) for s, n in pieces]
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return out.clone(memory_format=torch.contiguous_format)


def cut(leaf: Any, split: Split, rank: int, tp: int) -> Any:
    """Rank `rank`'s part of `leaf` under `split`: a contiguous copy, or
    the leaf itself where it stays whole.  A QTensor cut across its
    packed rows moves data and scales by whole bytes and groups, or
    stays whole where a part would not start and end on them."""
    if not split.splits():
        return leaf
    pieces = split.pieces(rank, tp)
    if not isinstance(leaf, QTensor):
        return _pieces(leaf, split.dim, pieces)
    ndim = len(leaf.orig_shape)
    data_p = scale_p = pieces
    if split.dim % ndim == leaf.axis % ndim:
        pack = 2 if leaf.bits == 4 else 1
        unit = math.lcm(leaf.group, pack)
        if any(s % unit or n % unit for s, n in pieces):
            return leaf
        data_p = [(s // pack, n // pack) for s, n in pieces]
        scale_p = [(s // leaf.group, n // leaf.group) for s, n in pieces]
    shape = list(leaf.orig_shape)
    shape[split.dim] = sum(n for _, n in pieces)
    return QTensor(data=_pieces(leaf.data, split.dim, data_p),
                   scales=_pieces(leaf.scales, split.dim, scale_p),
                   bits=leaf.bits, group=leaf.group, axis=leaf.axis,
                   orig_shape=tuple(shape))


def shard_tree(params: Any, specs: Any, rank: int, tp: int,
               rules: MeshRules = SERVE_RULES,
               splits: Optional[Dict[Tuple[str, str], Split]] = None,
               _path: Tuple[str, ...] = ()) -> Any:
    """Rank `rank`'s slices of every leaf of `params` (nested dicts
    mirroring the ParamSpec tree `specs`): the leaves `splits`
    (`recurrent_splits`) names by its rule, every other by its pspec."""
    if isinstance(specs, dict):
        return {k: shard_tree(params[k], specs[k], rank, tp, rules, splits,
                              _path + (k,))
                for k in specs}
    split = _split_of(splits, _path)
    if split is not None:
        return cut(params, split, rank, tp)
    return shard_leaf(params, leaf_pspec(specs, params, tp, rules), rank,
                      tp)


def _full_like(leaf: Any, spec) -> Any:
    """A meta leaf of `spec`'s full shape, packed as `leaf` is (a
    QTensor's data and scales shrunk along its axis by the bytes it
    packs and by its group)."""
    shape = tuple(spec.shape)
    if not isinstance(leaf, QTensor):
        return torch.empty(shape, dtype=leaf.dtype, device="meta")
    ax = leaf.axis % len(shape)

    def along(div):
        return tuple(s // div if i == ax else s for i, s in enumerate(shape))
    return QTensor(data=torch.empty(along(2 if leaf.bits == 4 else 1),
                                    dtype=leaf.data.dtype, device="meta"),
                   scales=torch.empty(along(leaf.group),
                                      dtype=leaf.scales.dtype, device="meta"),
                   bits=leaf.bits, group=leaf.group, axis=leaf.axis,
                   orig_shape=shape)


def _shapes(leaf: Any) -> Tuple:
    if isinstance(leaf, QTensor):
        return (tuple(leaf.orig_shape), tuple(leaf.data.shape),
                tuple(leaf.scales.shape))
    return tuple(leaf.shape)


def _leaves(tree: Any, specs: Any, _path: Tuple[str, ...] = ()):
    if isinstance(specs, dict):
        for k in specs:
            yield from _leaves(tree[k], specs[k], _path + (k,))
    else:
        yield _path, tree


def _map(tree: Any, specs: Any, fn) -> Any:
    if isinstance(specs, dict):
        return {k: _map(tree[k], specs[k], fn) for k in specs}
    return fn(tree, specs)


def rank_params(params: Any, specs: Any, rank: int, tp: int,
                rules: MeshRules = SERVE_RULES,
                splits: Optional[Dict[Tuple[str, str], Split]] = None
                ) -> Any:
    """Rank `rank`'s params from a full tree (`shard_tree`: a copy) or
    from a tree that is the rank's already, which comes back as it is,
    not a leaf copied: a fleet's replicas on one rank share one shard,
    as JAX's replicas share one mesh's arrays.  Decided for the whole
    tree, each leaf's shapes (a QTensor's orig_shape, data and scales)
    held to the full spec's and to what `shard_tree` makes of a full
    leaf packed as it is (so a packed leaf the rank keeps whole, or a
    segment `splits` keeps whole, counts as the rank's); a leaf the
    ranks hold whole looks the same either way and decides nothing.  A
    tree that is neither raises ValueError."""
    full = _map(params, specs, _full_like)
    want = shard_tree(full, specs, rank, tp, rules, splits)
    not_full, not_rank = [], []
    for (path, leaf), (_, whole), (_, mine) in zip(
            _leaves(params, specs), _leaves(full, specs),
            _leaves(want, specs)):
        if _shapes(leaf) != _shapes(whole):
            not_full.append((path, _shapes(leaf), _shapes(whole)))
        if _shapes(leaf) != _shapes(mine):
            not_rank.append((path, _shapes(leaf), _shapes(mine)))
    if not not_rank:
        return params
    if not not_full:
        return shard_tree(params, specs, rank, tp, rules, splits)
    (fp, fgot, fwant), (rp, rgot, rwant) = not_full[0], not_rank[0]
    raise ValueError(
        f"params at tp={tp} are neither the full tree nor rank {rank}'s "
        f"shard: {'/'.join(fp)} has shapes {fgot}, not the full {fwant}, "
        f"and {'/'.join(rp)} has {rgot}, not the rank's {rwant}")


def shard_specs(specs: Any, tp: int, rules: MeshRules = SERVE_RULES,
                splits: Optional[Dict[Tuple[str, str], Split]] = None,
                _path: Tuple[str, ...] = ()) -> Any:
    """A ParamSpec tree at one rank's shapes: a leaf `splits` names at
    its rule's width, every other dim its pspec shards divided by `tp`
    (the KV pools and the StateArena of a tp-way engine)."""
    if isinstance(specs, dict):
        return {k: shard_specs(v, tp, rules, splits, _path + (k,))
                for k, v in specs.items()}
    split = _split_of(splits, _path)
    if split is not None:
        shape = list(specs.shape)
        if split.splits():
            shape[split.dim] = sum(n for _, n in split.pieces(0, tp))
        return dataclasses.replace(specs, shape=tuple(shape))
    pspec = leaf_pspec(specs, specs, tp, rules)
    shape = tuple(s // tp if e is not None else s
                  for s, e in zip(specs.shape, pspec))
    return dataclasses.replace(specs, shape=shape)


def shard_state_specs(state_specs: Any, cfg, tp: int) -> Any:
    """`DecoderLM.decode_state_specs` at one rank's shapes: the paged
    pools by their pspecs (the rank's kv heads), the StateArena by
    `recurrent_splits`' rules alone (its heads; never an even cut)."""
    return {"paged": shard_specs(state_specs["paged"], tp),
            "arena": shard_specs(state_specs["arena"], tp,
                                 splits=recurrent_splits(cfg, tp))}


# ----------------------------------------------------------------------------
# the process group and the collectives
# ----------------------------------------------------------------------------
GROUP_TIMEOUT_S = 60.0     # a step's collectives: a dead peer ends the
#   others' wait within this (the launcher's default group has it too)
TICK_TIMEOUT_S = 365 * 86400.0     # a driven follower waits for rank 0's
#   next tick as long as the gateway is idle


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


def replica_groups(tp: int, timeout_s: float = GROUP_TIMEOUT_S):
    """(group, tick group) of one fleet replica's engine at tp > 1: two
    new groups over the default group's `tp` ranks, one for its step's
    collectives (their wait bounded by `timeout_s`) and one for its ticks
    (`dist.lockstep`; unbounded).  Replicas share the ranks, as JAX's
    replicas share one mesh's devices, but never a group: two driver
    threads on one group would interleave their collectives.  Every rank
    creates its replicas' groups in the same order."""
    import datetime

    import torch.distributed as dist
    serve_group(tp)
    ranks = list(range(tp))
    return (dist.new_group(ranks, timeout=datetime.timedelta(
                seconds=timeout_s)),
            dist.new_group(ranks, timeout=datetime.timedelta(
                seconds=TICK_TIMEOUT_S)))


def fleet_group(tp: int):
    """The group of a tensor-parallel fleet's channel
    (`lockstep.FleetChannel`), over the default group's `tp` ranks, made
    once with the replicas' groups; its wait is unbounded, as a tick
    group's (a follower waits for rank 0's next message while the
    gateway serves)."""
    import datetime

    import torch.distributed as dist
    serve_group(tp)
    return dist.new_group(list(range(tp)), timeout=datetime.timedelta(
        seconds=TICK_TIMEOUT_S))


class CountingGroup:
    """A stand-in for a `size`-rank group seen from `rank`: under
    `use_tp` its collectives move nothing (an all-reduce returns x, an
    all-gather x repeated) and are counted here, by kind with their
    result bytes (the dry-run's collectives, `launch/dryrun.py`)."""

    def __init__(self, size: int, rank: int = 0):
        self.size, self.rank = size, rank
        self.counts: Dict[str, int] = {}
        self.bytes: Dict[str, float] = {}

    def record(self, kind: str, result: torch.Tensor) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0.0) + \
            result.numel() * result.element_size()


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
    if isinstance(group, CountingGroup):
        return group.rank, group.size
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
    if isinstance(group, CountingGroup):
        group.record("all-reduce", x)
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
    if isinstance(group, CountingGroup):
        out = torch.cat([x] * group.size, dim=dim)
        group.record("all-gather", out)
        return out
    import torch.distributed as dist
    t0 = time.perf_counter()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    _count("all_gather", t0)
    return torch.cat(parts, dim=dim)
