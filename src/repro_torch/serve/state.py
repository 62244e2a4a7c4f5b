"""StateArena: pooled per-lane recurrent decode state (PyTorch port of
`repro.serve.state`).

Attention layers page their KV because it grows with the sequence;
recurrent layers (Mamba2 conv + SSM state, m/sLSTM cells, zamba's
Mamba2 groups) carry constant-size per-sequence state, so the engine
pools it as fixed per-lane slots: one tree of device tensors (from
`DecoderLM.arena_state_specs`) whose lane axis rows are engine lanes.
`serve_step` reads and writes the whole arena every call, masking lanes
with n_new == 0, which lets mixed-length recurrent requests enter and
leave the running batch at any chunk boundary.

Lane lifecycle (engine-driven):
  admit (fresh)      -> reset_lane(lane): zero the slot
  preempt            -> save_lane(lane):  copy the lane's rows to host
  re-admit (resumed) -> restore_lane(lane, saved): copy them back

Save -> evict -> restore is bit-identical: the slot holds raw tensors,
nothing is re-quantized or recomputed, so a preempted pure-recurrent
request resumes mid-generation without re-prefilling a token.

Unlike the JAX arena, which rebinds `self.state` to new arrays on every
lane op, every op here writes the leaves in place: the leaves are
allocated once and the captured step graphs (serve/graphs.py) hold their
addresses.  The lane axis differs per leaf (stacked layer dims come
first); each leaf's is its spec's `lane_axis`.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch

from repro_torch.models.common import map_specs


class StateArena:
    def __init__(self, model, max_batch: int, specs=None, device=None):
        """`specs` takes a precomputed ParamSpec tree (the "arena" half of
        `DecoderLM.decode_state_specs`); defaults to asking the model.
        Leaves are allocated on `device`, zeroed."""
        self.max_batch = max_batch
        if specs is None:
            specs = model.arena_state_specs(max_batch)
        self._lane_axis = map_specs(lambda sp: sp.lane_axis, specs)
        self.state: Dict[str, Any] = map_specs(
            lambda sp: torch.zeros(sp.shape, dtype=sp.dtype, device=device),
            specs)
        self.keys = tuple(self.state)

    def _leaves(self) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor,
                                        int]]:
        def walk(tree, axes, path):
            if isinstance(tree, dict):
                for k in tree:
                    yield from walk(tree[k], axes[k], path + (k,))
            else:
                yield path, tree, axes
        return walk(self.state, self._lane_axis, ())

    # -- lane ops -------------------------------------------------------
    def reset_lane(self, lane: int) -> None:
        """Zero a lane's slot across every leaf (a fresh admission must
        never inherit a dead request's state)."""
        for _, leaf, ax in self._leaves():
            leaf.select(ax, lane).zero_()

    def save_lane(self, lane: int) -> Dict[Tuple[str, ...], torch.Tensor]:
        """Copy one lane's rows to host tensors for preemption: the whole
        recurrent state of one sequence, keyed by leaf path."""
        return {path: leaf.select(ax, lane).to("cpu", copy=True)
                for path, leaf, ax in self._leaves()}

    def restore_lane(self, lane: int, saved) -> None:
        """Copy a host snapshot back into a lane's slot."""
        for path, leaf, ax in self._leaves():
            leaf.select(ax, lane).copy_(saved[path])

    # -- accounting -----------------------------------------------------
    def state_bytes(self) -> int:
        return sum(leaf.numel() * leaf.element_size()
                   for _, leaf, _ in self._leaves())
