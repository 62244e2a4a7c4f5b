"""AdamW and learning-rate schedules (PyTorch port of
`repro.train.adamw`), with the JAX package's arithmetic: the gradient
clipped by min(1, clip_norm / (|g| + 1e-9)), the moments and bias
corrections in f32 at step + 1, the learning rate evaluated at the new
step, weight decay on every leaf of two or more dims (the stacked
layers' norm scales and biases are (L, d), so they decay, as in JAX).

The update is in place, under `torch.no_grad`: JAX's functional update
holds a second copy of the parameters, which at full width does not fit
beside the gradients and moments.  The optimizer state is a tree shaped
like the params, in f32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Union

import torch

Tree = Any


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """Leaves of nested dicts and lists, dict keys sorted as
    `jax.tree_util` orders them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like: Tree, leaves: List[Any]) -> Tree:
    """The inverse of `tree_leaves` on `like`'s structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


class AdamWState(NamedTuple):
    step: torch.Tensor    # () int32
    mu: Tree              # first moment  (f32)
    nu: Tree              # second moment (f32)


@dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Tree) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        leaves = tree_leaves(params)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            mu=tree_unflatten(params, [zeros(p) for p in leaves]),
            nu=tree_unflatten(params, [zeros(p) for p in leaves]))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree
               ) -> AdamWState:
        """Apply one step to `params` and `state.mu` / `state.nu` in
        place; returns the state at the new step.  f32 gradients are
        consumed (clipped in place)."""
        step = state.step + 1
        gs = [g.to(torch.float32) for g in tree_leaves(grads)]
        if self.clip_norm:
            scale = torch.clamp(self.clip_norm / (global_norm(gs) + 1e-9),
                                max=1.0)
            for g in gs:
                g.mul_(scale)
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, stepf)
        c2 = 1.0 - torch.pow(b2, stepf)
        lr = self._lr(step)
        for p, m, v, g in zip(tree_leaves(params), tree_leaves(state.mu),
                              tree_leaves(state.nu), gs):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            delta = (m / c1).div_((v / c2).sqrt_().add_(self.eps))
            if self.weight_decay and p.ndim >= 2:   # decay matrices only
                delta.add_(p, alpha=self.weight_decay)
            delta.mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(delta)
            else:
                p.copy_(p.to(torch.float32).sub_(delta))
        return AdamWState(step=step, mu=state.mu, nu=state.nu)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x ** 2) in f32, the leaves'
    sums added in leaf order as JAX's Python `sum` adds them."""
    total = None
    for x in tree_leaves(tree):
        s = x.to(torch.float32).square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    floor: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1.0 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)
    return fn
