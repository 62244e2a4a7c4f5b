"""Model substrate: parameter specs, init, norms, RoPE (PyTorch).

Counterpart of `repro.models.common`.  Parameters are declared as
`ParamSpec` trees (plain nested dicts), materialized by `init_params`
with an explicit `torch.Generator` and device.  The distributions follow
the JAX package (normal with std 1/sqrt(fan_in), `embed` with an
explicit std), but the draws differ from `jax.random`'s, so tests carry
weights across with `repro_torch.convert` instead of re-drawing them.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Tree = Any


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # normal | zeros | ones | embed
    scale: Optional[float] = None  # None => 1/sqrt(fan_in)
    lane_axis: Optional[int] = None  # a decode-state leaf's per-lane axis

    def fan_in(self) -> int:
        if len(self.shape) <= 1:
            return self.shape[0] if self.shape else 1
        return math.prod(self.shape[:-1])

    def materialize(self, generator: torch.Generator,
                    device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init == "embed":
            std = self.scale if self.scale is not None else 1.0
        else:
            std = self.scale if self.scale is not None else \
                1.0 / math.sqrt(max(self.fan_in(), 1))
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * std).to(self.dtype)

    def stacked(self, n: int) -> "ParamSpec":
        """Prepend a stacked-layers dim (the lane axis moves with it)."""
        lane = None if self.lane_axis is None else self.lane_axis + 1
        return dataclasses.replace(self, shape=(n, *self.shape),
                                   lane_axis=lane)


def map_specs(fn: Callable[[ParamSpec], Any], tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_specs(tree: Tree, n: int) -> Tree:
    return map_specs(lambda s: s.stacked(n), tree)


def init_params(tree: Tree, generator: torch.Generator, device=None,
                dtype_override: Optional[torch.dtype] = None,
                leaf_fn: Optional[Callable[[str, torch.Tensor], Any]] = None
                ) -> Tree:
    """Materialize a ParamSpec tree leaf by leaf.  `leaf_fn(name, x)`
    transforms each leaf right after it is drawn (e.g.
    `ptq.quantize_leaf`), so a full-width model is quantized without
    ever holding every float weight at once."""
    def walk(t, name):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        x = t.materialize(generator, device)
        if dtype_override is not None and x.is_floating_point():
            x = x.to(dtype_override)
        return leaf_fn(name, x) if leaf_fn is not None else x
    return walk(tree, "")


def tree_to(tree: Tree, device) -> Tree:
    """Move every tensor (and QTensor) of a nested dict to `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ----------------------------------------------------------------------------
# numerics blocks
# ----------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             scale_plus_one: bool = False) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = scale.to(torch.float32)
    if scale_plus_one:
        w = w + 1.0
    return (y * w).to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding. positions: (...,) int."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / torch.pow(theta, exps)     # f32: theta is a scalar
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim/2).
    Split-halves convention (llama/gemma style)."""
    half = x.shape[-1] // 2
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)



def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


# what each name computes in the JAX package: `jax.nn.gelu` defaults to
# approximate=True, so "gelu" is the tanh form there too
ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": swish,
    "gelu": _gelu_tanh,
    "gelu_tanh": _gelu_tanh,
    "relu": torch.relu,
}
