"""Model substrate: parameter specs, init, norms, RoPE, the loss
(PyTorch).

Counterpart of `repro.models.common`.  Parameters are declared as
`ParamSpec` trees (plain nested dicts), materialized by `init_params`
with an explicit `torch.Generator` and device.  The distributions follow
the JAX package (normal with std 1/sqrt(fan_in), `embed` with an
explicit std), but the draws differ from `jax.random`'s, so tests carry
weights across with `repro_torch.convert` instead of re-drawing them.

Every `ParamSpec` carries the JAX package's logical axes (`BATCH`,
`FSDP`, `TP`, ...), which `repro_torch.dist.axes` maps onto a mesh:
tensor-parallel serving (`repro_torch.dist.shard`) slices each rank's
part of a leaf by them.  They are data only and change no computation.

`take_rows` and the loss's gather have backward passes without float
atomics (a sorted segment sum, a scatter onto distinct positions), so a
training step on the card is bit-reproducible.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Tree = Any

# logical axis names (mapped to mesh axes in dist/axes.py)
BATCH = "batch"      # activation batch            -> (pod, data)
FSDP = "fsdp"        # param fully-sharded dim     -> data
TP = "tp"            # tensor-parallel dim          -> model
EXPERT = "expert"    # MoE expert dim               -> model
KV_SEQ = "kv_seq"    # decode KV sequence (split-K) -> model
SEQ = "seq"          # long-context activation seq  -> data
LAYERS = "layers"    # stacked-scan layer dim       -> replicated
NONE = None


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    axes: Tuple[Optional[str], ...] = ()   # one logical axis per dim
    init: str = "normal"          # normal | zeros | ones | embed
    scale: Optional[float] = None  # None => 1/sqrt(fan_in)
    lane_axis: Optional[int] = None  # a decode-state leaf's per-lane axis

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"ParamSpec {self.shape}: axes {self.axes} "
                             "name one logical axis per dim")

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
        """Prepend a stacked-layers dim (the lane axis moves with it),
        replicated: its logical axis is NONE, as the JAX package's."""
        lane = None if self.lane_axis is None else self.lane_axis + 1
        return dataclasses.replace(self, shape=(n, *self.shape),
                                   axes=(NONE, *self.axes), lane_axis=lane)


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


def param_count(tree: Tree) -> int:
    """Elements of every ParamSpec of a tree."""
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    return math.prod(tree.shape)


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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in f32 with the population variance
    (`jnp.var`'s; torch's default is the unbiased one)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


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


SCANS: list = []    # stand-ins for `scan`, innermost last


def scan(step: Callable, carry: Tuple[torch.Tensor, ...],
         xs: Tuple[torch.Tensor, ...], consts: Tuple[torch.Tensor, ...] = ()
         ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """JAX's `lax.scan` over dim 1 of `xs`: `carry, y = step(carry,
    *[x[:, t] for x in xs], *consts)` for each t in order; returns the
    last carry and the y's stacked on dim 1.  A stand-in pushed on
    `SCANS` runs instead (the dry-run's counter, `launch/metarun.py`,
    runs one step for all)."""
    if SCANS:
        return SCANS[-1](step, carry, xs, consts)
    ys = []
    for t in range(xs[0].shape[1]):
        carry, y = step(carry, *[x[:, t] for x in xs], *consts)
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


class _TakeRows(torch.autograd.Function):
    """table[idx] whose backward sums each row's gradients in a fixed
    order: the indices sorted (stably), one segment sum per distinct
    row, written to distinct rows.  Indexing's own backward accumulates
    with float atomics on the card, in an order that changes run to
    run."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        g = grad.reshape(flat.numel(), *ctx.shape[1:])
        rows, order = torch.sort(flat, stable=True)
        uniq, counts = torch.unique_consecutive(rows, return_counts=True)
        sums = torch.segment_reduce(g[order], "sum", lengths=counts, axis=0)
        out = grad.new_zeros(ctx.shape)
        out[uniq] = sums
        return out, None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] along dim 0 (an embedding lookup, the MoE combine's
    gather); under autograd its backward is deterministic
    (`_TakeRows`), otherwise it is plain indexing."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _TakeRows.apply(table, idx)
    return table[idx]


class _TakeLast(torch.autograd.Function):
    """x[..., idx[...]] along the last dim; the backward writes each
    row's one gradient with `scatter_` (no atomics: one position a
    row)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return x.gather(-1, idx[..., None])[..., 0]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        out = grad.new_zeros(ctx.shape)
        return out.scatter_(-1, idx[..., None], grad[..., None]), None


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -100) -> torch.Tensor:
    """Mean CE over non-ignored positions: logits (b, s, v), labels (b,
    s).  Labels are clamped at 0 for the gather, `ignore_id` positions
    masked out, and the sum divided by max(1, kept), as in JAX."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = _TakeLast.apply(lf, labels.long().clamp_min(0))
    mask = (labels != ignore_id).to(torch.float32)
    return ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)
