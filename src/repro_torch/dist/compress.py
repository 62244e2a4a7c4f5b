"""Inter-pod gradient compression: INT8 quantization with error feedback
(PyTorch port of `repro.dist.compress`).

Between pods only gradients move (params are replicated per pod, FSDP
within).  Quantizing that traffic to INT8 cuts the inter-pod bytes 4x;
the residual (quantization error) is carried forward and added to the
next step's gradient, so the accumulated update is unbiased — the
standard error-feedback trick.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor INT8 quantization -> (int8 codes, f32 scale)."""
    scale = x.abs().amax() / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return q.to(torch.float32) * torch.where(scale > 0, safe,
                                             torch.zeros_like(safe))


def compress_decompress_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """What the receiving pod reconstructs from one tensor's gradient."""
    return _dq8(*_q8(x))


def _map(fn, *trees):
    """fn over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_error_state(grads: Any) -> Any:
    """Zero error-feedback residual matching a gradient tree."""
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)


def compress_with_feedback(grads: Any, err: Any) -> Tuple[Any, Any]:
    """(grads, residual) -> (decoded grads as the far pod sees them,
    updated residual).  Applied leaf-wise over the gradient tree."""
    def per_leaf(g, e):
        gf = g.to(torch.float32) + e
        dec = compress_decompress_roundtrip(gf)
        return dec.to(g.dtype), gf - dec

    pairs = _map(per_leaf, grads, err)
    return _pick(pairs, 0), _pick(pairs, 1)


def _pick(tree: Any, i: int) -> Any:
    """Element i of every (decoded, residual) leaf pair."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
