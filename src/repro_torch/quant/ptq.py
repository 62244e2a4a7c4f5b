"""Post-training quantization of a parameter tree (PyTorch).

Counterpart of `repro.quant.ptq`: the same eligible leaf names, the same
group choice (`_pick_group`) and the same axis rule (the embedding table
groups along d, axis 1, so row lookups and the tied logits head read
packed rows), so both packages pack a model identically.
`quantize_structs` is the allocation-free image of `quantize_params` on
the meta device (the dry-run packs a 235B model without a byte).
"""
from __future__ import annotations

import math
import warnings
from typing import Any

import torch

from .qarray import QTensor, quantize

# parameter names eligible for quantization (leaf key in the tree)
QUANT_KEYS = {
    "wq", "wk", "wv", "wo", "w_dkv", "w_uk", "w_uv",          # attention
    "w_gate", "w_up", "w_down",                               # dense ffn
    "we_gate", "we_up", "we_down", "ws_gate", "ws_up", "ws_down",  # moe
    "embed", "head",                                          # vocab
    "in_proj", "out_proj", "up_proj", "down_proj", "w_o",     # ssm blocks
    "ffn_up", "ffn_down",                                     # slstm ffn
}


def _pick_group(K: int, group: int, shard_hint: int) -> int:
    """Largest group <= `group` dividing K, preferring group counts
    (K/group) divisible by `shard_hint`.  Returns 0 when no group >= 8
    divides K (the caller then leaves the leaf unquantized).  Groups need
    not be powers of two: `_pick_group(11008, 128, 16)` is 86."""
    best = 0
    for g in range(min(group, K), 7, -1):
        if K % g:
            continue
        if (K // g) % shard_hint == 0:
            return g
        best = best or g
    return best


def quantize_leaf(name: str, x: Any, bits: int, group: int,
                  shard_hint: int = 16) -> Any:
    """Quantize one leaf when its name and shape make it eligible."""
    if not isinstance(x, torch.Tensor) or name not in QUANT_KEYS:
        return x
    if x.ndim < 2 or not x.is_floating_point():
        return x
    # contraction axis: axis 0 for 2D (K, N); axis 1 for stacked (L, K, N);
    # the embedding table groups along d (axis 1)
    axis = 1 if name == "embed" else x.ndim - 2
    K = x.shape[axis]
    g = _pick_group(K, group, shard_hint)
    if not g or K % g != 0 or (bits == 4 and K % 2 != 0):
        warnings.warn(f"ptq: no valid group size for leaf '{name}' (K={K}); "
                      "leaving it unquantized", stacklevel=2)
        return x
    return quantize(x, bits=bits, group=g, axis=axis)


def quantize_params(params: Any, bits: int = 4, group: int = 128,
                    shard_hint: int = 16) -> Any:
    """Walk a nested dict; replace eligible weights with QTensors."""
    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return quantize_leaf(name, tree, bits, group, shard_hint)
    return walk(params, "")


def quantize_structs(spec_tree: Any, bits: int = 4, group: int = 128,
                     shard_hint: int = 16) -> Any:
    """ParamSpec tree -> `quantize_params` of meta tensors at the specs'
    shapes and dtypes: eligible weights become QTensors of meta data
    and scales, every other leaf stays a meta tensor."""
    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        return torch.empty(tuple(tree.shape), dtype=tree.dtype,
                           device="meta")
    return quantize_params(meta(spec_tree), bits, group, shard_hint)


def quantized_fraction(qparams: Any) -> float:
    """Fraction of parameter *elements* now stored quantized (JAX's
    measure: a QTensor counts its orig_shape, a tensor its shape)."""
    qn = tn = 0

    def walk(tree):
        nonlocal qn, tn
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, QTensor):
            n = math.prod(tree.orig_shape)
            qn += n
            tn += n
        elif isinstance(tree, torch.Tensor):
            tn += tree.numel()
    walk(qparams)
    return qn / max(tn, 1)
