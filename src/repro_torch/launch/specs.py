"""Dry-run cell construction: meta-tensor inputs, step functions and
each argument leaf's per-device pspec for every (architecture x
input-shape x mesh x precision).

No allocation happens here: params, optimizer state, KV caches and
batches are all tensors on the meta device (a 235B-param cell runs on a
laptop).  A mesh is a `{axis: size}` mapping (`launch/mesh.py`).

A pspec is the port's tuple form (`dist/axes.py`), one entry a dim; a
QTensor leaf has one pspec for its data and its scales
(`dist/shard.mesh_leaf_pspec`, JAX's `qtree_shardings`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.registry import SHAPES, get_config
from repro_torch.dist.axes import (MULTI_POD_RULES, SINGLE_POD_RULES,
                                   MeshRules, axis_size, sanitize_pspec)
from repro_torch.dist.shard import mesh_leaf_pspec, shard_shape
from repro_torch.models import DecoderLM
from repro_torch.models.common import map_specs
from repro_torch.quant.ptq import quantize_structs
from repro_torch.quant.qarray import QTensor
from repro_torch.train.adamw import AdamW, AdamWState, cosine_schedule

# long-context rules: batch=1 cannot shard -> KV sequence spreads over
# both mesh axes (split-K over the whole pod)
LONG_SINGLE_RULES = MeshRules({
    "batch": None, "fsdp": "data", "tp": "model", "expert": "model",
    "kv_seq": ("model", "data"), "seq": None, "layers": None,
})
LONG_MULTI_RULES = MeshRules({
    "batch": None, "fsdp": "data", "tp": "model", "expert": "model",
    "kv_seq": ("pod", "model", "data"), "seq": None, "layers": None,
})

# serve-mode rules: decode is read-only over weights, so FSDP sharding
# only adds a per-step all-gather; weights shard over the model axis and
# replicate over data (batch).  KV stays split-K over `model`.
SERVE_SINGLE_RULES = MeshRules({
    "batch": ("data",), "fsdp": None, "tp": "model", "expert": "model",
    "kv_seq": "model", "seq": "data", "layers": None,
})
SERVE_MULTI_RULES = MeshRules({
    "batch": ("pod", "data"), "fsdp": None, "tp": "model",
    "expert": "model", "kv_seq": "model", "seq": "data", "layers": None,
})
SERVE_LONG_SINGLE_RULES = MeshRules({
    "batch": None, "fsdp": None, "tp": "model", "expert": "model",
    "kv_seq": ("model", "data"), "seq": None, "layers": None,
})
SERVE_LONG_MULTI_RULES = MeshRules({
    "batch": None, "fsdp": None, "tp": "model", "expert": "model",
    "kv_seq": ("pod", "model", "data"), "seq": None, "layers": None,
})

# reduced shapes for the tests (same code path, tiny dims)
SMOKE_SHAPES = {
    "train_4k": (64, 8, "train"),
    "prefill_32k": (64, 4, "prefill"),
    "decode_32k": (64, 8, "decode"),
    "long_500k": (128, 1, "decode"),
}

Mesh = Mapping[str, int]


def rules_for(mesh_shape: Mesh, shape_id: str,
              serve_sharding: bool = False) -> MeshRules:
    multi = "pod" in mesh_shape
    if serve_sharding:
        if shape_id == "long_500k":
            return SERVE_LONG_MULTI_RULES if multi else \
                SERVE_LONG_SINGLE_RULES
        return SERVE_MULTI_RULES if multi else SERVE_SINGLE_RULES
    if shape_id == "long_500k":
        return LONG_MULTI_RULES if multi else LONG_SINGLE_RULES
    return MULTI_POD_RULES if multi else SINGLE_POD_RULES


def meta_tensor(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ----------------------------------------------------------------------------
# model inputs
# ----------------------------------------------------------------------------
def input_specs(arch_id: str, shape_id: str, multi_pod: bool = False,
                shapes: Optional[dict] = None, cfg: Optional[Any] = None
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of this cell, JAX's
    shapes and dtypes."""
    cfg = cfg if cfg is not None else get_config(arch_id)
    seq, batch, kind = (shapes or SHAPES)[shape_id]
    s = 1 if kind == "decode" else seq
    specs: Dict[str, torch.Tensor] = {}
    if cfg.embed_inputs:
        specs["tokens"] = meta_tensor((batch, s), torch.int32)
    else:
        specs["embeddings"] = meta_tensor((batch, s, cfg.d_model), torch.bfloat16)
    if kind == "train":
        specs["labels"] = meta_tensor((batch, s), torch.int32)
    return specs


def input_pspecs(inputs: Dict[str, torch.Tensor], mesh_shape: Mesh,
                 rules: MeshRules) -> Dict[str, tuple]:
    """The batch dim over the rules' batch axes, the rest replicated."""
    b = rules.get("batch")
    return {k: sanitize_pspec((b,) + (None,) * (v.ndim - 1),
                              tuple(v.shape), mesh_shape)
            for k, v in inputs.items()}


# ----------------------------------------------------------------------------
# cell = (step fn, meta args, per-device pspecs)
# ----------------------------------------------------------------------------
@dataclass
class Cell:
    arch: str
    shape_id: str
    kind: str
    fn: Callable
    args: Tuple[Any, ...]
    pspecs: Tuple[Any, ...]       # mirrors args: one pspec a leaf
    donate: Tuple[int, ...]
    model: DecoderLM
    mesh_shape: Mesh
    rules: MeshRules


def tree_pspecs(spec_tree: Any, leaves: Any, mesh_shape: Mesh,
                rules: MeshRules) -> Any:
    """One pspec a leaf of `leaves` (a tree mirroring the ParamSpec tree
    `spec_tree`; QTensor leaves get one pspec for data and scales)."""
    if isinstance(spec_tree, dict):
        return {k: tree_pspecs(v, leaves[k], mesh_shape, rules)
                for k, v in spec_tree.items()}
    return mesh_leaf_pspec(spec_tree, leaves, mesh_shape, rules)


def leaf_device_bytes(leaf: Any, pspec: tuple, mesh_shape: Mesh) -> int:
    """One device's bytes of a leaf under its pspec."""
    if isinstance(leaf, QTensor):
        return sum(leaf_device_bytes(t, pspec, mesh_shape)
                   for t in (leaf.data, leaf.scales))
    n = 1
    for d in shard_shape(tuple(leaf.shape), pspec, mesh_shape):
        n *= d
    return n * leaf.element_size()


def leaves_with_pspecs(args: Any, pspecs: Any):
    """(leaf, pspec) of every leaf of `args` (nested dicts, tuples and
    NamedTuples, mirrored by `pspecs`; a QTensor is one leaf)."""
    if isinstance(args, dict):
        for k in args:
            yield from leaves_with_pspecs(args[k], pspecs[k])
    elif isinstance(args, (list, tuple)):
        for a, p in zip(args, pspecs):
            yield from leaves_with_pspecs(a, p)
    else:
        yield args, pspecs


def meta_tree(specs: Any, requires_grad: bool = False) -> Any:
    """A meta tensor for every ParamSpec of a tree, at its dtype."""
    def leaf(s):
        t = meta_tensor(s.shape, s.dtype)
        if requires_grad and t.is_floating_point():
            t.requires_grad_(True)
        return t
    return map_specs(leaf, specs)


def build_cell(arch_id: str, shape_id: str, mesh_shape: Mesh,
               quant: str = "bf16", cfg: Optional[Any] = None,
               shapes: Optional[dict] = None,
               serve_sharding: bool = False) -> Cell:
    """quant: bf16 | int8 | int4 (decode shapes only: the paper's serve
    precision axis).  `cfg` overrides the registry config (probes pass
    reduced-layer variants); `shapes` overrides SHAPES (smoke);
    `serve_sharding` uses the no-FSDP decode rules."""
    cfg = cfg if cfg is not None else get_config(arch_id)
    seq, batch, kind = (shapes or SHAPES)[shape_id]
    rules = rules_for(mesh_shape, shape_id, serve_sharding)
    model = DecoderLM(cfg)
    specs = model.param_specs()
    inp = input_specs(arch_id, shape_id, "pod" in mesh_shape,
                      shapes=shapes, cfg=cfg)
    inp_ps = input_pspecs(inp, mesh_shape, rules)

    def cell(fn, args, pspecs, donate):
        return Cell(arch_id, shape_id, kind, fn, args, pspecs, donate,
                    model, mesh_shape, rules)

    if kind == "train":
        # the specs' dtypes (bf16), f32 moments and an int32 step, as
        # the JAX package's train cell
        params = meta_tree(specs, requires_grad=True)
        param_ps = tree_pspecs(specs, params, mesh_shape, rules)
        f32 = map_specs(lambda s: meta_tensor(s.shape, torch.float32), specs)
        opt_state = AdamWState(
            step=meta_tensor((), torch.int32), mu=f32,
            nu=map_specs(lambda s: meta_tensor(s.shape, torch.float32), specs))
        opt_ps = AdamWState(step=(), mu=tree_pspecs(specs, f32, mesh_shape,
                                                    rules),
                            nu=tree_pspecs(specs, f32, mesh_shape, rules))
        from repro_torch.train.trainer import make_train_step
        train_step = make_train_step(
            model, AdamW(lr=cosine_schedule(3e-4, 100, 10000)))
        return cell(train_step, (params, opt_state, inp),
                    (param_ps, opt_ps, inp_ps), (0, 1))

    if kind == "prefill":
        params = meta_tree(specs)
        param_ps = tree_pspecs(specs, params, mesh_shape, rules)

        if cfg.family in ("dense", "moe"):
            def prefill_step(p, batch_):
                with torch.no_grad():
                    return model.prefill(p, batch_)
        else:
            def prefill_step(p, batch_):
                with torch.no_grad():
                    return model.forward(p, batch_)[:, -1:, :]
        return cell(prefill_step, (params, inp), (param_ps, inp_ps), ())

    # ---- decode -----------------------------------------------------------
    if quant in ("int4", "int8"):
        params = quantize_structs(specs, bits=4 if quant == "int4" else 8,
                                  group=128)
    else:
        params = meta_tree(specs)
    param_ps = tree_pspecs(specs, params, mesh_shape, rules)
    cache_specs = model.cache_specs(batch, seq)
    cache = meta_tree(cache_specs)
    cache_ps = tree_pspecs(cache_specs, cache, mesh_shape, rules)
    pos = meta_tensor((), torch.int32)

    def serve_step(p, c, batch_, pos_):
        with torch.no_grad():
            return model.decode_step(p, c, batch_, pos_)

    return cell(serve_step, (params, cache, inp, pos),
                (param_ps, cache_ps, inp_ps, ()), (1,))


def n_devices(mesh_shape: Mesh) -> int:
    return axis_size(mesh_shape, tuple(mesh_shape))
