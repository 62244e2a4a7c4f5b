"""Decoder-only LM (PyTorch port of `repro.models.model.DecoderLM`)
with every path of the JAX model: the full-sequence forward and loss
(training), `prefill` and `decode_step` on a contiguous cache, and the
serve path of the JAX engine, for every family: dense and MoE decoders
(GQA or multi-head latent attention (MLA, deepseek), SwiGLU, gated or
plain GELU FFNs or routed experts with shared experts and leading dense
layers, RMSNorm or LayerNorm, tied or untied heads, token or
frontend-stub embedding inputs, and gemma's features: sliding-window /
global layers, attention and final softcaps, QK-norm, post-block norms,
scaled embeddings, a second RoPE base for local layers), xLSTM (groups
of mLSTM blocks closed by an sLSTM block) and zamba (groups of Mamba2
blocks, each followed by a shared attention + MLP block with per-site
LoRA, then trailing Mamba2 blocks).

    model  = DecoderLM(cfg)
    specs  = model.param_specs()                     # ParamSpec tree
    params = init_params(specs, generator, device)   # nested dict
    loss   = model.loss(params, batch)               # training loss
    logits = model.forward(params, inputs)           # (b, s, vocab) f32
    logits, kv = model.prefill(params, inputs)       # last position
    cache  = model.cache_specs(batch, max_seq)       # ParamSpec tree
    logits, cache = model.decode_step(params, cache, inputs, pos)
    logits, cache = model.serve_step(params, cache, inputs, tables,
                                     lengths, n_new)
    logits, cache = model.paged_verify_step(...)     # speculative verify

Parameters keep the JAX package's tree and stacked-layer layout
(`blocks` leaves carry a leading layer dim; a MoE model's leading dense
layers are `first_blocks`, with their own `attn_first` pools; xLSTM's
`mlstm` stack is doubly stacked, (groups, slstm_every - 1, ...), as
zamba's `mamba` is (groups, shared_every, ...)), so `repro_torch.convert`
carries weights across leaf for leaf.  The forward unbinds each stacked
leaf once per call (its backward is one `stack`; indexing a stack per
layer would build a zero-filled gradient of the whole stack in every
layer's backward).  Decode state is updated in place, where JAX returns
new arrays: the contiguous cache of `cache_specs` (JAX's shapes and
dtypes), and the engine's paged KV pools `(L, n_pages + 1, page_size,
g, hd)` (MLA's latent pools `(L, n_pages + 1, page_size, r)` and `(L,
..., rope_d)`; zamba's at the shared block's shape, one per group) and
per-lane recurrent leaves (`arena_state_specs`), flattened into one
cache dict.  `decode_step` of a recurrent layer is its serve step with
every lane valid.

A config no path can run raises NotImplementedError at construction
(`_unsupported`).  The serve path takes token inputs only: the engine
and the serve launcher refuse a frontend-stub arch, as the JAX
package's do (such an arch trains through `loss` and decodes through
`decode_step`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.shard import (tp_all_gather, tp_all_reduce,
                                    tp_rank_and_size)
from repro_torch.kernels.ops import qmatmul as qmm
from repro_torch.quant.qarray import QTensor, dequant_rows

from .attention import (empty_cache_spec, forward_ropes, layer_theta,
                        page_rows, paged_cache_spec, rope_by_theta)
from .blocks import (apply_norm, mamba_block, mamba_block_serve,
                     mamba_block_specs, mlstm_block, mlstm_block_serve,
                     mlstm_block_specs, norm_specs, one_token, slstm_block,
                     slstm_block_serve, slstm_block_specs, transformer_block,
                     transformer_block_decode, transformer_block_paged,
                     transformer_block_specs, zamba_lora_specs,
                     zamba_shared_block, zamba_shared_block_decode,
                     zamba_shared_block_paged, zamba_shared_cfg,
                     zamba_shared_specs)
from .common import (ACTIVATIONS, FSDP, TP, ParamSpec, cross_entropy_loss,
                     param_count, softcap, stack_specs, take_rows)
from .config import ModelConfig
from .ssm import mamba2_cache_spec, mlstm_cache_spec, slstm_cache_spec

Params = Dict[str, Any]

FAMILIES = ("dense", "moe", "xlstm", "zamba")


def _unsupported(cfg: ModelConfig) -> List[str]:
    """What no path of the port can run."""
    out = []
    if cfg.family not in FAMILIES:
        out.append(f"family {cfg.family!r}")
    elif cfg.family in ("xlstm", "zamba") and cfg.ssm is None:
        out.append(f"family {cfg.family!r} without an SSMConfig")
    elif cfg.family == "zamba" and cfg.zamba is None:
        out.append("family 'zamba' without a ZambaConfig")
    if cfg.attn_kind not in ("gqa", "mla") or \
            (cfg.attn_kind == "mla") != (cfg.mla is not None):
        out.append(f"attention {cfg.attn_kind!r}")
    if cfg.norm_kind not in ("rms", "layer"):
        out.append(f"norm {cfg.norm_kind!r}")
    if cfg.ffn_act not in ACTIVATIONS:
        out.append(f"ffn activation {cfg.ffn_act!r}")
    return out


def _lead(tree: Any) -> int:
    """The leading (stacked) dim of a tree's leaves."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _take(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def _stack_trees(trees: List[Dict[str, torch.Tensor]]
                 ) -> Dict[str, torch.Tensor]:
    """Per-layer trees' leaves stacked on a new first dim ({} for no
    layer)."""
    return {k: torch.stack([t[k] for t in trees])
            for k in (trees[0] if trees else ())}


def _unbind(tree: Any) -> List[Any]:
    """Per-layer trees of a stacked tree, each leaf split once
    (`unbind`: under autograd its backward is one `stack`)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()}
                for i in range(_lead(tree))]
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    return [tree[i] for i in range(tree.shape[0])]     # a packed QTensor


class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        bad = _unsupported(cfg)
        if bad:
            raise NotImplementedError(
                f"{cfg.name}: the PyTorch port cannot run this config; "
                f"not ported: {', '.join(bad)}")
        self.cfg = cfg
        # the embedding scale rounded to the embeddings' dtype first, as
        # the JAX package multiplies by jnp.asarray(sqrt(d), h.dtype)
        # (bf16: sqrt(2560) = 50.596 -> 50.5); a Python float per dtype,
        # so a step makes no tensor from host values
        root = math.sqrt(cfg.d_model)
        self._embed_scale = {dt: float(torch.tensor(root, dtype=dt))
                             for dt in (torch.float32, torch.bfloat16)}
        self.n_first = (cfg.moe.first_dense_layers
                        if cfg.moe is not None else 0)
        # per-layer window flags of `blocks`, which start at layer
        # n_first; the leading dense layers are global
        self._local = [cfg.is_local_layer(i)
                       for i in range(self.n_first, cfg.n_layers)]
        self._views: Dict[Any, Any] = {}   # key -> (stacked tree, views)

    def _groups(self):
        """(groups, layers per group, trailing layers) of a recurrent
        family: xLSTM's groups hold slstm_every - 1 mLSTM layers and one
        sLSTM layer; zamba's shared_every Mamba2 layers and one shared
        block invocation, then n_layers mod shared_every Mamba2 layers."""
        cfg = self.cfg
        per = (cfg.ssm.slstm_every if cfg.family == "xlstm"
               else cfg.zamba.shared_every)
        n_groups = cfg.n_layers // per
        return n_groups, per, cfg.n_layers - n_groups * per

    # ------------------------------------------------------------------
    def param_specs(self) -> Params:
        cfg = self.cfg
        sp: Params = {"embed": ParamSpec((cfg.vocab, cfg.d_model),
                                         axes=(TP, FSDP), init="embed",
                                         scale=cfg.d_model ** -0.5)}
        if not cfg.tie_embeddings:
            sp["head"] = ParamSpec((cfg.d_model, cfg.vocab), axes=(FSDP, TP))
        sp["ln_final"] = norm_specs(cfg)
        if cfg.family == "xlstm":
            n_groups, per, tail = self._groups()
            if tail:
                raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is "
                                 f"not a multiple of slstm_every {per}")
            sp["mlstm"] = stack_specs(
                stack_specs(mlstm_block_specs(cfg), per - 1), n_groups)
            sp["slstm"] = stack_specs(slstm_block_specs(cfg), n_groups)
            return sp
        if cfg.family == "zamba":
            n_groups, per, tail = self._groups()
            sp["mamba"] = stack_specs(
                stack_specs(mamba_block_specs(cfg), per), n_groups)
            if tail:
                sp["mamba_tail"] = stack_specs(mamba_block_specs(cfg), tail)
            sp["shared"] = zamba_shared_specs(cfg)
            sp["lora"] = stack_specs(zamba_lora_specs(cfg), n_groups)
            return sp
        if self.n_first:
            sp["first_blocks"] = stack_specs(
                transformer_block_specs(
                    cfg, dense_ffn_override=cfg.moe.first_dense_d_ff),
                self.n_first)
        sp["blocks"] = stack_specs(transformer_block_specs(cfg),
                                   cfg.n_layers - self.n_first)
        return sp

    def n_params(self) -> int:
        return param_count(self.param_specs())

    # ------------------------------------------------------------------
    def _embed(self, params: Params, inputs: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
        """The token rows of the table, or a frontend stub's
        `inputs["embeddings"]` (b, s, d) when `embed_inputs` is off.
        A tensor-parallel rank holding its slice of the vocab rows
        (`dist.shard`) looks up the tokens in its range, zeros the
        others, and the ranks' rows are summed (`tp_all_reduce`)."""
        cfg = self.cfg
        if not cfg.embed_inputs:
            h = inputs["embeddings"].to(cfg.activation_dtype())
        else:
            table, tokens = params["embed"], inputs["tokens"].long()
            rows = table.shape[0]
            mine = None
            if rows != cfg.vocab:               # a vocab-parallel slice
                tokens = tokens - tp_rank_and_size()[0] * rows
                mine = (tokens >= 0) & (tokens < rows)
                tokens = tokens.clamp(0, rows - 1)
            if isinstance(table, QTensor):
                h = dequant_rows(table, tokens, cfg.activation_dtype())
            else:
                h = take_rows(table, tokens)
            if mine is not None:
                h = tp_all_reduce(h.masked_fill(~mine[..., None], 0))
        if cfg.embed_scale:
            h = h * self._embed_scale[h.dtype]
        return h.to(cfg.activation_dtype())

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """f32 logits of the final-normed h: the weight at h's dtype
        (JAX's `w.astype(h.dtype)`), the product summed in f32.  A
        tensor-parallel rank holding a slice of the table's (or the
        untied head's) vocab computes its columns, softcaps them, and
        the ranks' columns are gathered in rank order
        (`tp_all_gather`)."""
        cfg = self.cfg
        h = apply_norm(params["ln_final"], cfg, h)
        tied = cfg.tie_embeddings or "head" not in params
        w = params["embed"] if tied else params["head"]
        if isinstance(w, QTensor):
            # the packed (V, d) table contracts over its d rows
            logits = qmm(h, w).to(torch.float32)
        else:
            wf = w.to(h.dtype).to(torch.float32)
            logits = torch.matmul(h.to(torch.float32),
                                  wf.t() if tied else wf)
        if cfg.final_softcap:
            logits = softcap(logits, cfg.final_softcap)
        if logits.shape[-1] != cfg.vocab:       # vocab-parallel columns
            logits = tp_all_gather(logits, -1)
        return logits

    def _stack_views(self, tree: Any, key: Any, depth: int = 1) -> List:
        """Per-layer views of the stacked `tree` (params or a cache
        leaf group), `depth` stacked dims deep (lists of lists for a
        doubly stacked tree), built once per tree (views share storage;
        no copy)."""
        seen = self._views.get(key)
        if seen is None or seen[0] is not tree:
            def split(t, d):
                n = _lead(t)
                parts = [_take(t, i) for i in range(n)]
                return parts if d == 1 else [split(x, d - 1) for x in parts]
            seen = self._views[key] = (tree, split(tree, depth))
        return seen[1]

    def _layer_params(self, params: Params, name: str) -> List[Params]:
        """Per-layer views of `params[name]` (`blocks` or
        `first_blocks`)."""
        return self._stack_views(params[name], name)

    # ------------------------------------------------------------------
    def forward(self, params: Params, inputs: Dict[str, torch.Tensor],
                return_kv: bool = False):
        """Full-sequence forward (training, prefill): inputs {tokens: (b,
        s)} or {embeddings: (b, s, d)} -> f32 logits (b, s, vocab),
        causal over positions 0..s-1, every recurrent state from zero.
        With `cfg.remat` each layer's activations are recomputed in the
        backward (`torch.utils.checkpoint`, JAX's `jax.checkpoint`).
        With `return_kv`, (logits, kv): the attention layers' K/V rows
        stacked over layers in JAX's tree ({"attn"[, "attn_first"]} for
        dense and MoE, MLA's latent rows; {"attn"} over zamba's groups;
        None for xlstm)."""
        cfg = self.cfg
        h = self._embed(params, inputs)
        positions = torch.arange(h.shape[1], device=h.device)
        if cfg.family == "xlstm":
            h, kv = self._forward_xlstm(params, h), None
        elif cfg.family == "zamba":
            h, kv = self._forward_zamba(params, h, positions, return_kv)
        else:
            h, kv = self._forward_transformer(params, h, positions,
                                              return_kv)
        logits = self._logits(params, h)
        return (logits, kv) if return_kv else logits

    def _layer(self, block, h: torch.Tensor):
        """block(h), recomputed in the backward when `cfg.remat`."""
        if self.cfg.remat:
            return checkpoint(block, h, use_reentrant=False)
        return block(h)

    def _forward_transformer(self, params, h, positions, return_kv):
        cfg = self.cfg
        ropes = forward_ropes(cfg, positions,
                              [False] * self.n_first + self._local)
        kvs = {}
        stages = [("first_blocks", "attn_first", [False] * self.n_first,
                   True), ("blocks", "attn", self._local, False)]
        for name, pool_name, flags, dense in stages:
            if not flags:
                continue
            layer_kvs = []
            for layer_p, is_local in zip(_unbind(params[name]), flags):
                rope = ropes[layer_theta(cfg, is_local)]

                def block(x, layer_p=layer_p, rope=rope, is_local=is_local,
                          dense=dense):
                    return transformer_block(layer_p, cfg, x, positions,
                                             rope, is_local=is_local,
                                             dense_override=dense)
                h, kv = self._layer(block, h)
                if return_kv:
                    layer_kvs.append(kv)
            if return_kv:
                kvs[pool_name] = _stack_trees(layer_kvs)
        return h, kvs

    def _forward_xlstm(self, params, h):
        cfg = self.cfg
        for mlstm_g, slstm_p in zip(_unbind(params["mlstm"]),
                                    _unbind(params["slstm"])):
            for lp in _unbind(mlstm_g):
                h = self._layer(lambda x, lp=lp: mlstm_block(lp, cfg, x), h)
            h = self._layer(lambda x, lp=slstm_p: slstm_block(lp, cfg, x), h)
        return h

    def _forward_zamba(self, params, h, positions, return_kv):
        cfg = self.cfg
        shared = params["shared"]
        shared_cfg = zamba_shared_cfg(cfg)
        rope = forward_ropes(shared_cfg, positions, [False])[
            layer_theta(shared_cfg, False)]
        kvs = []
        for mamba_g, lora in zip(_unbind(params["mamba"]),
                                 _unbind(params["lora"])):
            for lp in _unbind(mamba_g):
                h = self._layer(lambda x, lp=lp: mamba_block(lp, cfg, x), h)
            h, kv = self._layer(
                lambda x, lora=lora: zamba_shared_block(
                    shared, lora, cfg, x, positions, rope), h)
            if return_kv:
                kvs.append(kv)
        if "mamba_tail" in params:
            for lp in _unbind(params["mamba_tail"]):
                h = self._layer(lambda x, lp=lp: mamba_block(lp, cfg, x), h)
        return h, {"attn": _stack_trees(kvs)}

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Mean next-token cross entropy of `forward` against
        batch["labels"] (b, s); -100 labels are ignored."""
        return cross_entropy_loss(self.forward(params, batch),
                                  batch["labels"])

    # ------------------------------------------------------------------
    # prefill and decode on a contiguous cache
    # ------------------------------------------------------------------
    def prefill(self, params: Params, inputs: Dict[str, torch.Tensor]):
        """`forward` of a prompt: (the last position's logits (b, 1,
        vocab), `forward`'s kv tree: the K/V rows of every position)."""
        logits, kv = self.forward(params, inputs, return_kv=True)
        return logits[:, -1:], kv

    def decode_step(self, params: Params, cache: Any,
                    inputs: Dict[str, torch.Tensor], pos):
        """One token for every lane: inputs {tokens: (b, 1)} or
        {embeddings: (b, 1, d)}; pos (an int or a 0-d int32 tensor, read
        on the device) the position of this token in every lane.
        `cache` (`cache_specs`' layout) is written in place and
        returned: attention layers write their row `pos` and attend rows
        <= pos, recurrent layers advance their state by one token.
        Returns (logits (b, 1, vocab) f32, cache)."""
        cfg = self.cfg
        h = self._embed(params, inputs)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=h.device)
        if cfg.family == "xlstm":
            h = self._serve_xlstm(params, h, cache, *one_token(h))
        elif cfg.family == "zamba":
            h = self._decode_zamba(params, h, cache, pos)
        else:
            h = self._decode_transformer(params, h, cache, pos)
        return self._logits(params, h), cache

    def _decode_transformer(self, params, h, cache, pos):
        cfg = self.cfg
        ropes = forward_ropes(cfg, pos.reshape(1),
                              [False] * self.n_first + self._local)
        stages = [("first_blocks", "attn_first", [False] * self.n_first,
                   True), ("blocks", "attn", self._local, False)]
        for name, pool_name, flags, dense in stages:
            if not flags:
                continue
            views = self._stack_views(cache[pool_name], ("cache", pool_name))
            for layer_p, layer_cache, is_local in zip(
                    self._layer_params(params, name), views, flags):
                h = transformer_block_decode(
                    layer_p, cfg, h, layer_cache, pos,
                    ropes[layer_theta(cfg, is_local)], is_local=is_local,
                    dense_override=dense)
        return h

    def _decode_zamba(self, params, h, cache, pos):
        cfg = self.cfg
        shared_cfg = zamba_shared_cfg(cfg)
        rope = forward_ropes(shared_cfg, pos.reshape(1), [False])[
            layer_theta(shared_cfg, False)]

        def shared_block(x, lora, layer_cache):
            return zamba_shared_block_decode(params["shared"], lora, cfg, x,
                                             layer_cache, pos, rope)
        return self._zamba_layers(params, h, cache, *one_token(h),
                                  shared_block, ("cache", "attn"))

    # ------------------------------------------------------------------
    def serve_step(self, params: Params, cache: Dict[str, Any],
                   inputs: Dict[str, torch.Tensor], tables: torch.Tensor,
                   lengths: torch.Tensor, n_new: torch.Tensor):
        """Advance a dynamic batch against the paged KV pool.

        inputs: {tokens: (b, s)} — s == 1 decodes one token per lane;
        s > 1 is a chunked batch prefill where lane i consumes n_new[i]
        <= s tokens (lanes with n_new == 0 are padding).  tables: (b,
        max_pages) int32; lengths: (b,) int32 tokens already cached.
        `cache` ({"attn": {k, v[, k_scale, v_scale]}}, MLA's {c_kv,
        k_rope}, stacked over layers) is written in place and returned.
        Returns (logits (b, s, vocab) f32, cache); lane i samples from
        logits[i, n_new[i] - 1].

        A recurrent family's cache also holds its per-lane state leaves
        (`arena_state_specs`; row i of a leaf's lane axis is lane i),
        advanced in place under the (b, s) validity mask from `n_new`:
        masked positions update nothing, so lanes enter and leave the
        batch at any chunk boundary.  Logits of masked positions are
        unspecified.
        """
        cfg = self.cfg
        if self.supports_paged():
            return self._paged_forward(params, cache, inputs, tables,
                                       lengths, n_new, verify=False)
        h = self._embed(params, inputs)
        s = h.shape[1]
        valid = torch.arange(s, device=h.device)[None, :] < n_new[:, None]
        if cfg.family == "xlstm":
            h = self._serve_xlstm(params, h, cache, valid, n_new)
        else:
            h = self._serve_zamba(params, h, cache, tables, lengths, n_new,
                                  valid)
        return self._logits(params, h), cache

    def _serve_xlstm(self, params, h, cache, valid, n_new):
        mlstm = self._stack_views(params["mlstm"], "mlstm", 2)
        slstm = self._stack_views(params["slstm"], "slstm")
        mc = self._stack_views(cache["mlstm"], ("state", "mlstm"), 2)
        sc = self._stack_views(cache["slstm"], ("state", "slstm"))
        for g in range(len(slstm)):
            for lp, c in zip(mlstm[g], mc[g]):
                h = mlstm_block_serve(lp, self.cfg, h, c, valid, n_new)
            h = slstm_block_serve(slstm[g], self.cfg, h, sc[g], valid)
        return h

    def _serve_zamba(self, params, h, cache, tables, lengths, n_new, valid):
        cfg = self.cfg
        shared_cfg = zamba_shared_cfg(cfg)
        rows = rope = None
        if self.n_paged_layers():
            leaf = cache["attn"]["k"]          # (groups, n_pages + 1, ps,
            rows = page_rows(tables, lengths, n_new, h.shape[1],  # g, hd)
                             leaf.shape[2], dump_page=leaf.shape[1] - 1)
            rope = rope_by_theta(shared_cfg, rows.slots, [False])[
                layer_theta(shared_cfg, False)]

        def shared_block(x, lora, pools):
            return zamba_shared_block_paged(params["shared"], lora, cfg, x,
                                            pools, tables, lengths, n_new,
                                            rows, rope)
        return self._zamba_layers(params, h, cache, valid, n_new,
                                  shared_block, ("state", "attn"))

    def _zamba_layers(self, params, h, cache, valid, n_new, shared_block,
                      attn_key):
        """zamba's layers over the recurrent state in `cache`: each
        group's Mamba2 layers, then `shared_block(h, the site's LoRA, the
        site's attention cache)`; then the trailing Mamba2 layers."""
        cfg = self.cfg
        n_groups = self.n_paged_layers()
        if n_groups:
            mamba = self._stack_views(params["mamba"], "mamba", 2)
            lora = self._stack_views(params["lora"], "lora")
            mc = self._stack_views(cache["mamba"], ("state", "mamba"), 2)
            ac = self._stack_views(cache["attn"], attn_key)
            for g in range(n_groups):
                for lp, c in zip(mamba[g], mc[g]):
                    h = mamba_block_serve(lp, cfg, h, c, valid, n_new)
                h = shared_block(h, lora[g], ac[g])
        if "mamba_tail" in params:
            tail = self._stack_views(params["mamba_tail"], "mamba_tail")
            tc = self._stack_views(cache["mamba_tail"],
                                   ("state", "mamba_tail"))
            for lp, c in zip(tail, tc):
                h = mamba_block_serve(lp, cfg, h, c, valid, n_new)
        return h

    # the attention-only name the speculative drafter calls; every family
    # this port serves is paged, so it is `serve_step` itself
    paged_step = serve_step

    def paged_verify_step(self, params: Params, cache: Dict[str, Any],
                          inputs: Dict[str, torch.Tensor],
                          tables: torch.Tensor, lengths: torch.Tensor,
                          n_new: torch.Tensor):
        """Speculative-decode verify: score a draft window in one pass.

        inputs: {tokens: (b, s)} — lane i's row is [last emitted, d_1,
        ..., d_{n_new[i]-1}, pad...]; `lengths` counts tokens already
        cached (this call writes the window's K/V rows, like a prefill
        chunk).  logits[i, j] is the target distribution for the token
        after window position j.  The same math as `serve_step`; GQA
        attention runs the multi-query verify kernel, MLA its latent
        gather."""
        return self._paged_forward(params, cache, inputs, tables, lengths,
                                   n_new, verify=True)

    def supports_paged(self) -> bool:
        """True when EVERY decode-state layer is paged attention KV: the
        full paged feature set (prefix sharing, fork / copy-on-write,
        speculative decoding) applies.  Families with recurrent per-lane
        state (xlstm, zamba) serve through the same engine with those
        capabilities off: adopting or rolling back attention pages
        cannot adopt or roll back a recurrent state."""
        return self.cfg.family in ("dense", "moe")

    def has_recurrent_state(self) -> bool:
        """Any layer carrying constant-size per-lane recurrent state
        (conv buffers, SSM / LSTM cells), served from a `StateArena`."""
        return self.cfg.family in ("xlstm", "zamba")

    def n_paged_layers(self) -> int:
        """Attention layers backed by paged KV pools in `serve_step`
        (zamba: one shared-block invocation per Mamba2 group)."""
        cfg = self.cfg
        if cfg.family in ("dense", "moe"):
            return cfg.n_layers
        if cfg.family == "zamba":
            return self._groups()[0]
        return 0

    def validate_tp(self, tp: int) -> None:
        """Raise unless every tensor-parallel hot-path dim divides evenly
        across `tp` ranks, with the JAX package's message: the sharding
        rule would replicate a non-dividing dim instead of sharding it,
        which defeats the point of paying for tp ranks."""
        if tp <= 1:
            return
        cfg = self.cfg
        bad = []
        if cfg.n_heads % tp:
            bad.append(f"n_heads={cfg.n_heads}")
        if cfg.attn_kind != "mla" and cfg.n_kv_heads % tp:
            # MLA keeps one replicated latent pool; there is no sharded
            # KV-head group dim to divide
            bad.append(f"n_kv_heads={cfg.n_kv_heads}")
        if cfg.d_ff % tp:
            bad.append(f"d_ff={cfg.d_ff}")
        if cfg.family == "moe" and cfg.moe and cfg.moe.d_ff_expert % tp:
            bad.append(f"moe.d_ff_expert={cfg.moe.d_ff_expert}")
        if bad:
            raise ValueError(
                f"tp={tp} does not divide the tensor-parallel dims of "
                f"{cfg.name!r}: " + ", ".join(bad)
                + " (pick a tp that divides the head and FFN widths)")

    def _paged_forward(self, params, cache, inputs, tables, lengths, n_new,
                       verify: bool):
        cfg = self.cfg
        if not self.supports_paged():
            raise ValueError(f"{cfg.name}: family {cfg.family!r} has no "
                             "paged verify / paged-only step")
        h = self._embed(params, inputs)
        s = h.shape[1]
        # every pool leaf (K/V, scales, MLA's latents) is stacked (L,
        # n_pages + 1, page_size, ...): the last page is the dump page of
        # `page_rows`
        leaf = next(iter(cache["attn"].values()))
        rows = page_rows(tables, lengths, n_new, s, leaf.shape[2],
                         dump_page=leaf.shape[1] - 1)
        ropes = rope_by_theta(cfg, rows.slots,
                              [False] * self.n_first + self._local)
        # MoE models' leading dense layers (global, dense FFN), then the
        # stack, whose window flags start at layer n_first
        stages = [("first_blocks", "attn_first", [False] * self.n_first,
                   True), ("blocks", "attn", self._local, False)]
        for name, pool_name, flags, dense in stages:
            if not flags:
                continue
            for i, layer_p in enumerate(self._layer_params(params, name)):
                layer_cache = {k: v[i] for k, v in cache[pool_name].items()}
                h = transformer_block_paged(
                    layer_p, cfg, h, layer_cache, tables, lengths, n_new,
                    rows, ropes[layer_theta(cfg, flags[i])],
                    is_local=flags[i], dense_override=dense, verify=verify)
        return self._logits(params, h), cache

    # ------------------------------------------------------------------
    def paged_cache_specs(self, n_pages: int, page_size: int,
                          kv_dtype: torch.dtype = torch.bfloat16) -> Any:
        """Per-layer page pools stacked over layers, shared by every
        sequence via block tables: (L, n_pages + 1, ...), page `n_pages`
        being the dump page no table names (`attention.page_rows`).
        zamba's pools are one per Mamba2 group at the shared block's
        shape; families without attention layers (xlstm, pure-Mamba2
        zamba) return {}: their decode state is all in the arena."""
        cfg = self.cfg
        n_attn = self.n_paged_layers()
        if n_attn == 0:
            return {}
        if cfg.family == "zamba":
            one = paged_cache_spec(zamba_shared_cfg(cfg), n_pages,
                                   page_size, kv_dtype)
            return {"attn": {k: v.stacked(n_attn) for k, v in one.items()}}
        one = paged_cache_spec(cfg, n_pages, page_size, kv_dtype)
        out = {"attn": {k: v.stacked(n_attn - self.n_first)
                        for k, v in one.items()}}
        if self.n_first:
            out["attn_first"] = {k: v.stacked(self.n_first)
                                 for k, v in one.items()}
        return out

    def cache_specs(self, batch: int, max_seq: int,
                    kv_dtype: torch.dtype = torch.bfloat16) -> Any:
        """ParamSpec tree of `decode_step`'s contiguous cache, JAX's
        shapes and dtypes: attention layers' {k, v} (batch, max_seq, g,
        hd) (MLA: {c_kv, k_rope}) stacked over layers as "attn" (and
        "attn_first" for MoE models' leading dense layers); xlstm's
        recurrent state (`arena_state_specs`); zamba's recurrent state
        plus an "attn" stack over its groups (a model with no group keeps
        a zero-group "mamba" stack, as JAX's)."""
        cfg = self.cfg
        one = empty_cache_spec(cfg, batch, max_seq, kv_dtype)
        if cfg.family == "xlstm":
            return self.arena_state_specs(batch)
        if cfg.family == "zamba":
            n_groups, per, _ = self._groups()
            out = dict(self.arena_state_specs(batch))
            out["attn"] = {k: v.stacked(n_groups) for k, v in one.items()}
            if "mamba" not in out:
                out["mamba"] = {k: v.stacked(per).stacked(0) for k, v in
                                mamba2_cache_spec(cfg, batch).items()}
            return out
        out = {"attn": {k: v.stacked(cfg.n_layers - self.n_first)
                        for k, v in one.items()}}
        if self.n_first:
            out["attn_first"] = {k: v.stacked(self.n_first)
                                 for k, v in one.items()}
        return out

    def arena_state_specs(self, batch: int) -> Any:
        """ParamSpec tree of the recurrent per-lane decode state of a
        `batch`-lane StateArena ({} for attention-only families).  Each
        leaf's `lane_axis` is the axis whose row i is lane i (behind the
        stacked layer dims).  The conv ring buffers hold raw activation
        projections and start at the dtype the serve cells promote them
        to, as in JAX."""
        cfg = self.cfg
        act = cfg.activation_dtype()

        def promoted(one):
            return {k: dataclasses.replace(
                        v, dtype=torch.promote_types(v.dtype, act))
                    for k, v in one.items()}
        if cfg.family == "xlstm":
            n_groups, per, _ = self._groups()
            m_one = promoted(mlstm_cache_spec(cfg, batch))
            s_one = promoted(slstm_cache_spec(cfg, batch))
            return {"mlstm": {k: v.stacked(per - 1).stacked(n_groups)
                              for k, v in m_one.items()},
                    "slstm": {k: v.stacked(n_groups)
                              for k, v in s_one.items()}}
        if cfg.family == "zamba":
            n_groups, per, tail = self._groups()
            one = promoted(mamba2_cache_spec(cfg, batch))
            out = {}
            if n_groups:
                out["mamba"] = {k: v.stacked(per).stacked(n_groups)
                                for k, v in one.items()}
            if tail:
                out["mamba_tail"] = {k: v.stacked(tail)
                                     for k, v in one.items()}
            return out
        return {}

    def decode_state_specs(self, max_batch: int, n_pages: int,
                           page_size: int,
                           kv_dtype: torch.dtype = torch.bfloat16) -> Any:
        """{"paged": KV page pools ({} without attention layers),
        "arena": per-lane recurrent state, batch = max_batch ({} for the
        dense and MoE families)}.  The engine allocates both and hands
        `serve_step` one dict of their leaves."""
        return {"paged": self.paged_cache_specs(n_pages, page_size,
                                                kv_dtype),
                "arena": self.arena_state_specs(max_batch)}
