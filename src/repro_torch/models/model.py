"""Decoder-only LM, the dense and MoE families (PyTorch port of the
serve path of `repro.models.model.DecoderLM`): GQA or multi-head latent
attention (MLA, deepseek), SwiGLU or gated GELU FFNs or routed experts
(with shared experts and leading dense layers), tied or untied heads,
and gemma's features (sliding-window / global layers, attention and
final softcaps, QK-norm, post-block norms, scaled embeddings, a second
RoPE base for local layers).

    model  = DecoderLM(cfg)
    specs  = model.param_specs()                     # ParamSpec tree
    params = init_params(specs, generator, device)   # nested dict
    logits, cache = model.serve_step(params, cache, inputs, tables,
                                     lengths, n_new)
    logits, cache = model.paged_verify_step(...)     # speculative verify

Parameters keep the JAX package's tree and stacked-layer layout
(`blocks` leaves carry a leading layer dim; a MoE model's leading dense
layers are `first_blocks`, with their own `attn_first` pools), so
`repro_torch.convert` carries weights across leaf for leaf.  The paged KV
pools keep the stacked `(L, n_pages, page_size, g, hd)` layout (MLA's
latent pools `(L, n_pages, page_size, r)` and `(L, ..., rope_d)`) and
are updated in place.  Other families and attention flavors raise
NotImplementedError (`_unsupported` names what is not ported yet).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from repro_torch.kernels.ops import qmatmul as qmm
from repro_torch.quant.qarray import QTensor, dequant_rows

from .attention import layer_theta, page_rows, paged_cache_spec, \
    rope_by_theta
from .blocks import apply_norm, norm_specs, transformer_block_paged, \
    transformer_block_specs
from .common import ACTIVATIONS, ParamSpec, softcap, stack_specs
from .config import ModelConfig

Params = Dict[str, Any]


def _unsupported(cfg: ModelConfig) -> List[str]:
    out = []
    if cfg.family not in ("dense", "moe"):
        out.append(f"family {cfg.family!r}")
    if cfg.attn_kind not in ("gqa", "mla") or \
            (cfg.attn_kind == "mla") != (cfg.mla is not None):
        out.append(f"attention {cfg.attn_kind!r}")
    if cfg.norm_kind != "rms":
        out.append(f"norm {cfg.norm_kind!r}")
    if cfg.ffn_act not in ACTIVATIONS:
        out.append(f"ffn activation {cfg.ffn_act!r}")
    if not cfg.embed_inputs:
        out.append("frontend-stub embeddings")
    return out


class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        bad = _unsupported(cfg)
        if bad:
            raise NotImplementedError(
                f"{cfg.name}: the PyTorch port serves dense and MoE "
                f"decoders (GQA or MLA) only; not yet ported: "
                f"{', '.join(bad)}")
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
        self._views: Dict[str, Any] = {}   # name -> (stacked tree, views)

    # ------------------------------------------------------------------
    def param_specs(self) -> Params:
        cfg = self.cfg
        sp: Params = {"embed": ParamSpec((cfg.vocab, cfg.d_model),
                                         init="embed",
                                         scale=cfg.d_model ** -0.5)}
        if not cfg.tie_embeddings:
            sp["head"] = ParamSpec((cfg.d_model, cfg.vocab))
        sp["ln_final"] = norm_specs(cfg)
        if self.n_first:
            sp["first_blocks"] = stack_specs(
                transformer_block_specs(
                    cfg, dense_ffn_override=cfg.moe.first_dense_d_ff),
                self.n_first)
        sp["blocks"] = stack_specs(transformer_block_specs(cfg),
                                   cfg.n_layers - self.n_first)
        return sp

    # ------------------------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        emb = params["embed"]
        tokens = tokens.long()
        if isinstance(emb, QTensor):
            h = dequant_rows(emb, tokens, cfg.activation_dtype())
        else:
            h = emb[tokens]
        if cfg.embed_scale:
            h = h * self._embed_scale[h.dtype]
        return h.to(cfg.activation_dtype())

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(params["ln_final"], cfg, h)
        if cfg.tie_embeddings or "head" not in params:
            w = params["embed"]
            if isinstance(w, QTensor):
                # packed (V, d) table: the kernel contracts over d rows
                logits = qmm(h, w).to(torch.float32)
            else:
                logits = torch.matmul(h.to(torch.float32),
                                      w.to(torch.float32).t())
        else:
            logits = qmm(h, params["head"]).to(torch.float32)
        if cfg.final_softcap:
            logits = softcap(logits, cfg.final_softcap)
        return logits

    def _layer_params(self, params: Params, name: str) -> List[Params]:
        """Per-layer views of the stacked tree `params[name]` (`blocks`
        or `first_blocks`), built once per parameter tree (views share
        storage; no copy)."""
        stacked = params[name]
        seen = self._views.get(name)
        if seen is None or seen[0] is not stacked:
            def take(tree, i):
                if isinstance(tree, dict):
                    return {k: take(v, i) for k, v in tree.items()}
                return tree[i]
            n = self.n_first if name == "first_blocks" \
                else self.cfg.n_layers - self.n_first
            seen = self._views[name] = (stacked,
                                        [take(stacked, i) for i in range(n)])
        return seen[1]

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
        """
        return self._paged_forward(params, cache, inputs, tables, lengths,
                                   n_new, verify=False)

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
        """Every layer keeps paged KV (no recurrent state), so prefix
        sharing and speculative rollback apply."""
        return self.cfg.family in ("dense", "moe")

    def _paged_forward(self, params, cache, inputs, tables, lengths, n_new,
                       verify: bool):
        cfg = self.cfg
        h = self._embed(params, inputs["tokens"])
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
        being the dump page no table names (`attention.page_rows`)."""
        one = paged_cache_spec(self.cfg, n_pages, page_size, kv_dtype)
        out = {"attn": {k: v.stacked(self.cfg.n_layers - self.n_first)
                        for k, v in one.items()}}
        if self.n_first:
            out["attn_first"] = {k: v.stacked(self.n_first)
                                 for k, v in one.items()}
        return out

    def decode_state_specs(self, max_batch: int, n_pages: int,
                           page_size: int,
                           kv_dtype: torch.dtype = torch.bfloat16) -> Any:
        """{"paged": KV page pools, "arena": {}} — the dense and MoE
        families keep no per-lane recurrent state."""
        return {"paged": self.paged_cache_specs(n_pages, page_size,
                                                kv_dtype),
                "arena": {}}
