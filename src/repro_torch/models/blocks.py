"""Norms and the blocks of every family (PyTorch port of
`repro.models.blocks`): the transformer block (GQA or MLA attention,
dense or MoE FFN); xLSTM's mLSTM and sLSTM blocks and zamba's Mamba2
blocks; zamba's SHARED attention + MLP block, invoked after every
`shared_every` Mamba2 layers with per-site LoRA deltas on q/k/v and a
gated output projection.  Each over the full sequence (training and
`prefill`: `*_block`, attention blocks also returning the layer's K/V
rows), one token against a contiguous cache (`*_decode`, the cache
written in place) and a chunk against a paged KV pool and per-lane
recurrent state (`*_paged`, `*_serve`: the engine).  A recurrent
block's decode is its serve step with every lane valid (`one_token`).

zamba's LoRA: on float weights A B is added to the shared W, as JAX
does; packed W stay packed for `cim_gemv`, and (x A) B is added after
(`zamba_attn_params`, `attention._qkv`)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.kernels.ops import qmatmul as qmm
from repro_torch.quant.qarray import QTensor

from .attention import (PageRows, Rope, attention_specs, attn_decode,
                        attn_forward, attn_paged_step)
from .common import FSDP, NONE, TP, ParamSpec, layer_norm, rms_norm
from .config import ModelConfig
from .ffn import dense_ffn, dense_ffn_specs, ffn_forward, ffn_specs
from .ssm import (mamba2_forward, mamba2_serve_step, mamba2_specs,
                  mlstm_forward, mlstm_serve_step, mlstm_specs,
                  slstm_forward, slstm_serve_step, slstm_specs)

Params = Dict[str, Any]


def norm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    init = "zeros" if cfg.rms_scale_plus_one else "ones"
    sp = {"scale": ParamSpec((cfg.d_model,), axes=(NONE,), init=init)}
    if cfg.norm_kind == "layer":
        sp["bias"] = ParamSpec((cfg.d_model,), axes=(NONE,), init="zeros")
    return sp


def apply_norm(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_kind == "layer":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps,
                    scale_plus_one=cfg.rms_scale_plus_one)


def transformer_block_specs(cfg: ModelConfig, dense_ffn_override: int = 0
                            ) -> Dict[str, Any]:
    """dense_ffn_override: a dense FFN of this width in place of the
    config's (MoE models' leading dense layers)."""
    sp = {"ln_attn": norm_specs(cfg), "attn": attention_specs(cfg),
          "ln_ffn": norm_specs(cfg),
          "ffn": (dense_ffn_specs(cfg, dense_ffn_override)
                  if dense_ffn_override else ffn_specs(cfg))}
    if cfg.post_block_norm:
        sp["post_attn"] = norm_specs(cfg)
        sp["post_ffn"] = norm_specs(cfg)
    return sp


def _transformer_tail(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      a: torch.Tensor, dense_override: bool) -> torch.Tensor:
    """The rest of a transformer block after its attention output a:
    the residual, then the pre-norm FFN and its residual (each branch
    normed again before its add when `post_block_norm`)."""
    if cfg.post_block_norm:
        a = apply_norm(p["post_attn"], cfg, a)
    x = x + a
    h = apply_norm(p["ln_ffn"], cfg, x)
    f = dense_ffn(p["ffn"], cfg, h) if dense_override \
        else ffn_forward(p["ffn"], cfg, h)
    if cfg.post_block_norm:
        f = apply_norm(p["post_ffn"], cfg, f)
    return x + f


def transformer_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, rope: Rope,
                      is_local: bool = False,
                      dense_override: bool = False):
    """Full-sequence block (training, prefill): pre-norm attention and
    FFN with residuals; `dense_override` runs the dense FFN of a MoE
    model's leading layers.  Returns (x, the layer's K/V rows)."""
    h = apply_norm(p["ln_attn"], cfg, x)
    a, kv = attn_forward(p["attn"], cfg, h, positions, rope, is_local)
    return _transformer_tail(p, cfg, x, a, dense_override), kv


def transformer_block_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                             cache: Dict[str, torch.Tensor],
                             pos: torch.Tensor, rope: Rope,
                             is_local: bool = False,
                             dense_override: bool = False) -> torch.Tensor:
    """One token of every lane (x: (b, 1, d)) against this layer's
    contiguous cache, whose row `pos` it writes in place."""
    h = apply_norm(p["ln_attn"], cfg, x)
    a = attn_decode(p["attn"], cfg, h, cache, pos, rope, is_local)
    return _transformer_tail(p, cfg, x, a, dense_override)


def transformer_block_paged(p: Params, cfg: ModelConfig, x: torch.Tensor,
                            cache: Dict[str, torch.Tensor],
                            tables: torch.Tensor, lengths: torch.Tensor,
                            n_new: torch.Tensor, rows: PageRows, rope: Rope,
                            is_local: bool = False,
                            dense_override: bool = False,
                            verify: bool = False) -> torch.Tensor:
    """Decode / chunked-prefill / verify block (x: (b, s, d)); writes
    this layer's new K/V (or MLA latent) rows into `cache` in place.  With
    `post_block_norm` each branch's output is normed before the
    residual add; `dense_override` runs the dense FFN of a MoE model's
    leading layers."""
    h = apply_norm(p["ln_attn"], cfg, x)
    a = attn_paged_step(p["attn"], cfg, h, cache, tables, lengths, n_new,
                        rows, rope, is_local=is_local, verify=verify)
    return _transformer_tail(p, cfg, x, a, dense_override)


# ----------------------------------------------------------------------------
# xLSTM and Mamba2 blocks: pre-norm, residual
# ----------------------------------------------------------------------------
def mlstm_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln": norm_specs(cfg), "cell": mlstm_specs(cfg)}


def slstm_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln": norm_specs(cfg), "cell": slstm_specs(cfg)}


def mamba_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln": norm_specs(cfg), "cell": mamba2_specs(cfg)}


def mlstm_block(p, cfg, x):
    return x + mlstm_forward(p["cell"], cfg, apply_norm(p["ln"], cfg, x))


def slstm_block(p, cfg, x):
    return x + slstm_forward(p["cell"], cfg, apply_norm(p["ln"], cfg, x))


def mamba_block(p, cfg, x):
    return x + mamba2_forward(p["cell"], cfg, apply_norm(p["ln"], cfg, x))


def mlstm_block_serve(p, cfg, x, cache, valid, n_new):
    return x + mlstm_serve_step(p["cell"], cfg, apply_norm(p["ln"], cfg, x),
                                cache, valid, n_new)


def slstm_block_serve(p, cfg, x, cache, valid):
    return x + slstm_serve_step(p["cell"], cfg, apply_norm(p["ln"], cfg, x),
                                cache, valid)


def mamba_block_serve(p, cfg, x, cache, valid, n_new):
    return x + mamba2_serve_step(p["cell"], cfg,
                                 apply_norm(p["ln"], cfg, x), cache, valid,
                                 n_new)


def one_token(x: torch.Tensor):
    """(valid (b, 1), n_new (b,)) of a step that feeds every lane one
    token: a recurrent block's decode is its serve step under this
    mask (JAX's `*_block_decode`)."""
    b = x.shape[0]
    return (torch.ones(b, 1, dtype=torch.bool, device=x.device),
            torch.ones(b, dtype=torch.int32, device=x.device))


# ----------------------------------------------------------------------------
# zamba's shared attention + MLP block
# ----------------------------------------------------------------------------
def zamba_shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared block's config: the shared FFN width, no MoE."""
    return cfg.replace(d_ff=cfg.zamba.shared_d_ff, moe=None)


def zamba_shared_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The SHARED attention + MLP block (one copy for the whole model)."""
    shared_cfg = zamba_shared_cfg(cfg)
    return {"ln_attn": norm_specs(cfg), "attn": attention_specs(shared_cfg),
            "ln_ffn": norm_specs(cfg), "ffn": dense_ffn_specs(shared_cfg)}


def zamba_lora_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Per-invocation LoRA deltas on q/k/v + output gate projection."""
    d, hd, r = cfg.d_model, cfg.hd(), cfg.zamba.lora_rank
    sp = {}
    for nm, out_dim in (("q", cfg.n_heads * hd), ("k", cfg.n_kv_heads * hd),
                        ("v", cfg.n_kv_heads * hd)):
        sp[f"lora_a_{nm}"] = ParamSpec((d, r), axes=(FSDP, NONE))
        sp[f"lora_b_{nm}"] = ParamSpec((r, out_dim), axes=(NONE, TP),
                                       init="zeros")
    sp["out_proj"] = ParamSpec((d, d), axes=(FSDP, NONE))
    return sp


def zamba_attn_params(attn: Params, lora: Params):
    """(attention params, LoRA for `attention._qkv`) of one site of the
    shared block.  Float weights: W + A B for q/k/v, as JAX's
    `_zamba_attn_params`, and no LoRA after.  Packed weights stay packed
    for `cim_gemv`, and the site's LoRA goes along."""
    if isinstance(attn["wq"], QTensor):
        return attn, lora
    p = dict(attn)
    for nm in ("q", "k", "v"):
        base = p["w" + nm]
        delta = lora[f"lora_a_{nm}"] @ lora[f"lora_b_{nm}"]
        p["w" + nm] = base + delta.to(base.dtype)
    return p, None


def _zamba_tail(shared: Params, lora: Params, cfg: ModelConfig,
                x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The shared block after its attention output a: the site's
    `out_proj` and the residual, then the shared SwiGLU MLP."""
    x = x + qmm(a, lora["out_proj"])
    h = apply_norm(shared["ln_ffn"], cfg, x)
    return x + dense_ffn(shared["ffn"], zamba_shared_cfg(cfg), h)


def zamba_shared_block(shared: Params, lora: Params, cfg: ModelConfig,
                       x: torch.Tensor, positions: torch.Tensor,
                       rope: Rope):
    """One invocation of the shared block over the full sequence.
    Returns (x, the site's K/V rows)."""
    attn_p, site_lora = zamba_attn_params(shared["attn"], lora)
    h = apply_norm(shared["ln_attn"], cfg, x)
    a, kv = attn_forward(attn_p, zamba_shared_cfg(cfg), h, positions, rope,
                         lora=site_lora)
    return _zamba_tail(shared, lora, cfg, x, a), kv


def zamba_shared_block_decode(shared: Params, lora: Params,
                              cfg: ModelConfig, x: torch.Tensor,
                              cache: Dict[str, torch.Tensor],
                              pos: torch.Tensor, rope: Rope) -> torch.Tensor:
    """One token of every lane against the site's contiguous cache, whose
    row `pos` it writes in place."""
    attn_p, site_lora = zamba_attn_params(shared["attn"], lora)
    h = apply_norm(shared["ln_attn"], cfg, x)
    a = attn_decode(attn_p, zamba_shared_cfg(cfg), h, cache, pos, rope,
                    lora=site_lora)
    return _zamba_tail(shared, lora, cfg, x, a)


def zamba_shared_block_paged(shared: Params, lora: Params, cfg: ModelConfig,
                             x: torch.Tensor, cache: Dict[str, torch.Tensor],
                             tables: torch.Tensor, lengths: torch.Tensor,
                             n_new: torch.Tensor, rows: PageRows,
                             rope: Rope) -> torch.Tensor:
    """One invocation of the shared block against its paged KV pools (the
    `transformer_block_paged` contract): attention with this site's LoRA
    deltas (`zamba_attn_params`; on packed W, where JAX adds A B to a
    bf16 dequantized W, x W + (x A) B), its output through the site's
    `out_proj`, then the shared SwiGLU MLP."""
    attn_p, site_lora = zamba_attn_params(shared["attn"], lora)
    h = apply_norm(shared["ln_attn"], cfg, x)
    a = attn_paged_step(attn_p, zamba_shared_cfg(cfg), h, cache,
                        tables, lengths, n_new, rows, rope, lora=site_lora)
    return _zamba_tail(shared, lora, cfg, x, a)
