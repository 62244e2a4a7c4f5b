"""Norms and the blocks of every family (PyTorch port of
`repro.models.blocks`): the transformer block (GQA or MLA attention,
dense or MoE FFN) over the full sequence (training) and over a paged KV
pool (serving); xLSTM's mLSTM and sLSTM blocks
and zamba's Mamba2 blocks over per-lane recurrent state; zamba's SHARED
attention + MLP block, invoked after every `shared_every` Mamba2 layers
with per-site LoRA deltas on q/k/v and a gated output projection."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.kernels.ops import qmatmul as qmm

from .attention import (PageRows, Rope, attention_specs, attn_forward,
                        attn_paged_step)
from .common import ParamSpec, layer_norm, rms_norm
from .config import ModelConfig
from .ffn import dense_ffn, dense_ffn_specs, ffn_forward, ffn_specs
from .ssm import (mamba2_serve_step, mamba2_specs, mlstm_serve_step,
                  mlstm_specs, slstm_serve_step, slstm_specs)

Params = Dict[str, Any]


def norm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    init = "zeros" if cfg.rms_scale_plus_one else "ones"
    sp = {"scale": ParamSpec((cfg.d_model,), init=init)}
    if cfg.norm_kind == "layer":
        sp["bias"] = ParamSpec((cfg.d_model,), init="zeros")
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


def transformer_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, rope: Rope,
                      is_local: bool = False,
                      dense_override: bool = False) -> torch.Tensor:
    """Full-sequence block (training): pre-norm attention and FFN with
    residuals, each branch normed again before its add when
    `post_block_norm`; `dense_override` runs the dense FFN of a MoE
    model's leading layers."""
    h = apply_norm(p["ln_attn"], cfg, x)
    a = attn_forward(p["attn"], cfg, h, positions, rope, is_local)
    if cfg.post_block_norm:
        a = apply_norm(p["post_attn"], cfg, a)
    x = x + a
    h = apply_norm(p["ln_ffn"], cfg, x)
    f = dense_ffn(p["ffn"], cfg, h) if dense_override \
        else ffn_forward(p["ffn"], cfg, h)
    if cfg.post_block_norm:
        f = apply_norm(p["post_ffn"], cfg, f)
    return x + f


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
    if cfg.post_block_norm:
        a = apply_norm(p["post_attn"], cfg, a)
    x = x + a
    h = apply_norm(p["ln_ffn"], cfg, x)
    f = dense_ffn(p["ffn"], cfg, h) if dense_override \
        else ffn_forward(p["ffn"], cfg, h)
    if cfg.post_block_norm:
        f = apply_norm(p["post_ffn"], cfg, f)
    return x + f


# ----------------------------------------------------------------------------
# xLSTM and Mamba2 blocks: pre-norm, residual, per-lane state in place
# ----------------------------------------------------------------------------
def mlstm_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln": norm_specs(cfg), "cell": mlstm_specs(cfg)}


def slstm_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln": norm_specs(cfg), "cell": slstm_specs(cfg)}


def mamba_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln": norm_specs(cfg), "cell": mamba2_specs(cfg)}


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
        sp[f"lora_a_{nm}"] = ParamSpec((d, r))
        sp[f"lora_b_{nm}"] = ParamSpec((r, out_dim), init="zeros")
    sp["out_proj"] = ParamSpec((d, d))
    return sp


def zamba_shared_block_paged(shared: Params, lora: Params, cfg: ModelConfig,
                             x: torch.Tensor, cache: Dict[str, torch.Tensor],
                             tables: torch.Tensor, lengths: torch.Tensor,
                             n_new: torch.Tensor, rows: PageRows,
                             rope: Rope) -> torch.Tensor:
    """One invocation of the shared block against its paged KV pools (the
    `transformer_block_paged` contract): attention with this site's LoRA
    deltas (`attention._qkv`: x W + (x A) B on the packed W, where JAX
    adds A B to a bf16 dequantized W), its output through the site's
    `out_proj`, then the shared SwiGLU MLP."""
    shared_cfg = zamba_shared_cfg(cfg)
    h = apply_norm(shared["ln_attn"], cfg, x)
    a = attn_paged_step(shared["attn"], shared_cfg, h, cache, tables,
                        lengths, n_new, rows, rope, lora=lora)
    x = x + qmm(a, lora["out_proj"])
    h = apply_norm(shared["ln_ffn"], cfg, x)
    return x + dense_ffn(shared["ffn"], shared_cfg, h)
