"""Norms and the transformer block (GQA or MLA attention, dense or MoE
FFN) over a paged KV pool (PyTorch port of the dense / moe serve path
of `repro.models.blocks`)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .attention import PageRows, Rope, attention_specs, attn_paged_step
from .common import ParamSpec, rms_norm
from .config import ModelConfig
from .ffn import dense_ffn, dense_ffn_specs, ffn_forward, ffn_specs

Params = Dict[str, Any]


def norm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    init = "zeros" if cfg.rms_scale_plus_one else "ones"
    return {"scale": ParamSpec((cfg.d_model,), init=init)}


def apply_norm(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
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
