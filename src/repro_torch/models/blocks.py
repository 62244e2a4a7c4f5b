"""Norms and the dense transformer block over a paged KV pool (PyTorch
port of the dense serve path of `repro.models.blocks`)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .attention import PageRows, gqa_paged_step, gqa_specs
from .common import ParamSpec, rms_norm
from .config import ModelConfig
from .ffn import dense_ffn, dense_ffn_specs

Params = Dict[str, Any]


def norm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    init = "zeros" if cfg.rms_scale_plus_one else "ones"
    return {"scale": ParamSpec((cfg.d_model,), init=init)}


def apply_norm(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, p["scale"], cfg.norm_eps,
                    scale_plus_one=cfg.rms_scale_plus_one)


def transformer_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln_attn": norm_specs(cfg), "attn": gqa_specs(cfg),
            "ln_ffn": norm_specs(cfg), "ffn": dense_ffn_specs(cfg)}


def transformer_block_paged(p: Params, cfg: ModelConfig, x: torch.Tensor,
                            cache: Dict[str, torch.Tensor],
                            tables: torch.Tensor, lengths: torch.Tensor,
                            n_new: torch.Tensor, rows: PageRows,
                            verify: bool = False) -> torch.Tensor:
    """Decode / chunked-prefill / verify block (x: (b, s, d)); writes
    this layer's new K/V rows into `cache` in place."""
    h = apply_norm(p["ln_attn"], cfg, x)
    x = x + gqa_paged_step(p["attn"], cfg, h, cache, tables, lengths,
                           n_new, rows, verify=verify)
    h = apply_norm(p["ln_ffn"], cfg, x)
    return x + dense_ffn(p["ffn"], cfg, h)
