"""Dense feed-forward (PyTorch port of `repro.models.ffn`'s dense path):
fused SwiGLU, or gated / plain GELU-family FFNs.  Mixture-of-Experts is
not in this port yet."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.ops import qmatmul as qmm
from repro_torch.kernels.ops import swiglu

from .common import ACTIVATIONS, ParamSpec
from .config import ModelConfig


def dense_ffn_specs(cfg: ModelConfig, d_ff: int = 0) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    sp = {"w_up": ParamSpec((d, f)), "w_down": ParamSpec((f, d))}
    if cfg.ffn_gated:
        sp["w_gate"] = ParamSpec((d, f))
    return sp


def dense_ffn(p: Dict[str, torch.Tensor], cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU is the fused SwiGLU (one pass over the packed gate/up
    weights); every other activation takes the unfused route, one
    `cim_gemv` call per packed projection, as the JAX package does."""
    if cfg.ffn_gated and cfg.ffn_act == "silu":
        return qmm(swiglu(x, p["w_gate"], p["w_up"]), p["w_down"])
    act = ACTIVATIONS[cfg.ffn_act]
    up = qmm(x, p["w_up"])
    h = act(qmm(x, p["w_gate"])) * up if cfg.ffn_gated else act(up)
    return qmm(h, p["w_down"])
