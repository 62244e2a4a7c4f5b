"""Dense gated feed-forward (PyTorch port of `repro.models.ffn`'s dense
path).  Mixture-of-Experts is not in this port yet."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.ops import qmatmul as qmm
from repro_torch.kernels.ops import swiglu

from .common import ParamSpec
from .config import ModelConfig


def dense_ffn_specs(cfg: ModelConfig, d_ff: int = 0) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"w_up": ParamSpec((d, f)), "w_down": ParamSpec((f, d)),
            "w_gate": ParamSpec((d, f))}


def dense_ffn(p: Dict[str, torch.Tensor], cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    """Fused SwiGLU (one pass over the packed gate/up weights), then the
    down projection."""
    return qmm(swiglu(x, p["w_gate"], p["w_up"]), p["w_down"])
