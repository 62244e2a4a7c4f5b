"""Active-parameter accounting for MODEL_FLOPS (roofline 'useful work').

6*N*D with N = parameters touched per token: dense models use all
non-embedding params (+ LM head once per *output* position); MoE models
count only routed-active + shared experts; recurrent blocks count their
projection weights (state updates are O(d*state), included).
"""
from __future__ import annotations

from repro_torch.configs.registry import SHAPES
from repro_torch.models import DecoderLM
from repro_torch.models.config import ModelConfig


def total_params(cfg: ModelConfig) -> int:
    return DecoderLM(cfg).n_params()


def active_params(cfg: ModelConfig) -> float:
    """Parameters participating per token (MoE: top_k+shared only)."""
    n = float(total_params(cfg))
    if cfg.moe is not None:
        m = cfg.moe
        n_moe_layers = cfg.n_layers - m.first_dense_layers
        per_expert = 3 * cfg.d_model * m.d_ff_expert
        inactive = (m.n_experts - m.top_k) * per_expert * n_moe_layers
        n -= inactive
    # embeddings: lookup is O(d)/token, not a matmul — drop the table,
    # keep the LM head (tied or not, the head matmul is real compute)
    n -= cfg.vocab * cfg.d_model * (0 if cfg.tie_embeddings else 1)
    return n


def total_tokens(shape_id: str) -> float:
    seq, batch, kind = SHAPES[shape_id]
    if kind == "decode":
        return float(batch)          # one token per sequence per step
    return float(seq) * batch


def bytes_per_param(quant: str) -> float:
    if quant == "int4":
        return 0.5 * (1.0 + 16.0 / (128.0 * 4))   # + group scales
    if quant == "int8":
        return 1.0 * (1.0 + 16.0 / (128.0 * 8))
    return 2.0                                     # bf16


def decode_model_bytes(cfg: ModelConfig, shape_id: str, quant: str,
                       n_devices: int) -> float:
    """Idealized HBM bytes per decode step per device: every active
    parameter read once + the KV/state stream (the paper's bandwidth
    wall, Sec. III-C).  Local-attention layers read only their window."""
    seq, batch, kind = SHAPES[shape_id]
    assert kind == "decode"
    w_bytes = active_params(cfg) * bytes_per_param(quant)

    kv_bytes = 0.0
    if cfg.family in ("dense", "moe"):
        n_attn = cfg.n_layers
        if cfg.attn_kind == "mla":
            row = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
            kv_bytes = n_attn * batch * seq * row * 2.0
        else:
            row = 2 * cfg.n_kv_heads * cfg.hd()
            if cfg.local_window and cfg.local_pattern:
                n_local = sum(cfg.is_local_layer(i)
                              for i in range(cfg.n_layers))
                n_global = cfg.n_layers - n_local
                kv_bytes = (n_global * seq
                            + n_local * min(seq, cfg.local_window)
                            ) * batch * row * 2.0
            else:
                kv_bytes = n_attn * batch * seq * row * 2.0
    elif cfg.family == "xlstm":
        from repro_torch.models.ssm import mlstm_dims
        di, nh, dh = mlstm_dims(cfg)
        per = cfg.ssm.slstm_every
        n_groups = cfg.n_layers // per
        state = n_groups * ((per - 1) * nh * dh * dh + 4 * cfg.d_model)
        kv_bytes = 2.0 * state * 4.0 * batch          # read+write f32
    elif cfg.family == "zamba":
        from repro_torch.models.ssm import mamba2_dims
        di, nh, ds = mamba2_dims(cfg)
        n_mamba = cfg.n_layers
        n_attn = cfg.n_layers // cfg.zamba.shared_every
        state = n_mamba * nh * cfg.ssm.head_dim * ds
        kv_bytes = (2.0 * state * 4.0
                    + n_attn * seq * 2 * cfg.n_kv_heads * cfg.hd() * 2.0
                    ) * batch
    return (w_bytes + kv_bytes) / n_devices
