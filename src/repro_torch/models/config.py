"""Model configuration (PyTorch port of `repro.models.config`).

The same fields and defaults as the JAX `ModelConfig`, with dtypes held
as strings and resolved to torch dtypes on demand, and the same
`MLAConfig`, `MoEConfig`, `SSMConfig` and `ZambaConfig`.  This port
serves the dense family (SwiGLU or gated GELU FFNs, sliding-window /
global layer alternation, softcaps, QK-norm, post-block norms) and its
Mixture-of-Experts variant, with GQA or multi-head latent attention
(MLA), and the recurrent families: xLSTM (mLSTM + sLSTM) and zamba
(Mamba2 with a shared attention + MLP block).  It trains the dense and
MoE families, LayerNorm, plain GELU FFNs and frontend-stub embedding
inputs (`embed_inputs=False`) included.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0          # 0 = no query compression (V2-Lite)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64           # routed experts
    top_k: int = 6
    n_shared_experts: int = 2
    d_ff_expert: int = 1408
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    dispatch: str = "gather"      # gather | onehot (the same kept slots)
    first_dense_layers: int = 0   # deepseek: layer 0 is dense FFN
    first_dense_d_ff: int = 0


@dataclass(frozen=True)
class SSMConfig:
    # mamba2
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # mamba2 head dim (d_inner / n_heads)
    chunk: int = 256
    # xlstm
    mlstm_heads: int = 4
    slstm_every: int = 8          # 7:1 mLSTM:sLSTM -> one sLSTM per 8 layers
    time_chunk: int = 64
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    conv_width: int = 4


@dataclass(frozen=True)
class ZambaConfig:
    shared_every: int = 6         # shared attn+MLP invoked every 6 mamba layers
    lora_rank: int = 64
    shared_d_ff: int = 14336


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | xlstm | zamba
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # attention flavor
    attn_kind: str = "gqa"        # gqa | mla
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    local_window: int = 0
    local_pattern: int = 0
    rope_theta: float = 10000.0
    rope_theta_local: float = 0.0

    # ffn flavor
    ffn_act: str = "silu"
    ffn_gated: bool = True

    # norm flavor
    norm_kind: str = "rms"
    post_block_norm: bool = False
    rms_scale_plus_one: bool = False
    norm_eps: float = 1e-6

    # embedding / head
    tie_embeddings: bool = True
    embed_scale: bool = False
    embed_inputs: bool = True
    logit_dtype: str = "float32"

    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    zamba: Optional[ZambaConfig] = None

    dtype: str = "bfloat16"
    remat: bool = True
    unroll: bool = False
    unroll_ssm_chunks: bool = False

    # --------------------------------------------------------------
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def is_local_layer(self, i: int) -> bool:
        """gemma-style alternation: in each `local_pattern` block, the LAST
        layer is global, the rest local."""
        if not self.local_window or not self.local_pattern:
            return False
        return (i % self.local_pattern) != (self.local_pattern - 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
