"""SLM workload description for the EdgeCIM analytical simulator.

Turns a decoder-only SLM architecture into per-layer *stage* GEMV
descriptors matching the paper's decode pipeline (Fig. 5 / Sec. III-C):

    Projection -> Attention -> Linear -> FFN   (+ embedding, + LM head)

Supports the paper's 12 SLM benchmarks (dense GQA/MHA transformers) and
the assigned-architecture families: MLA (latent KV cache), MoE (active
experts streamed), and SSM/hybrid blocks (recurrent state streamed in
place of the KV cache — see DESIGN.md SS4: EdgeCIM's attention blocking is
inapplicable without a KV cache; the state stream takes its place).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass(frozen=True)
class Stage:
    """Analytical cost terms of one pipeline stage for ONE decode token.

    weight_elems:    INT weight elements streamed from DRAM this token
    macs:            multiply-accumulates performed on the macros
    kv_stream_elems: KV-cache / recurrent-state elements streamed (activation
                     precision), overlapped with compute like weights
    writeback_elems: elements written back to DRAM (KV append, state update)
    vector_ops:      elementwise ops on the auxiliary units (softmax, norm,
                     activation, elementwise-mul, quantize, transpose)
    n_units:         independent mapping units (heads/clusters parallelism
                     cap - informs pipeline fill count)
    """
    name: str
    weight_elems: float = 0.0
    macs: float = 0.0
    kv_stream_elems: float = 0.0
    writeback_elems: float = 0.0
    vector_ops: float = 0.0
    n_units: int = 1


@dataclass(frozen=True)
class SLMSpec:
    """Architecture description sufficient for stage-cost generation."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    ffn_gated: bool = True              # SwiGLU/GeGLU: 3 mats; else 2 (GELU)
    qkv_bias: bool = False
    tie_embeddings: bool = True

    # attention flavor
    attn_kind: str = "gqa"              # gqa | mla | none
    mla_kv_lora: int = 0
    mla_rope_dim: int = 0
    mla_q_nope: int = 0

    # MoE
    n_experts: int = 0                  # routed experts (0 = dense)
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0

    # SSM / hybrid: fraction of layers that are recurrent-state blocks
    n_ssm_layers: int = 0
    ssm_state_elems_per_layer: float = 0.0   # recurrent state size (elements)
    ssm_weight_elems_per_layer: float = 0.0  # in-projection/conv/out weights
    ssm_macs_per_layer: float = 0.0

    # local/global attention (gemma-style): window caps the attended KV
    local_window: int = 0               # 0 = all layers global
    local_ratio: float = 0.0            # fraction of attn layers that are local

    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    # ------------------------------------------------------------------
    # parameter accounting
    # ------------------------------------------------------------------
    def attn_layer_weights(self) -> float:
        d, hd = self.d_model, self.hd()
        if self.attn_kind == "mla":
            w_q = d * self.n_heads * (self.mla_q_nope + self.mla_rope_dim)
            w_dkv = d * (self.mla_kv_lora + self.mla_rope_dim)
            w_uk = self.n_heads * self.mla_q_nope * self.mla_kv_lora
            w_uv = self.n_heads * hd * self.mla_kv_lora
            w_o = self.n_heads * hd * d
            return w_q + w_dkv + w_uk + w_uv + w_o
        w_q = d * self.n_heads * hd
        w_kv = 2 * d * self.n_kv_heads * hd
        w_o = self.n_heads * hd * d
        return w_q + w_kv + w_o

    def ffn_layer_weights_active(self) -> float:
        """FFN weights streamed per token (MoE: only active experts)."""
        n_mats = 3 if self.ffn_gated else 2
        if self.n_experts > 0:
            active = self.top_k + self.n_shared_experts
            router = self.d_model * self.n_experts
            return active * n_mats * self.d_model * self.d_ff_expert + router
        return n_mats * self.d_model * self.d_ff

    def ffn_layer_weights_total(self) -> float:
        n_mats = 3 if self.ffn_gated else 2
        if self.n_experts > 0:
            total = self.n_experts + self.n_shared_experts
            router = self.d_model * self.n_experts
            return total * n_mats * self.d_model * self.d_ff_expert + router
        return n_mats * self.d_model * self.d_ff

    def n_attn_layers(self) -> int:
        return self.n_layers - self.n_ssm_layers

    def total_params(self) -> float:
        """Total stored parameters (for model-size / DRAM-footprint checks)."""
        per_attn = self.attn_layer_weights() + self.ffn_layer_weights_total()
        ssm = self.n_ssm_layers * (self.ssm_weight_elems_per_layer +
                                   (0 if self.n_ssm_layers == 0 else 0))
        embed = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_attn_layers() * per_attn + ssm + embed

    def active_params_per_token(self) -> float:
        """Weights streamed from DRAM per decode token (the bandwidth wall)."""
        per_attn = self.attn_layer_weights() + self.ffn_layer_weights_active()
        ssm = self.n_ssm_layers * self.ssm_weight_elems_per_layer
        lm_head = self.vocab * self.d_model
        return self.n_attn_layers() * per_attn + ssm + lm_head

    # ------------------------------------------------------------------
    # stage generation (ONE decode token at KV length `seq`)
    # ------------------------------------------------------------------
    def kv_elems_per_attn_layer(self, seq: float, is_local: bool = False) -> float:
        if self.attn_kind == "mla":
            width = self.mla_kv_lora + self.mla_rope_dim
            return seq * width
        eff_seq = min(seq, self.local_window) if (is_local and self.local_window) else seq
        return 2.0 * eff_seq * self.n_kv_heads * self.hd()

    def decode_stages(self, seq: float) -> List[Stage]:
        """Per-layer stage list for one decode step with KV length `seq`.

        Local/global alternation is averaged across attention layers.
        """
        d, hd, H = self.d_model, self.hd(), self.n_heads
        stages: List[Stage] = []

        n_attn = self.n_attn_layers()
        if n_attn > 0:
            # --- Projection ------------------------------------------------
            if self.attn_kind == "mla":
                proj_w = (d * H * (self.mla_q_nope + self.mla_rope_dim)
                          + d * (self.mla_kv_lora + self.mla_rope_dim)
                          + H * self.mla_q_nope * self.mla_kv_lora)
            else:
                proj_w = d * H * hd + 2 * d * self.n_kv_heads * hd
            bias = (H * hd + 2 * self.n_kv_heads * hd) if self.qkv_bias else 0
            stages.append(Stage(
                "projection",
                weight_elems=proj_w + bias,
                macs=proj_w,
                writeback_elems=(self.mla_kv_lora + self.mla_rope_dim)
                if self.attn_kind == "mla" else 2 * self.n_kv_heads * hd,
                vector_ops=3 * d,   # pre-norm + RoPE + quantize K/V
                n_units=max(self.n_kv_heads, 1),
            ))

            # --- Attention ---------------------------------------------------
            kv_global = self.kv_elems_per_attn_layer(seq, is_local=False)
            kv_local = self.kv_elems_per_attn_layer(seq, is_local=True)
            kv = (self.local_ratio * kv_local
                  + (1.0 - self.local_ratio) * kv_global)
            if self.attn_kind == "mla":
                width = self.mla_kv_lora + self.mla_rope_dim
                sc_seq = kv / width
                macs = H * sc_seq * width + H * sc_seq * self.mla_kv_lora \
                    + H * hd * self.mla_kv_lora
                softmax_elems = H * sc_seq
            else:
                sc_seq = kv / (2.0 * self.n_kv_heads * hd)
                macs = 2.0 * H * hd * sc_seq
                softmax_elems = H * sc_seq
            stages.append(Stage(
                "attention",
                kv_stream_elems=kv,
                macs=macs,
                vector_ops=3.0 * softmax_elems,  # exp + sum + scale (blockwise)
                n_units=max(self.n_kv_heads, 1),
            ))

            # --- Linear (output projection) ---------------------------------
            stages.append(Stage(
                "linear",
                weight_elems=H * hd * d,
                macs=H * hd * d,
                vector_ops=2 * d,   # residual add + post-norm
                n_units=1,
            ))

            # --- FFN ----------------------------------------------------------
            ffn_w = self.ffn_layer_weights_active()
            ff_width = self.d_ff_expert if self.n_experts > 0 else self.d_ff
            n_act = (self.top_k + self.n_shared_experts) if self.n_experts else 1
            stages.append(Stage(
                "ffn",
                weight_elems=ffn_w,
                macs=ffn_w,  # GEMV: one MAC per weight
                vector_ops=(2 * d                      # pre-norm + residual
                            + n_act * 2 * ff_width     # act + elementwise mul
                            + (self.n_experts or 0)),  # router softmax/top-k
                n_units=1,
            ))

        # --- SSM layers (state stream replaces KV; see DESIGN.md SS4) ------
        if self.n_ssm_layers > 0:
            stages.append(Stage(
                "ssm",
                weight_elems=self.ssm_weight_elems_per_layer,
                macs=self.ssm_macs_per_layer,
                kv_stream_elems=self.ssm_state_elems_per_layer,
                writeback_elems=self.ssm_state_elems_per_layer,
                vector_ops=6 * d,
                n_units=1,
            ))

        return stages

    def layer_multiplicity(self) -> List[float]:
        """How many times each stage list entry repeats across the model."""
        mult = []
        if self.n_attn_layers() > 0:
            mult += [float(self.n_attn_layers())] * 4
        if self.n_ssm_layers > 0:
            mult += [float(self.n_ssm_layers)]
        return mult

    def head_stage(self) -> Stage:
        """Final norm + LM head GEMV over the vocabulary."""
        return Stage(
            "lm_head",
            weight_elems=float(self.vocab) * self.d_model,
            macs=float(self.vocab) * self.d_model,
            vector_ops=2 * self.d_model + self.vocab,  # norm + softmax/argmax
            n_units=1,
        )

    def embed_stage(self) -> Stage:
        return Stage("embedding", kv_stream_elems=float(self.d_model))


def make_dense_spec(name: str, n_layers: int, d_model: int, n_heads: int,
                    n_kv_heads: int, d_ff: int, vocab: int,
                    head_dim: Optional[int] = None, ffn_gated: bool = True,
                    **kw) -> SLMSpec:
    return SLMSpec(name=name, n_layers=n_layers, d_model=d_model,
                   n_heads=n_heads, n_kv_heads=n_kv_heads, d_ff=d_ff,
                   vocab=vocab, head_dim=head_dim, ffn_gated=ffn_gated, **kw)
