"""The paper's 12-SLM benchmark suite (Sec. V, Fig. 9) as core.SLMSpec.

Architecture numbers from the public HF configs of each model.  These feed
the EdgeCIM analytical simulator / DSE — they are the *workload* side of
the co-design and are deliberately lightweight (no JAX model needed for the
paper's own evaluation; the JAX models cover the assigned architectures).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.workload import SLMSpec

PAPER_SLMS: Dict[str, SLMSpec] = {
    "tinyllama-1.1b": SLMSpec(
        name="tinyllama-1.1b", n_layers=22, d_model=2048, n_heads=32,
        n_kv_heads=4, d_ff=5632, vocab=32000, head_dim=64),
    "llama3.2-1b": SLMSpec(
        name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32,
        n_kv_heads=8, d_ff=8192, vocab=128256, head_dim=64),
    "llama3.2-3b": SLMSpec(
        name="llama3.2-3b", n_layers=28, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=8192, vocab=128256, head_dim=128),
    "phi3.5-mini-3.8b": SLMSpec(
        name="phi3.5-mini-3.8b", n_layers=32, d_model=3072, n_heads=32,
        n_kv_heads=32, d_ff=8192, vocab=32064, head_dim=96),
    "qwen2.5-0.5b": SLMSpec(
        name="qwen2.5-0.5b", n_layers=24, d_model=896, n_heads=14,
        n_kv_heads=2, d_ff=4864, vocab=151936, head_dim=64, qkv_bias=True),
    "qwen2.5-1.5b": SLMSpec(
        name="qwen2.5-1.5b", n_layers=28, d_model=1536, n_heads=12,
        n_kv_heads=2, d_ff=8960, vocab=151936, head_dim=128, qkv_bias=True),
    "qwen2.5-3b": SLMSpec(
        name="qwen2.5-3b", n_layers=36, d_model=2048, n_heads=16,
        n_kv_heads=2, d_ff=11008, vocab=151936, head_dim=128, qkv_bias=True),
    "smollm2-1.7b": SLMSpec(
        name="smollm2-1.7b", n_layers=24, d_model=2048, n_heads=32,
        n_kv_heads=32, d_ff=8192, vocab=49152, head_dim=64),
    "smollm3-3b": SLMSpec(
        name="smollm3-3b", n_layers=36, d_model=2048, n_heads=16,
        n_kv_heads=4, d_ff=11008, vocab=128256, head_dim=128),
    "qwen3-0.6b": SLMSpec(
        name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16,
        n_kv_heads=8, d_ff=3072, vocab=151936, head_dim=128),
    "qwen3-1.7b": SLMSpec(
        name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=8, d_ff=6144, vocab=151936, head_dim=128),
    "qwen3-4b": SLMSpec(
        name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32,
        n_kv_heads=8, d_ff=9728, vocab=151936, head_dim=128),
}


def paper_slm(name: str) -> SLMSpec:
    return PAPER_SLMS[name]
