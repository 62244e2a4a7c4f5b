"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA with QKV bias [hf:Qwen/Qwen2.5-3B]."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
        n_heads=16, n_kv_heads=2, d_ff=11008, vocab=151936, head_dim=128,
        qkv_bias=True, rope_theta=1e6, tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
        qkv_bias=True, tie_embeddings=True)


register("qwen2.5-3b", full, smoke)
