"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA [arXiv:2404.14219]."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
        n_heads=40, n_kv_heads=10, d_ff=17920, vocab=100352, head_dim=128,
        tie_embeddings=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=192, vocab=128, head_dim=16,
        tie_embeddings=False)


register("phi3-medium-14b", full, smoke, long_ok=False)
