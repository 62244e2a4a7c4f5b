"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — Mistral-NeMo-style text decoder [hf:mistralai/Pixtral-12B].
Backbone only: the Pixtral-ViT frontend is a stub; the caller feeds
precomputed patch+text embeddings (`inputs["embeddings"]`;
`repro_torch.data.FrontendStub` for training)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072, head_dim=128,
        rope_theta=1e6, embed_inputs=False, tie_embeddings=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
        embed_inputs=False, tie_embeddings=False)


register("pixtral-12b", full, smoke)
