"""musicgen-medium [audio]: decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].  48L d_model=1536 24H (MHA) d_ff=6144 vocab=2048.
Backbone only — the EnCodec frontend is a stub: the caller feeds
precomputed frame embeddings (`inputs["embeddings"]`;
`repro_torch.data.FrontendStub` for training).  LayerNorm + (non-gated)
GELU FFN per the original transformer recipe."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="dense", n_layers=48, d_model=1536,
        n_heads=24, n_kv_heads=24, d_ff=6144, vocab=2048,
        norm_kind="layer", ffn_act="gelu", ffn_gated=False,
        embed_inputs=False, tie_embeddings=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=64,
        norm_kind="layer", ffn_act="gelu", ffn_gated=False,
        embed_inputs=False, tie_embeddings=False)


register("musicgen-medium", full, smoke, long_ok=False)
