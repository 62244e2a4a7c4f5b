"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local(1024):global, QK-norm, head_dim=256, dual rope
theta (10k local / 1M global), 128k+ context [hf:google/gemma-3-4b-pt]."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense", n_layers=34, d_model=2560,
        n_heads=8, n_kv_heads=4, d_ff=10240, vocab=262144, head_dim=256,
        ffn_act="gelu_tanh", local_window=1024, local_pattern=6,
        qk_norm=True, rope_theta=1e6, rope_theta_local=10000.0,
        post_block_norm=True, rms_scale_plus_one=True, embed_scale=True,
        tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense", n_layers=6, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
        ffn_act="gelu_tanh", local_window=8, local_pattern=3,
        qk_norm=True, rope_theta=1e6, rope_theta_local=10000.0,
        post_block_norm=True, rms_scale_plus_one=True, embed_scale=True,
        tie_embeddings=True)


register("gemma3-4b", full, smoke, long_ok=True)
