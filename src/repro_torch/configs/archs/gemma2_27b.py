"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — 1:1 local(4096):global alternation, attn/final logit
softcaps, pre+post block norms, head_dim=128 [arXiv:2408.00118; hf]."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", family="dense", n_layers=46, d_model=4608,
        n_heads=32, n_kv_heads=16, d_ff=36864, vocab=256000, head_dim=128,
        ffn_act="gelu_tanh", local_window=4096, local_pattern=2,
        attn_softcap=50.0, final_softcap=30.0, post_block_norm=True,
        rms_scale_plus_one=True, embed_scale=True, tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke", family="dense", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=192, vocab=128, head_dim=16,
        ffn_act="gelu_tanh", local_window=8, local_pattern=2,
        attn_softcap=50.0, final_softcap=30.0, post_block_norm=True,
        rms_scale_plus_one=True, embed_scale=True, tie_embeddings=True)


register("gemma2-27b", full, smoke)
