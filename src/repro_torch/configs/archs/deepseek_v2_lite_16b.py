"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + 64 routed experts top-6
+ 2 shared, d_ff/expert=1408 [arXiv:2405.04434; hf].  27L d_model=2048 16H
vocab=102400; layer 0 is a dense FFN (d_ff=10944) per the HF config."""
from repro_torch.configs.registry import register
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=10944, vocab=102400, head_dim=128,
        attn_kind="mla",
        mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2,
                      d_ff_expert=1408, first_dense_layers=1,
                      first_dense_d_ff=10944, dispatch="onehot"),
        tie_embeddings=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke", family="moe", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, head_dim=16,
        attn_kind="mla",
        mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, n_shared_experts=1,
                      d_ff_expert=32, first_dense_layers=1,
                      first_dense_d_ff=128, capacity_factor=2.5),
        tie_embeddings=False)


register("deepseek-v2-lite-16b", full, smoke)
