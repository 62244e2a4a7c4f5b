"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) 128 experts
top-8, d_ff/expert=1536, vocab=151936 [hf:Qwen/Qwen3-30B-A3B scaled; hf].
QK-norm per the Qwen3 recipe; no shared experts."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
        n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936, head_dim=128,
        qk_norm=True, rope_theta=1e6,
        moe=MoEConfig(n_experts=128, top_k=8, n_shared_experts=0,
                      d_ff_expert=1536,
                      # the grouped one-hot dispatch's kept slots: per
                      # group of 512 tokens when a call has more
                      dispatch="onehot"),
        tie_embeddings=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=8, n_kv_heads=2, d_ff=96, vocab=128, head_dim=16,
        qk_norm=True,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared_experts=0,
                      d_ff_expert=96, capacity_factor=2.5),
        tie_embeddings=False)


register("qwen3-moe-235b-a22b", full, smoke)
