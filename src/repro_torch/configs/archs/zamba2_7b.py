"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336
ssm_state=64 — Mamba2 backbone + a SHARED attention+MLP block invoked
every 6 mamba layers with per-site LoRA (13 invocations + 3 trailing
mamba layers; 13*6+3 = 81) [arXiv:2411.15242]."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig, SSMConfig, ZambaConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="zamba", n_layers=81, d_model=3584,
        n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000, head_dim=112,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      chunk=256),
        zamba=ZambaConfig(shared_every=6, lora_rank=64, shared_d_ff=14336),
        tie_embeddings=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="zamba", n_layers=5, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, head_dim=16,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      chunk=16),
        zamba=ZambaConfig(shared_every=2, lora_rank=8, shared_d_ff=128),
        tie_embeddings=False)


register("zamba2-7b", full, smoke, long_ok=True)
