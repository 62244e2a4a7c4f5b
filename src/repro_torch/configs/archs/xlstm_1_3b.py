"""xlstm-1.3b [ssm]: 48L d_model=2048 4H — sLSTM + mLSTM blocks at 7:1
[arXiv:2405.04517].  Recurrent state, O(1) per token decode.  d_ff=0:
mLSTM blocks carry their own up/down projection (factor 2); sLSTM blocks
carry a gated FFN (factor 4/3)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig, SSMConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="xlstm", n_layers=48, d_model=2048,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
        ssm=SSMConfig(mlstm_heads=4, slstm_every=8, proj_factor_mlstm=2.0,
                      proj_factor_slstm=4.0 / 3.0, conv_width=4),
        tie_embeddings=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="xlstm", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=128,
        ssm=SSMConfig(mlstm_heads=4, slstm_every=4, proj_factor_mlstm=2.0,
                      proj_factor_slstm=4.0 / 3.0, conv_width=4),
        tie_embeddings=False)


register("xlstm-1.3b", full, smoke, long_ok=True)
