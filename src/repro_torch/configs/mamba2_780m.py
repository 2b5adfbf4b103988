"""mamba2-780m [arXiv:2405.21060] — SSD (state-space duality), attention-free.

48L d_model=1536, ssm_state=128, expand=2 (d_inner=3072, 48 heads of 64).
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        num_layers=48, d_model=1536, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
        norm="rmsnorm", tie_embeddings=True, max_seq_len=1 << 20,
    )
