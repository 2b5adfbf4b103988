"""zamba2-2.7b [arXiv:2411.15242] — Mamba2 backbone + weight-shared attention
blocks (one shared transformer block applied every 6 SSM layers).

54L d_model=2560 32H (kv=32) shared-block d_ff=10240, ssm_state=64.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
        d_ff=10240, vocab_size=32000,
        ssm_state=64, ssm_expand=2, ssm_headdim=64,
        hybrid_attn_every=6,
        norm="rmsnorm", mlp="gelu", long_context_window=4096,
        max_seq_len=1 << 20,
    )
