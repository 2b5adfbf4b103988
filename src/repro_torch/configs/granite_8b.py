"""granite-8b [arXiv:2405.04324] — LLaMA-architecture code model.

36L d_model=4096 32H (GQA kv=8) d_ff=14336 SwiGLU vocab=49152.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", family="dense",
        num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=49152,
        norm="rmsnorm", mlp="swiglu", rope_theta=10000.0,
        long_context_window=8192, max_seq_len=8192,
    )
