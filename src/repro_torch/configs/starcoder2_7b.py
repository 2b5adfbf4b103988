"""starcoder2-7b [arXiv:2402.19173] — GQA + RoPE + native sliding window.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 (non-gated GELU) vocab=49152.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", family="dense",
        num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
        d_ff=18432, vocab_size=49152,
        qkv_bias=True, norm="layernorm", mlp="gelu",
        rope_theta=1000000.0, sliding_window=4096, max_seq_len=16384,
    )
