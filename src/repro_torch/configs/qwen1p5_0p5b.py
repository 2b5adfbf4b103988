"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B] — dense with QKV bias.

24L d_model=1024 16H (kv=16) d_ff=2816 SwiGLU vocab=151936.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b", family="dense",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=2816, vocab_size=151936,
        qkv_bias=True, norm="rmsnorm", mlp="swiglu",
        tie_embeddings=True, rope_theta=1000000.0,
        long_context_window=8192, max_seq_len=32768,
    )
