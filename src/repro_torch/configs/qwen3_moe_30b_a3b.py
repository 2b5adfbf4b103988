"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4, head_dim=128, QK-norm) expert d_ff=768,
vocab=151936, MoE 128 experts top-8.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=768, vocab_size=151936,
        num_experts=128, experts_per_token=8,
        qk_norm=True, norm="rmsnorm", mlp="swiglu", rope_theta=1000000.0,
        long_context_window=8192, max_seq_len=32768,
    )
