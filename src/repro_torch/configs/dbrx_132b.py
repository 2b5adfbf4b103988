"""dbrx-132b [hf:databricks/dbrx-base] — fine-grained MoE, 16 experts top-4.

40L d_model=6144 48H (GQA kv=8) expert d_ff=10752 (GLU) vocab=100352.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=10752, vocab_size=100352,
        num_experts=16, experts_per_token=4,
        norm="layernorm", mlp="glu", rope_theta=500000.0,
        long_context_window=8192, max_seq_len=32768,
    )
