"""h2-100b — the paper's own 100B model (Table 4): LLaMA-style, GQA.

96L hidden=8192 64H (8 queries per KV head -> kv=8) d_ff=36864 vocab=92544,
max seq 4096 (InternLM2-100B family per reference [5]).
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2-100b", family="dense",
        num_layers=96, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=36864, vocab_size=92544,
        norm="rmsnorm", mlp="swiglu", rope_theta=1000000.0,
        long_context_window=8192, max_seq_len=4096,
    )
