"""moonshot-v1-16b-a3b — Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B].

Assignment: 48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840,
MoE 64 experts top-6.  (Assignment overrides the model card's MLA/shared
experts — see DESIGN.md §7.)
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=163840,
        num_experts=64, experts_per_token=6,
        norm="rmsnorm", mlp="swiglu", rope_theta=50000.0,
        long_context_window=8192, max_seq_len=8192,
    )
