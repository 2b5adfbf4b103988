"""paligemma-3b [arXiv:2407.07726] — SigLIP (stub) + Gemma-2B LM, prefix-LM.

LM backbone: 18L d_model=2048 8H (MQA kv=1, head_dim=256) d_ff=16384 GeGLU,
vocab=257216; 256 image tokens enter as a bidirectional prefix.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm",
        num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
        head_dim=256, d_ff=16384, vocab_size=257216,
        norm="rmsnorm", mlp="geglu", tie_embeddings=True,
        num_prefix_tokens=256, long_context_window=8192, max_seq_len=8192,
    )
