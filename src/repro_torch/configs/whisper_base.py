"""whisper-base [arXiv:2212.04356] — encoder-decoder audio model.

6L enc + 6L dec, d_model=512 8H (kv=8) d_ff=2048 GELU vocab=51865; the
mel-spectrogram + conv frontend is a stub: input_specs() feeds precomputed
frame embeddings (B, 1500, 512).  Sinusoidal positions replace the learned
table so decode positions are unbounded (DESIGN.md §7).
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
        d_ff=2048, vocab_size=51865,
        is_encoder_decoder=True, num_encoder_layers=6, encoder_seq_len=1500,
        norm="layernorm", mlp="gelu", max_seq_len=448,
    )
