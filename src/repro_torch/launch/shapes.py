"""Assigned input shapes and abstract input specs (the counterpart of
``repro/launch/shapes.py``): meta tensors where the reference has
``ShapeDtypeStruct`` stand-ins, shaped and typed, never allocated."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..models.config import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    """Abstract batch for ``train``/``prefill`` modes (int32 tokens and
    the modality stubs' fp32 embeddings).  Decode token/pos specs come
    from ``decode_specs``."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}
    if cfg.family == "vlm":
        specs["image_embeds"] = torch.empty((B, cfg.num_prefix_tokens, cfg.d_model),
                                            dtype=torch.float32, device=META)
    if cfg.family == "audio":
        specs["audio_embeds"] = torch.empty((B, cfg.encoder_seq_len, cfg.d_model),
                                            dtype=torch.float32, device=META)
    return specs


def decode_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    B = shape.global_batch
    return {"tokens": torch.empty((B, 1), dtype=torch.int32, device=META),
            "pos": torch.empty((), dtype=torch.int32, device=META)}
