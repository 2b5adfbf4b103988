"""Synthetic deterministic token stream (a numpy-only copy of
``repro/data/pipeline.py``'s ``DataConfig`` and ``SyntheticTokens``; that
module imports jax, so the port keeps its own copy).  The stream is
bit-identical to the JAX package's for the same config and seed.
``make_loader`` yields its batches as tensors on a device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 256
    seed: int = 1234
    zipf_alpha: float = 1.1
    prefetch: int = 2
    structured: bool = True   # inject learnable n-gram structure


class SyntheticTokens:
    """Deterministic synthetic corpus with learnable structure.

    Tokens follow a zipfian marginal; with ``structured=True`` every even
    position deterministically hashes the previous token (a learnable bigram
    rule) so a real model's loss visibly decreases during training.
    """

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg, self.dcfg = cfg, dcfg
        self._rng = np.random.default_rng(dcfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-dcfg.zipf_alpha)
        self._probs = probs / probs.sum()
        self._step = 0

    def _sample(self, shape) -> np.ndarray:
        flat = self._rng.choice(self.cfg.vocab_size, size=int(np.prod(shape)),
                                p=self._probs)
        return flat.reshape(shape).astype(np.int32)

    def next_batch(self) -> Dict[str, np.ndarray]:
        d = self.dcfg
        toks = self._sample((d.batch_size, d.seq_len))
        if d.structured:
            prev = toks[:, :-1].astype(np.int64)
            rule = (prev * 2654435761 % self.cfg.vocab_size).astype(np.int32)
            even = (np.arange(1, d.seq_len) % 2 == 0)[None, :]
            toks[:, 1:] = np.where(even, rule, toks[:, 1:])
        batch: Dict[str, np.ndarray] = {"tokens": toks}
        if self.cfg.family == "vlm":
            k = self._step % 97
            batch["image_embeds"] = _unit_noise(
                (d.batch_size, self.cfg.num_prefix_tokens, self.cfg.d_model),
                self.dcfg.seed + k)
        if self.cfg.family == "audio":
            k = self._step % 97
            batch["audio_embeds"] = _unit_noise(
                (d.batch_size, self.cfg.encoder_seq_len, self.cfg.d_model),
                self.dcfg.seed + k)
        self._step += 1
        return batch


def _unit_noise(shape, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


def make_loader(cfg: ModelConfig, dcfg: DataConfig, *, device
                ) -> Iterator[Dict[str, torch.Tensor]]:
    """The ``SyntheticTokens`` batches of the JAX loader, in the same
    order, as tensors on ``device``.  No prefetch thread: a batch is a
    few KB of host sampling, small beside a training step."""
    source = SyntheticTokens(cfg, dcfg)
    while True:
        yield {k: torch.from_numpy(v).to(device)
               for k, v in source.next_batch().items()}
