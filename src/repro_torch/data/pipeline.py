"""Synthetic deterministic data pipeline (a numpy-only copy of
``repro/data/pipeline.py``; that module imports jax, so the port keeps
its own copy).  The stream is bit-identical to the JAX package's for the
same config and seed.  ``make_loader`` returns a :class:`DataLoader`: a
host thread prefetches the global batches, and the consumer takes a
rank's rows of each and copies them to the rank's device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

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


def _worker(source, q: queue.Queue, stop: threading.Event):
    try:
        while not stop.is_set():
            batch = source.next_batch()
            while not stop.is_set():
                try:
                    q.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue
    except BaseException as e:  # surface worker crashes to the consumer
        q.put(e)


class DataLoader:
    """Host-side prefetching iterator (the JAX package's ``DataLoader``):
    a daemon thread draws up to ``prefetch`` global batches of ``source``
    ahead; ``next`` takes the next one, keeps the batch rows ``rows``
    (all of them when None) and copies it to ``device``.  A worker's
    exception surfaces as ``RuntimeError("data worker failed")`` from it;
    :meth:`close` stops the thread."""

    def __init__(self, source: SyntheticTokens, *, device, rows=None,
                 prefetch: int = 2):
        self.source, self.device = source, torch.device(device)
        self.rows = None if rows is None else np.asarray(rows)
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        # the thread holds the queue, not the loader, so that a loader
        # nobody closes still stops once it is collected (``__del__``)
        self._thread = threading.Thread(target=_worker, args=(source, self._q, self._stop),
                                        daemon=True)
        self._thread.start()

    def __del__(self):
        self._stop.set()

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = self._q.get()
        if isinstance(batch, BaseException):
            raise RuntimeError("data worker failed") from batch
        if self.rows is not None:
            batch = {k: v[self.rows] for k, v in batch.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


def make_loader(cfg: ModelConfig, dcfg: DataConfig, *, device,
                rows: Optional[np.ndarray] = None) -> DataLoader:
    """The ``SyntheticTokens`` batches of the JAX loader, in the same
    order, as tensors on ``device``: of each, the batch rows ``rows``
    (a rank's, ``sharding.spmd.local_rows``) or all of them."""
    return DataLoader(SyntheticTokens(cfg, dcfg), device=device, rows=rows,
                      prefetch=dcfg.prefetch)
