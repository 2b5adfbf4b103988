"""Serving entry points: batched prefill and single-token decode steps
(the counterpart of ``repro/training/serve_step.py``).

For long contexts, attention archs use a sliding-window ring-buffer cache
(the sub-quadratic variant); a native sliding window bounds the cache too.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import model as M
from ..models.config import ModelConfig

PyTree = Any

LONG_THRESHOLD = 65536  # above this a full KV cache is out of scope


def cache_plan(cfg: ModelConfig, seq_len: int) -> Dict[str, Any]:
    """Decide cache length / ring-buffer / window for a decode workload at
    ``seq_len`` total positions.

    * SSM: no KV cache (O(1) recurrent state).
    * seq_len > LONG_THRESHOLD: requires the sub-quadratic sliding-window
      variant (ring buffer of window size); pure full-attention archs
      without a window raise.
    * otherwise: a native sliding window (e.g. starcoder2's 4096) bounds
      the cache; else a full cache of seq_len.
    """
    if cfg.family == "ssm":
        return {"cache_len": 0, "ring": False, "window": 0}
    if seq_len > LONG_THRESHOLD:
        w = cfg.effective_long_window
        if not w:
            raise ValueError(
                f"{cfg.name}: decode at {seq_len} needs a sliding-window "
                "variant (cfg.long_context_window) — full attention at this "
                "length is out of scope")
        return {"cache_len": w, "ring": True, "window": w}
    win = cfg.sliding_window
    if win and seq_len > win:
        return {"cache_len": win, "ring": True, "window": win}
    return {"cache_len": seq_len, "ring": False, "window": 0}


def make_prefill_step(cfg: ModelConfig, cache_len: int, *, backend="auto"):
    # VLM: the bidirectional image prefix occupies cache slots too
    eff_len = cache_len + cfg.num_prefix_tokens

    def prefill_step(params, batch):
        cache, logits, _ = M.prefill(params, cfg, batch, eff_len,
                                     backend=backend)
        return cache, logits
    return prefill_step


def make_decode_step(cfg: ModelConfig, seq_len: int, *, backend="auto"):
    plan = cache_plan(cfg, seq_len)

    def serve_step(params, cache, tokens, pos):
        """tokens: (B, 1); pos: int current position.  The cache is
        updated in place and returned."""
        logits, cache = M.decode_step(params, cfg, tokens, cache, pos,
                                      ring=plan["ring"], window=plan["window"],
                                      backend=backend)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return logits, next_tok, cache

    return serve_step, plan


def init_serve_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
                     device) -> PyTree:
    plan = cache_plan(cfg, seq_len)
    return M.init_cache(cfg, batch, max(plan["cache_len"], 1), device=device)


def abstract_serve_cache(cfg: ModelConfig, batch: int, seq_len: int) -> PyTree:
    """``init_serve_cache`` on the meta device: the cache's names, shapes
    and dtypes, nothing allocated (the JAX package's ``jax.eval_shape``
    of it)."""
    return init_serve_cache(cfg, batch, seq_len, device=torch.device("meta"))
