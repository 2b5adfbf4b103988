"""Top-level model API for serving: init / cache / prefill / decode (the
counterpart of ``repro/models/model.py`` for the dense family).

Other families (moe, ssm, hybrid, vlm, audio) raise
``NotImplementedError`` when a model is built.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import attention, layers, transformer as tfm
from .config import ModelConfig

PyTree = Any
FAMILIES = ("dense",)


def _require_family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(the port runs {FAMILIES})")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: torch.device) -> PyTree:
    """Random weights with the JAX package's distributions, names and
    layouts, drawn from ``generator`` (which must live on ``device``)."""
    _require_family(cfg)
    dtype = layers.dtype_of(cfg)
    kw = dict(generator=generator, device=device)
    return {
        "embed": layers.init_embeddings(cfg, dtype, **kw),
        "final_norm": layers.init_norm(cfg.norm, cfg.d_model, device=device),
        "blocks": tfm.init_stacked_blocks(cfg, cfg.block_kind,
                                          cfg.num_layers, dtype, **kw),
    }


def param_count(params: PyTree) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, cache_len: int, *, device, ring: bool = False):
    """{"k", "v"} of shape (L, B, KV, cache_len, hd)."""
    _require_family(cfg)
    return attention.init_kv_cache(cfg, batch, cache_len, layers.dtype_of(cfg),
                                   device=device, stack=(cfg.num_layers,))


def prefill(params, cfg, batch: Dict[str, torch.Tensor], cache_len: int, *,
            ring: bool = False, backend: str = "auto"):
    """Run the prompt through the model, filling caches.

    Returns (cache, logits of the last position (B, V), prompt_len).
    For ring caches the prompt must fit in the window (serving code feeds
    the window tail only) — standard SWA semantics.
    """
    _require_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, cache_len, device=tokens.device)
    x = layers.embed_tokens(params["embed"], tokens)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = tfm.run_stacked(params["blocks"], cfg, x, cfg.block_kind,
                        positions=positions, backend=backend, caches=cache)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    logits = layers.unembed(params["embed"], x[:, -1:])[:, 0]
    return cache, logits, S


def decode_step(params, cfg, tokens, cache, pos: int, *, ring: bool = False,
                window: int = 0, backend: str = "auto"):
    """One decode step.  tokens: (B, 1) int; pos: int position of this
    token.  ``backend`` routes the per-layer attention to the
    ``flash_decode`` kernel (``"kernel"``, or ``"auto"`` on the card) or
    the einsum cache path.  The cache is updated in place.  Returns
    (logits (B, V), cache)."""
    _require_family(cfg)
    x = layers.embed_tokens(params["embed"], tokens)
    x, cache = tfm.run_stacked_decode(params["blocks"], cfg, x, cache, pos,
                                      cfg.block_kind, ring=ring, window=window,
                                      backend=backend)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    logits = layers.unembed(params["embed"], x)[:, 0]
    return logits, cache
