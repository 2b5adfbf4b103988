"""Basic building blocks: norms, MLPs, RoPE, embeddings, initializers
(the counterpart of ``repro/models/layers.py``).

Pure functions over nested dicts of tensors with the JAX names and
layouts.  Initializers draw from an explicit ``torch.Generator`` with the
JAX package's distributions (they cannot reproduce ``jax.random``'s
bits: parity tests carry the JAX weights over with ``repro_torch.bridge``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
INIT_CHUNK_ELEMS = 1 << 26           # fp32 scratch per draw: 256 MB
_LEAF_HOOK: Optional[Callable] = None


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def leaf_hook(fn: Callable):
    """While the context lasts, every parameter leaf an initializer makes
    is passed to ``fn`` as soon as it is made (in creation order, which
    is the generator's draw order) and replaced by what ``fn`` returns.
    The sharded train step builds its state with it, keeping its block
    of each leaf and freeing the rest at once (``sharding.spmd``)."""
    global _LEAF_HOOK
    before, _LEAF_HOOK = _LEAF_HOOK, fn
    try:
        yield
    finally:
        _LEAF_HOOK = before


def made(t: torch.Tensor) -> torch.Tensor:
    """A new parameter leaf, through the active :func:`leaf_hook`."""
    return t if _LEAF_HOOK is None else _LEAF_HOOK(t)


def normal_(out: torch.Tensor, std: float, generator: torch.Generator):
    """Fill ``out`` with N(0, std²) drawn in fp32 and cast to its dtype,
    a slice of the leading dimension at a time: a full-size stacked leaf
    never needs its whole size in fp32 scratch."""
    rows = out.reshape(-1, out.shape[-1]) if out.dim() > 1 else out.view(1, -1)
    step = max(1, INIT_CHUNK_ELEMS // rows.shape[1])
    for i in range(0, rows.shape[0], step):
        blk = rows[i:i + step]
        draw = torch.randn(blk.shape, generator=generator, device=out.device,
                           dtype=torch.float32)
        blk.copy_(draw.mul_(std))
    return out


def dense_init(shape: Sequence[int], in_axis: int, dtype, *, generator,
               device, stack: Sequence[int] = ()):
    """N(0, 1/fan_in) with fan_in = shape[in_axis]; ``stack`` prepends the
    stacked-layer dimensions."""
    out = torch.empty((*stack, *shape), dtype=dtype, device=device)
    return made(normal_(out, 1.0 / math.sqrt(shape[in_axis]), generator))


def embed_init(shape: Sequence[int], dtype, *, generator, device,
               stack: Sequence[int] = ()):
    out = torch.empty((*stack, *shape), dtype=dtype, device=device)
    return made(normal_(out, 0.02, generator))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(kind: str, d: int, *, device, stack: Sequence[int] = ()):
    shape = (*stack, d)
    p = {"scale": made(torch.ones(shape, dtype=torch.float32, device=device))}
    if kind != "rmsnorm":
        p["bias"] = made(torch.zeros(shape, dtype=torch.float32, device=device))
    return p


def apply_norm(params, x, kind: str, eps: float = 1e-6):
    """rmsnorm or layernorm, computed in fp32 and cast back to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(d: int, ff: int, kind: str, dtype, *, generator, device,
             stack: Sequence[int] = ()):
    kw = dict(generator=generator, device=device, stack=stack)
    p = {"wi": dense_init((d, ff), 0, dtype, **kw)}
    if kind in ("swiglu", "geglu", "glu"):
        p["wg"] = dense_init((d, ff), 0, dtype, **kw)
    p["wo"] = dense_init((ff, d), 0, dtype, **kw)
    return p


def apply_mlp(params, x, kind: str):
    h = x @ params["wi"]
    if kind == "swiglu" or kind == "glu":
        h = F.silu(x @ params["wg"]) * h
    elif kind == "geglu":
        h = F.gelu(x @ params["wg"], approximate="tanh") * h
    else:  # gelu
        h = F.gelu(h, approximate="tanh")
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half RoPE.  x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., None].float() * freqs           # (..., S, hd/2)
    angles = angles[..., None, :]                           # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def init_embeddings(cfg, dtype, *, generator, device):
    p = {"tok": embed_init((cfg.vocab_size, cfg.d_model), dtype,
                           generator=generator, device=device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init((cfg.d_model, cfg.vocab_size), 0, dtype,
                               generator=generator, device=device)
    return p


def embed_tokens(params, tokens):
    return F.embedding(tokens, params["tok"])


def unembed(params, x):
    if "head" in params:
        return x @ params["head"]
    return x @ params["tok"].T
