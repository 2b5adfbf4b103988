"""Block-level composition for the dense family: stacked-param init
(leading layer dim) and the layer loops of forward and decode (the
counterpart of ``repro/models/transformer.py``).

  dense : [norm -> self-attn -> +res] [norm -> mlp -> +res]

A Python loop over the stacked leaves takes the place of ``lax.scan``;
there is no remat, since the port serves only.  Other block kinds raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

from . import attention, layers

PyTree = Any
KINDS = ("dense",)


def _require(kind: str):
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r}: the port runs {KINDS} blocks only")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(cfg, kind: str, dtype, *, generator, device, stack=()) -> PyTree:
    _require(kind)
    kw = dict(device=device, stack=stack)
    return {"ln1": layers.init_norm(cfg.norm, cfg.d_model, **kw),
            "attn": attention.init_attention(cfg, dtype, generator=generator, **kw),
            "ln2": layers.init_norm(cfg.norm, cfg.d_model, **kw),
            "mlp": layers.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                                   generator=generator, **kw)}


def init_stacked_blocks(cfg, kind: str, n: int, dtype, *, generator, device):
    """Every leaf carries a leading (n,) layer dimension."""
    return init_block(cfg, kind, dtype, generator=generator, device=device,
                      stack=(n,))


def layer(tree: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a stacked tree: views, so writes reach the stack."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# per-block forward / decode
# ---------------------------------------------------------------------------

def block_forward(p, cfg, x, kind: str, *, positions=None, causal=True,
                  prefix_len=0, window=None, backend="auto", kv_cache=None):
    """One block.  Returns (x, metrics); ``kv_cache`` is filled in place
    with the block's K/V (prefill)."""
    _require(kind)
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    a = attention.self_attention(p["attn"], cfg, h, positions=positions,
                                 causal=causal, prefix_len=prefix_len,
                                 window=window, backend=backend,
                                 kv_cache=kv_cache)
    x = x + a
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    return x + layers.apply_mlp(p["mlp"], h, cfg.mlp), {}


def run_stacked(blocks: PyTree, cfg, x, kind: str, *, backend="auto",
                caches=None, **fwd_kw):
    """Loop over the stacked block params; ``caches`` (stacked like the
    blocks) is filled in place when given."""
    for i in range(cfg.num_layers):
        kv = layer(caches, i) if caches is not None else None
        x, _ = block_forward(layer(blocks, i), cfg, x, kind, backend=backend,
                             kv_cache=kv, **fwd_kw)
    return x


def block_decode(p, cfg, x, cache, pos, kind: str, *, ring=False, window=0,
                 backend="auto"):
    _require(kind)
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    a, cache = attention.decode_self_attention(
        p["attn"], cfg, h, cache, pos, ring=ring, window=window,
        backend=backend)
    x = x + a
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    return x + layers.apply_mlp(p["mlp"], h, cfg.mlp), cache


def run_stacked_decode(blocks, cfg, x, caches, pos, kind: str, *, ring=False,
                       window=0, backend="auto"):
    """Loop over (stacked blocks, stacked caches); caches update in place."""
    for i in range(cfg.num_layers):
        x, _ = block_decode(layer(blocks, i), cfg, x, layer(caches, i), pos,
                            kind, ring=ring, window=window, backend=backend)
    return x, caches
