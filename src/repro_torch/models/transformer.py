"""Block-level composition for the dense, moe, ssm, hybrid and audio
families: stacked-param init (leading layer dims) and the layer loops of
forward and decode (the counterpart of ``repro/models/transformer.py``).

  dense    : [norm -> self-attn -> +res] [norm -> mlp -> +res]
  moe      : [norm -> self-attn -> +res] [norm -> moe -> +res]
  ssm      : [norm -> mamba2 -> +res]
  hybrid   : groups of ssm blocks, each followed by one weight-shared
             dense block (``models.model`` composes them from the two above)
  dec_cross: [ln1 -> self-attn -> +res] [ln3 -> cross-attn -> +res]
             [ln2 -> mlp -> +res] (the whisper decoder; its encoder is a
             non-causal dense stack)

RoPE is off in every block of an audio model (``rope = cfg.family !=
"audio"``, as in the reference): whisper's positions are added to its
embeddings.

A Python loop over the stacked leaves takes the place of ``lax.scan``;
a loop runs over the leading dim of the tree it is given, so a hybrid
group's (per, ...) slice of the (G, per, ...) stack loops like a plain
stack.  With ``remat=True`` (training) each layer runs under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of
``jax.checkpoint``: only the layer's input is kept, and the backward
recomputes the layer, so every kernel of a layer runs twice a step.  A
moe layer's auxiliary loss leaves the checkpoint beside x, so its
gradient reaches the router.  ``remat_policy="dots"`` (:func:`rematted`) is
the counterpart of ``jax.checkpoint_policies.
dots_with_no_batch_dims_saveable``: the checkpoint also keeps the
outputs of the matrix products without batch dims (``aten.mm``,
``aten.addmm``: the projections) and recomputes the rest, the batched
attention products and every kernel included.  Other block kinds raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention, layers, moe as moe_lib, ssm as ssm_lib

PyTree = Any
KINDS = ("dense", "moe", "ssm", "dec_cross")
REMAT_POLICIES = (None, "dots")
# the products without batch dims whose outputs "dots" keeps
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def rematted(fn, *args, policy=None):
    """``fn(*args)`` under a non-reentrant checkpoint: with ``policy``
    None only its inputs are kept and the backward recomputes all of it;
    with ``"dots"`` the outputs of its ``DOTS`` are kept as well and the
    recompute takes them from there."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; expected one of "
                         f"{REMAT_POLICIES}")
    if policy is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=_dots_context)


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
    if kind == "ssm":
        return {"ln1": layers.init_norm(cfg.norm, cfg.d_model, **kw),
                "ssm": ssm_lib.init_ssm(cfg, dtype, generator=generator, **kw)}
    p = {"ln1": layers.init_norm(cfg.norm, cfg.d_model, **kw),
         "attn": attention.init_attention(cfg, dtype, generator=generator, **kw),
         "ln2": layers.init_norm(cfg.norm, cfg.d_model, **kw)}
    if kind == "moe":
        p["moe"] = moe_lib.init_moe(cfg, dtype, generator=generator, **kw)
    else:
        if kind == "dec_cross":
            p["xattn"] = attention.init_cross_attention(cfg, dtype,
                                                        generator=generator, **kw)
            p["ln3"] = layers.init_norm(cfg.norm, cfg.d_model, **kw)
        p["mlp"] = layers.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                                   generator=generator, **kw)
    return p


def init_stacked_blocks(cfg, kind: str, n: int, dtype, *, generator, device):
    """Every leaf carries a leading (n,) layer dimension."""
    return init_block(cfg, kind, dtype, generator=generator, device=device,
                      stack=(n,))


def depth(tree: PyTree) -> int:
    """The leading (layer) dim of a stacked tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def layer(tree: PyTree, i: int) -> PyTree:
    """Entry ``i`` of a stacked tree's leading dim (a layer, or a hybrid
    group's stack of layers): views, so writes reach the stack."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree: PyTree):
    """The entries of a stacked tree's leading dim, by one ``unbind`` per
    leaf: its backward stacks the layers' gradients once, where indexing
    layer by layer would add a full-size zero-padded gradient per layer."""
    if isinstance(tree, dict):
        per_key = {k: unstack(v) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(depth(tree))]
    return tree.unbind(0)


# ---------------------------------------------------------------------------
# per-block forward / decode
# ---------------------------------------------------------------------------

def block_forward(p, cfg, x, kind: str, *, positions=None, causal=True,
                  prefix_len=0, enc_kv=None, window=None, backend="auto",
                  kv_cache=None, routing_sum=None):
    """One block.  Returns (x, metrics): metrics non-empty for moe
    (``moe_block``'s, ``routing_sum`` passed on); ``kv_cache`` is filled
    in place with the block's K/V (prefill); ``enc_kv`` is a
    ``dec_cross`` block's cross K/V."""
    _require(kind)
    if kind == "ssm":
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        y, _, _ = ssm_lib.mamba2_forward(p["ssm"], cfg, h, backend=backend)
        return x + y, {}
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    a = attention.self_attention(p["attn"], cfg, h, positions=positions,
                                 causal=causal, prefix_len=prefix_len,
                                 rope=cfg.family != "audio", window=window,
                                 backend=backend, kv_cache=kv_cache)
    x = x + a
    if kind == "dec_cross":
        h = layers.apply_norm(p["ln3"], x, cfg.norm)
        x = x + attention.cross_attention(p["xattn"], cfg, h, enc_kv, backend)
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    if kind == "moe":
        y, metrics = moe_lib.moe_block(p["moe"], cfg, h, routing_sum)
        return x + y, metrics
    return x + layers.apply_mlp(p["mlp"], h, cfg.mlp), {}


def run_stacked(blocks: PyTree, cfg, x, kind: str, *, remat=False, remat_policy=None,
                backend="auto", caches=None, gather=None, where="blocks", **fwd_kw):
    """Loop over the stacked block params.  Returns (x, aux): aux is the
    fp32 sum over the layers of ``moe_aux_loss + moe_z_loss``, 0 for the
    other kinds.  ``caches`` (stacked like the blocks) is filled in place
    when given; ``remat`` checkpoints each layer under ``remat_policy``
    (:func:`rematted`), which returns its metrics beside x.  With a
    sharded step's ``gather`` the blocks are
    one rank's (``where`` their path in the params): each layer runs
    ``gather.block`` on ``gather(layer, where)``, inside its checkpoint;
    ``caches`` are then the rank's blocks, which ``gather.cache_writer``
    fills."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(unstack(blocks)):
        kv = layer(caches, i) if caches is not None else None
        if gather is None:
            fn = lambda x, p=p, kv=kv: block_forward(
                p, cfg, x, kind, backend=backend, kv_cache=kv, **fwd_kw)
        else:
            kw = fwd_kw if kv is None else dict(fwd_kw, kv_cache=gather.cache_writer(kv))
            fn = lambda x, p=p, kw=kw: gather.block(gather(p, where), cfg, x, kind,
                                                    backend=backend, **kw)
        x, m = rematted(fn, x, policy=remat_policy) if remat else fn(x)
        if m:
            aux = aux + (m["moe_aux_loss"] + m["moe_z_loss"])
    return x, aux


def block_decode(p, cfg, x, cache, pos, kind: str, *, ring=False, window=0,
                 enc_kv=None, backend="auto"):
    """One block, one token.  The attention cache is updated in place;
    the ssm cache is returned anew (its conv window shifts); a
    ``dec_cross`` block reads its cross K/V ``enc_kv``.  Returns (x,
    cache)."""
    _require(kind)
    if kind == "ssm":
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        y, cache = ssm_lib.mamba2_decode_step(p["ssm"], cfg, h, cache)
        return x + y, cache
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    a, cache = attention.decode_self_attention(
        p["attn"], cfg, h, cache, pos, ring=ring, rope=cfg.family != "audio",
        window=window, backend=backend)
    x = x + a
    if kind == "dec_cross":
        h = layers.apply_norm(p["ln3"], x, cfg.norm)
        x = x + attention.cross_attention(p["xattn"], cfg, h, enc_kv, backend)
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    if kind == "moe":
        y, _ = moe_lib.moe_block(p["moe"], cfg, h)
        return x + y, cache
    return x + layers.apply_mlp(p["mlp"], h, cfg.mlp), cache


def run_stacked_decode(blocks, cfg, x, caches, pos, kind: str, *, ring=False,
                       window=0, enc_kv=None, backend="auto", gather=None,
                       where="blocks"):
    """Loop over (stacked blocks, stacked caches); each layer's cache is
    written back into the stack in place.  ``enc_kv``: the stacked cross
    K/V pair, (L, B, Se, KV, hd) each, read layer by layer.  With a
    sharded step's ``gather`` the blocks and caches are one rank's: each
    layer's leaves are gathered (``gather(layer, where)``), run as the
    rank's share of the block (``gather.block_decode``) and freed."""
    for i in range(depth(blocks)):
        c = layer(caches, i)
        ekv = None if enc_kv is None else (enc_kv[0][i], enc_kv[1][i])
        if gather is not None:
            x, new = gather.block_decode(gather(layer(blocks, i), where), cfg, x, c,
                                         pos, kind, ring=ring, window=window,
                                         enc_kv=ekv, backend=backend)
        else:
            x, new = block_decode(layer(blocks, i), cfg, x, c, pos, kind,
                                  ring=ring, window=window, enc_kv=ekv,
                                  backend=backend)
        for key, t in new.items():
            if t is not c[key]:
                c[key].copy_(t)
    return x, caches
