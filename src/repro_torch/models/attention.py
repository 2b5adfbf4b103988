"""Attention: GQA + RoPE + (optional) QK-norm / bias / sliding window,
and the whisper decoder's cross-attention (the counterpart of
``repro/models/attention.py``).

Three execution paths:
  * ``einsum``  — plain softmax(QK^T)V for short sequences,
  * ``chunked`` — a loop over query blocks (never materializes the full
                  S×S score matrix; default for S >= CHUNK_THRESHOLD),
  * ``kernel``  — the hand-written CUDA kernels (``kernels.ops``):
                  ``flash_attention`` in prefill, ``flash_decode`` in
                  decode; ``backend="auto"`` takes them for CUDA tensors.

Decode operates on a KV cache of layout (B, KV, S_cache, hd); for
sliding-window attention the cache may be a ring buffer of window size.
Cross-attention K/V keep the reference's layout (B, Se, KV, hd) and go
through ``attend`` non-causal, so on the card they run
``flash_attention``, in decode too (Sq = 1), as the reference's
``decode_step`` runs its prefill kernel there.
"""
from __future__ import annotations

import torch

from . import layers
from ..kernels import ops as kops

CHUNK_THRESHOLD = 2048
Q_CHUNK = 512
NEG_INF = -1e30


def init_attention(cfg, dtype, *, generator, device, stack=()):
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(generator=generator, device=device, stack=stack)
    p = {
        "wq": layers.dense_init((d, cfg.num_heads * hd), 0, dtype, **kw),
        "wk": layers.dense_init((d, cfg.num_kv_heads * hd), 0, dtype, **kw),
        "wv": layers.dense_init((d, cfg.num_kv_heads * hd), 0, dtype, **kw),
        "wo": layers.dense_init((cfg.num_heads * hd, d), 0, dtype, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = layers.made(torch.zeros((*stack, cfg.num_heads * hd), dtype=dtype,
                                           device=device))
        p["bk"] = layers.made(torch.zeros((*stack, cfg.num_kv_heads * hd), dtype=dtype,
                                           device=device))
        p["bv"] = layers.made(torch.zeros((*stack, cfg.num_kv_heads * hd), dtype=dtype,
                                           device=device))
    if cfg.qk_norm:
        p["q_norm"] = layers.init_norm("rmsnorm", hd, device=device, stack=stack)
        p["k_norm"] = layers.init_norm("rmsnorm", hd, device=device, stack=stack)
    return p


def _project_qkv(params, cfg, x, positions, rope: bool = True):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = layers.apply_norm(params["q_norm"], q, "rmsnorm")
        k = layers.apply_norm(params["k_norm"], k, "rmsnorm")
    if rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k, num_heads):
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each kv head."""
    rep = num_heads // k.shape[2]
    return k.repeat_interleave(rep, dim=2) if rep > 1 else k


def _mask_bias(q_pos, k_pos, causal, window, prefix_len):
    """Additive fp32 mask bias (Sq, Sk) from position vectors."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = k_pos[None, :] <= q_pos[:, None]
        if prefix_len:
            ok = ok | (k_pos[None, :] < prefix_len)
    if window:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _softcap(scores, cap):
    if cap and cap > 0:
        return torch.tanh(scores / cap) * cap
    return scores


def _attend_einsum(q, k, v, bias, scale, softcap=0.0):
    """q: (B,Sq,H,hd); k,v: (B,Sk,H,hd); bias: (Sq,Sk) additive."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    scores = _softcap(scores, softcap) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attend_chunked(q, k, v, q_pos, k_pos, causal, window, prefix_len, scale,
                    softcap=0.0):
    """Streaming softmax over query chunks (memory O(Sq_blk*Sk)); a Python
    loop in place of the JAX ``lax.scan``."""
    Sq = q.shape[1]
    nblk = max(1, Sq // Q_CHUNK)
    blk = Sq // nblk
    if nblk * blk != Sq:
        raise ValueError(f"chunked attention: {Sq} query rows do not split "
                         f"into {nblk} equal blocks")
    outs = []
    for i in range(nblk):
        rows = slice(i * blk, (i + 1) * blk)
        bias = _mask_bias(q_pos[rows], k_pos, causal, window, prefix_len)
        outs.append(_attend_einsum(q[:, rows], k, v, bias, scale, softcap))
    return torch.cat(outs, dim=1)


def attend(q, k, v, *, q_pos, k_pos, causal=True, window=0, prefix_len=0,
           softcap=0.0, backend="auto"):
    """Full attention dispatch.  q: (B,Sq,H,hd); k/v: (B,Sk,KV,hd) with
    KV dividing H.  The kernel reads the kv heads in place; the plain
    paths expand them to H heads first, as the JAX package does."""
    backend = kops.resolve_backend(backend, q)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    Sq, Sk = q.shape[1], k.shape[1]
    if backend == "kernel":
        if softcap:
            # the prefill kernel has no logit softcap, and on the card
            # nothing falls back to the plain paths (the decode kernel does
            # take a softcap)
            raise NotImplementedError(
                f"flash_attention (prefill kernel) has no logit softcap "
                f"(softcap={softcap})")
        # the kernel takes the bidirectional prefix itself; the JAX package
        # sends a prefix to its jnp paths (its Pallas kernel has none)
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=int(k_pos.shape[0] - q_pos.shape[0]),
                                    prefix_len=int(prefix_len))
    H = q.shape[2]
    k, v = _expand_kv(k, H), _expand_kv(v, H)
    if backend == "einsum" or (backend == "auto" and max(Sq, Sk) <= CHUNK_THRESHOLD):
        bias = _mask_bias(q_pos, k_pos, causal, window, prefix_len)
        return _attend_einsum(q, k, v, bias, scale, softcap)
    return _attend_chunked(q, k, v, q_pos, k_pos, causal, window, prefix_len,
                           scale, softcap)


# ---------------------------------------------------------------------------
# forward (prefill) self-attention
# ---------------------------------------------------------------------------

def self_attention(params, cfg, x, *, positions=None, causal=True,
                   prefix_len=0, rope=True, window=None, backend="auto",
                   kv_cache=None):
    """``kv_cache``: a layer's {"k", "v"} cache to fill with this call's
    K/V from slot 0 (prefill), so K/V are projected once per layer; or a
    callable given (k, v) (B, S, KV, hd) that writes them itself (a
    model member's block of a sharded cache, ``sharding.spmd``)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions, rope=rope)
    if callable(kv_cache):
        kv_cache(k, v)
    elif kv_cache is not None:
        prefill_into_cache(kv_cache, k, v)
    win = cfg.sliding_window if window is None else window
    out = attend(q, k, v, q_pos=positions, k_pos=positions, causal=causal,
                 window=win, prefix_len=prefix_len,
                 softcap=cfg.attn_logit_softcap, backend=backend)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"]


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch, cache_len, dtype, *, device, stack=()):
    """Cache layout: (*stack, B, KV, S_cache, hd)."""
    shape = (*stack, batch, cfg.num_kv_heads, cache_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_into_cache(cache, k, v, start=0):
    """k,v: (B, S, KV, hd) -> cache[..., start:start+S, :], written in
    place.  Where the JAX update would clamp a slice that runs past the
    cache, this raises."""
    S, S_cache = k.shape[1], cache["k"].shape[2]
    if start < 0 or start + S > S_cache:
        raise ValueError(f"prefill of {S} positions at {start} overflows a "
                         f"cache of {S_cache} slots")
    cache["k"][:, :, start:start + S] = k.transpose(1, 2)
    cache["v"][:, :, start:start + S] = v.transpose(1, 2)
    return cache


def decode_self_attention(params, cfg, x, cache, pos, *, ring=False,
                          rope=True, window=0, backend="auto"):
    """One-token decode step.

    x: (B, 1, d); pos: int — current position (same for the batch).
    cache: dict(k,v) with layout (B, KV, S_cache, hd).
    The new K/V are written IN PLACE into the cache slot: the JAX update
    is functional (it returns new arrays); writing in place here avoids
    copying every layer's cache on every step.  The returned cache is the
    same dict.  On a linear cache a ``pos`` past the last slot raises
    (the JAX update would clamp it silently onto the last slot).
    ``backend="kernel"`` (or ``"auto"`` on the card) runs the attention
    in the ``flash_decode`` kernel, reading the cache in place.
    Returns (out (B,1,d), cache).
    """
    B = x.shape[0]
    hd = cfg.head_dim
    pos = int(pos)
    S_cache = cache["k"].shape[2]
    slot = _cache_slot(pos, S_cache, ring)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions, rope=rope)
    cache["k"][:, :, slot] = k[:, 0]
    cache["v"][:, :, slot] = v[:, 0]

    backend = kops.resolve_backend(backend, x)
    if backend == "kernel":
        out = kops.flash_decode(q[:, 0], cache["k"], cache["v"], pos,
                                window=window,
                                softcap=cfg.attn_logit_softcap or 0.0,
                                ring=ring)
        out = out.reshape(B, 1, cfg.num_heads * hd) @ params["wo"]
        return out, cache

    # positions held in each cache slot (shared ring semantics with the
    # flash_decode wrapper and its plain version — kernels/ref.py)
    bias = kops.decode_bias(pos, S_cache, window=window, ring=ring,
                            device=x.device)[None, :]            # (1, S_cache)

    rep = cfg.num_heads // cfg.num_kv_heads
    kk = cache["k"].repeat_interleave(rep, dim=1) if rep > 1 else cache["k"]
    vv = cache["v"].repeat_interleave(rep, dim=1) if rep > 1 else cache["v"]
    scores = torch.einsum("bqhd,bhsd->bhqs", q, kk).float()
    scores = scores * (1.0 / (hd ** 0.5))
    scores = _softcap(scores, cfg.attn_logit_softcap) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqs,bhsd->bqhd", probs, vv)
    out = out.reshape(B, 1, cfg.num_heads * hd) @ params["wo"]
    return out, cache


def _cache_slot(pos: int, cache_len: int, ring: bool) -> int:
    """The cache slot of position ``pos``; past the last slot of a linear
    cache this raises."""
    if ring:
        return pos % cache_len
    if not 0 <= pos < cache_len:
        raise ValueError(f"decode position {pos} outside a linear cache of "
                         f"{cache_len} slots")
    return pos


def every_kv_head(t, gather_heads, num_kv_heads):
    """Every kv head of a model member's ``t`` (B, S, KV_m, hd): the model
    group's all-gather along the heads, each kv head taken once where
    several members hold it (fewer kv heads than members)."""
    if t.shape[2] == num_kv_heads:
        return t
    full = gather_heads(t)
    return full[:, :, ::full.shape[2] // num_kv_heads]


def write_block(cache, k, v, slot0: int, cache_len: int):
    """Prefill of a block of a cache sharded over its sequence: of the
    prompt's K/V (B, S, KV, hd), at slots 0 … S-1 of a whole cache of
    ``cache_len`` slots, the rows that fall in the block's slots
    ``slot0`` … written in place."""
    S, n = k.shape[1], cache["k"].shape[2]
    if S > cache_len:
        raise ValueError(f"prefill of {S} positions overflows a cache of "
                         f"{cache_len} slots")
    hi = min(slot0 + n, S)
    if hi > slot0:
        cache["k"][:, :, :hi - slot0] = k[:, slot0:hi].transpose(1, 2)
        cache["v"][:, :, :hi - slot0] = v[:, slot0:hi].transpose(1, 2)
    return cache


def decode_on_block(params, cfg, lcfg, x, cache, pos, *, slot0, cache_len, heads,
                    gather_heads, combine=None, ring=False, rope=True, window=0):
    """One model member's share of a decode step where its cache block
    holds every kv head: a cache sharded over its sequence (the block's
    slots ``slot0`` … of a whole cache of ``cache_len``), or the whole
    cache on every member.  ``params`` are the member's Megatron shards
    (``lcfg``'s heads; ``heads`` = (first, n) of the whole model's query
    heads).  Every head's query and the new token's every kv head reach
    the member (``gather_heads``, the model group's all-gather along the
    heads); only the member whose block holds the token's slot writes it.
    ``flash_decode`` then runs every head over the block on the whole
    cache's slots, and ``combine(out, lse)`` (sequence-sharded) merges the
    members' partial softmaxes.  Returns (the member's heads' output
    through its ``wo`` rows, (B, 1, d): a part of the model group's sum,
    cache)."""
    B = x.shape[0]
    pos = int(pos)
    slot = _cache_slot(pos, cache_len, ring)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, lcfg, x, positions, rope=rope)
    q = gather_heads(q)                                           # (B, 1, H, hd)
    k = every_kv_head(k, gather_heads, cfg.num_kv_heads)
    v = every_kv_head(v, gather_heads, cfg.num_kv_heads)
    if slot0 <= slot < slot0 + cache["k"].shape[2]:
        cache["k"][:, :, slot - slot0] = k[:, 0]
        cache["v"][:, :, slot - slot0] = v[:, 0]
    out = kops.flash_decode(q[:, 0], cache["k"], cache["v"], pos, window=window,
                            softcap=cfg.attn_logit_softcap or 0.0, ring=ring,
                            slot0=slot0, cache_len=cache_len,
                            return_lse=combine is not None)
    if combine is not None:
        out = combine(*out)
    first, n = heads
    out = out[:, first:first + n].reshape(B, 1, n * cfg.head_dim)
    return out @ params["wo"], cache


# ---------------------------------------------------------------------------
# cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def init_cross_attention(cfg, dtype, *, generator, device, stack=()):
    return init_attention(cfg, dtype, generator=generator, device=device,
                          stack=stack)


def cross_attention(params, cfg, x, enc_kv, backend="auto"):
    """x: (B, Sq, d) decoder states; enc_kv: (k, v) each (B, Se, KV, hd).
    Every query sees every encoder position (no mask, no RoPE)."""
    B, Sq, _ = x.shape
    hd = cfg.head_dim
    q = x @ params["wq"]
    if cfg.qkv_bias:
        q = q + params["bq"]
    q = q.reshape(B, Sq, cfg.num_heads, hd)
    k, v = enc_kv
    q_pos = torch.arange(Sq, dtype=torch.int32, device=x.device)
    k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
    out = attend(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=False,
                 backend=backend)
    return out.reshape(B, Sq, cfg.num_heads * hd) @ params["wo"]


def encode_cross_kv(params, cfg, enc_out):
    """Cross-attention K/V (B, Se, KV, hd) each from the encoder output
    (no RoPE)."""
    B, Se, _ = enc_out.shape
    hd = cfg.head_dim
    k = enc_out @ params["wk"]
    v = enc_out @ params["wv"]
    if cfg.qkv_bias:
        k, v = k + params["bk"], v + params["bv"]
    return (k.reshape(B, Se, cfg.num_kv_heads, hd),
            v.reshape(B, Se, cfg.num_kv_heads, hd))
