"""Top-level model API: init / forward / loss / cache / prefill / decode
(the counterpart of ``repro/models/model.py``, every family of it: dense,
moe, ssm, hybrid, vlm and audio).

A hybrid model (zamba2) is G = num_layers / hybrid_attn_every groups of
``per`` = hybrid_attn_every ssm layers, each group followed by ONE dense
block whose weights all groups share (``shared_attn``); its ssm blocks
are stacked with leading dims (G, per).

A moe model is a dense stack whose blocks run ``moe_block`` in place of
the MLP; ``forward`` returns the layers' summed auxiliary losses as
``metrics["aux_loss"]``, which ``loss_fn`` adds.

An audio model (whisper) is an encoder-decoder: ``enc_blocks``, a
non-causal dense stack over ``audio_embeds + enc_pos`` (the stub
frontend's frames and learned positions) closed by ``enc_final_norm``,
and ``dec_blocks`` of kind ``dec_cross`` over the token embeddings plus
sinusoidal positions; each decoder layer projects its cross K/V from the
encoder output.  No block of it applies RoPE.  Its cache is {"self": the
decoder's {"k", "v"} (L, B, KV, S, hd), "cross": (k, v) each (L, B, Se,
KV, hd)}; prefill fills both, decode writes "self" and reads "cross".

A vlm model (paligemma) is a dense stack whose input is the stub
frontend's ``image_embeds`` (B, P, d), cast to the embeddings' dtype,
followed by the token embeddings: RoPE runs over all P + S positions, and
the first P keys form a bidirectional prefix in every layer
(``prefix_len = P``).  ``forward`` drops the prefix rows after the final
norm, so logits and the loss cover the text only; ``prefill`` fills each
layer's cache with P + S rows and returns P + S as the prompt length.
Decode is the dense path: a query at position >= P sees the prefix
causally, so no prefix mask is needed there.  The frontend is a stub: the
model has no vision weights.

``forward`` and ``loss_fn`` take the sharded train step's ``gather``
(``sharding.spmd``) when the parameters are one rank's blocks: the
non-stacked leaves (embeddings, norms, positions, a hybrid model's
shared block) are gathered whole once, and each layer's blocks are
gathered inside the layer's checkpoint, so the backward's recompute
gathers them again and no whole layer outlives its use.  Every block
then runs as ``gather.block`` (one model member's share of it), and a
whisper decoder layer projects its cross K/V through ``gather.cross_kv``.
Without it (every other caller) the parameters are whole and nothing
changes.

``remat_policy`` (``None`` or ``"dots"``, ``transformer.rematted``) is
the JAX package's: it applies to the layers of a dense, moe, ssm or vlm
stack, whisper's encoder layers and a hybrid model's groups; whisper's
decoder layers and the loss's chunks stay fully rematerialised, as the
reference's ``jax.checkpoint`` without a policy
(``repro/models/model.py:118,189``).
"""
from __future__ import annotations

from typing import Any, Dict

import math

import torch
from torch.utils.checkpoint import checkpoint

from . import attention, layers, ssm as ssm_lib, transformer as tfm
from .config import ModelConfig

PyTree = Any


def _hybrid_groups(cfg: ModelConfig):
    """(G, per): the number of groups and the ssm layers in each."""
    per = cfg.hybrid_attn_every
    if per <= 0 or cfg.num_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split "
                         f"into groups of {per}")
    return cfg.num_layers // per, per


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: torch.device) -> PyTree:
    """Random weights with the JAX package's distributions, names and
    layouts, drawn from ``generator`` (which must live on ``device``)."""
    dtype = layers.dtype_of(cfg)
    kw = dict(generator=generator, device=device)
    p = {"embed": layers.init_embeddings(cfg, dtype, **kw),
         "final_norm": layers.init_norm(cfg.norm, cfg.d_model, device=device)}
    if cfg.family == "audio":
        p["enc_blocks"] = tfm.init_stacked_blocks(cfg, "dense",
                                                  cfg.num_encoder_layers, dtype, **kw)
        p["dec_blocks"] = tfm.init_stacked_blocks(cfg, "dec_cross",
                                                  cfg.num_layers, dtype, **kw)
        p["enc_pos"] = layers.embed_init((cfg.encoder_seq_len, cfg.d_model),
                                         dtype, **kw)
        p["enc_final_norm"] = layers.init_norm(cfg.norm, cfg.d_model,
                                               device=device)
    elif cfg.family == "hybrid":
        p["blocks"] = tfm.init_block(cfg, "ssm", dtype,
                                     stack=_hybrid_groups(cfg), **kw)
        p["shared_attn"] = tfm.init_block(cfg, "dense", dtype, **kw)
    else:
        p["blocks"] = tfm.init_stacked_blocks(cfg, cfg.block_kind,
                                              cfg.num_layers, dtype, **kw)
    return p


def abstract_params(cfg: ModelConfig) -> PyTree:
    """The parameter tree's names, shapes and dtypes on the meta device,
    nothing allocated and nothing drawn: the counterpart of the JAX
    package's ``jax.eval_shape`` of ``init_params``."""
    return init_params(cfg, None, device=torch.device("meta"))


def param_count(params: PyTree) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


# ---------------------------------------------------------------------------
# forward (training / full-sequence)
# ---------------------------------------------------------------------------

_STACKS = ("blocks", "enc_blocks", "dec_blocks")


def _gathered(params, gather):
    """``params`` with its non-stacked leaves gathered whole by a sharded
    step's ``gather`` (as they are without one)."""
    if gather is None:
        return params
    return {k: v if k in _STACKS else gather(v, k) for k, v in params.items()}


def forward(params: PyTree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, remat: bool = True, remat_policy=None, backend: str = "auto",
            unembed: bool = True, gather=None):
    """Returns (logits over the text positions, metrics); with
    ``unembed=False`` returns the final-norm hidden states instead (used
    by the chunked loss)."""
    return _forward(_gathered(params, gather), cfg, batch, remat=remat,
                    remat_policy=remat_policy, backend=backend, unembed=unembed,
                    gather=gather)


def _forward(params, cfg, batch, *, remat, backend, unembed, gather, remat_policy=None):
    """``forward`` on parameters whose non-stacked leaves are whole."""
    x, prefix_len = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    kw = dict(remat=remat, remat_policy=remat_policy, backend=backend, gather=gather)
    if cfg.family == "audio":
        enc = _encode(params, cfg, batch["audio_embeds"], x.dtype, **kw)
        x = _decode_stack(params, cfg, x, enc, positions, remat=remat,
                          backend=backend, gather=gather)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    elif cfg.family == "hybrid":
        x, aux = _hybrid_forward(params, cfg, x, positions, **kw)
    else:
        x, aux = tfm.run_stacked(params["blocks"], cfg, x, cfg.block_kind,
                                 positions=positions, prefix_len=prefix_len, **kw)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    x = x[:, prefix_len:]
    metrics = {"aux_loss": aux}
    if not unembed:
        return x, metrics
    return layers.unembed(params["embed"], x), metrics


def _embed_inputs(params, cfg, batch):
    """The token embeddings, after a vlm model's ``image_embeds`` (B, P, d)
    in their dtype.  Returns (x, the prefix length P; 0 for the other
    families)."""
    x = layers.embed_tokens(params["embed"], batch["tokens"])
    if cfg.family != "vlm":
        return x, 0
    img = batch["image_embeds"].to(x.dtype)
    return torch.cat([img, x], dim=1), img.shape[1]


def _hybrid_forward(params, cfg, x, positions, *, remat, backend, gather=None,
                    remat_policy=None):
    """Each group's ``per`` ssm layers, then the shared dense block; past
    ``max_seq_len`` the shared block attends within the long-context
    window (``repro/models/model.py:121-137``).

    ``remat`` checkpoints each GROUP once, and nothing inside it again.
    The JAX package also remats each ssm layer inside the group, which
    costs nothing extra under XLA; nested ``torch.utils.checkpoint``s
    would run every ssm layer's forward three times a step.  With one
    checkpoint a group every kernel of the group runs twice a step (the
    forward and the backward's recompute): 2·num_layers ``ssd_scan`` and
    2·G ``flash_attention`` launches, and the backward's memory peak is
    one group's activations (under ``remat_policy`` "dots", the group's
    projections' outputs too)."""
    S = x.shape[1]
    window = cfg.effective_long_window if S > cfg.max_seq_len else cfg.sliding_window
    shared = params["shared_attn"]

    run = tfm.block_forward if gather is None else gather.block

    def group(x, gp):
        if gather is not None:
            gp = gather(gp, "blocks")
        for p in tfm.unstack(gp):
            x, _ = run(p, cfg, x, "ssm", backend=backend)
        x, _ = run(shared, cfg, x, "dense", positions=positions, window=window,
                   backend=backend)
        return x

    for gp in tfm.unstack(params["blocks"]):
        x = tfm.rematted(group, x, gp, policy=remat_policy) if remat else group(x, gp)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _encode(params, cfg, audio_embeds, dtype, *, remat, backend, gather=None,
            remat_policy=None):
    """The audio encoder: frames + learned positions through the
    non-causal dense stack (one checkpoint a layer under ``remat``),
    then ``enc_final_norm``."""
    enc = audio_embeds.to(dtype) + params["enc_pos"]
    enc, _ = tfm.run_stacked(params["enc_blocks"], cfg, enc, "dense",
                             remat=remat, remat_policy=remat_policy, backend=backend,
                             causal=False, gather=gather, where="enc_blocks")
    return layers.apply_norm(params["enc_final_norm"], enc, cfg.norm)


def _decode_stack(params, cfg, x, enc, positions, *, remat, backend,
                  cache=None, gather=None):
    """The audio decoder over the full sequence: sinusoidal positions,
    then each ``dec_cross`` layer with its cross K/V projected from
    ``enc`` inside the layer's checkpoint under ``remat`` (as the
    reference's ``jax.checkpoint`` of its scan body).  ``cache`` (a
    prefill's) gets each layer's self K/V and cross K/V in place."""
    x = x + _sinusoidal(positions, cfg.d_model).to(x.dtype)
    for i, p in enumerate(tfm.unstack(params["dec_blocks"])):
        kv = None if cache is None else tfm.layer(cache["self"], i)

        def one(x, enc, p=p, i=i, kv=kv):
            if gather is not None:
                p = gather(p, "dec_blocks")
                ekv = gather.cross_kv(p["xattn"], cfg, enc)
                kw = {}
                if cache is not None:
                    gather.write_cross(ekv, (cache["cross"][0][i], cache["cross"][1][i]))
                    kw["kv_cache"] = gather.cache_writer(kv)
                return gather.block(p, cfg, x, "dec_cross", positions=positions,
                                    enc_kv=ekv, backend=backend, **kw)[0]
            ekv = attention.encode_cross_kv(p["xattn"], cfg, enc)
            if cache is not None:
                cache["cross"][0][i].copy_(ekv[0])
                cache["cross"][1][i].copy_(ekv[1])
            return tfm.block_forward(p, cfg, x, "dec_cross", positions=positions,
                                     enc_kv=ekv, backend=backend, kv_cache=kv)[0]

        x = checkpoint(one, x, enc, use_reentrant=False) if remat else one(x, enc)
    return x


def _sinusoidal(positions, d):
    """(S, d) fp32: sin then cos of position x 10000^(-i / (d/2))."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

LOSS_CHUNK = 1024


def _ce_chunk(embed_params, x_c, t_c, m_c):
    """CE over one sequence chunk; fp32 math, logits never leave the chunk."""
    lg = layers.unembed(embed_params, x_c).float()
    logz = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, t_c[..., None].long())[..., 0]
    return torch.sum((logz - tgt) * m_c)


def chunked_ce(embed_params, hidden, targets, mask, chunk=LOSS_CHUNK):
    """Sum of CE over sequence chunks, each checkpointed: peak memory is
    one chunk's logits instead of the full (B, S, V) fp32 tensor."""
    S = hidden.shape[1]
    if S % chunk or S <= chunk:
        return _ce_chunk(embed_params, hidden, targets, mask)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, chunk):
        sl = slice(i, i + chunk)
        total = total + checkpoint(_ce_chunk, embed_params, hidden[:, sl],
                                   targets[:, sl], mask[:, sl],
                                   use_reentrant=False)
    return total


def loss_fn(params, cfg, batch, *, remat=True, remat_policy=None, backend="auto",
            gather=None):
    """Mean next-token CE over the text positions (the last one masked)
    plus the auxiliary loss.  Returns (total, metrics)."""
    params = _gathered(params, gather)
    hidden, metrics = _forward(params, cfg, batch, remat=remat, remat_policy=remat_policy,
                               backend=backend, unembed=False, gather=gather)
    tokens = batch["tokens"]
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    mask = batch.get("loss_mask")
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device) \
        if mask is None else mask.float().clone()
    mask[:, -1] = 0.0
    ce_sum = chunked_ce(params["embed"], hidden, targets, mask)
    loss = ce_sum / torch.clamp(mask.sum(), min=1.0)
    total = loss + metrics.get("aux_loss", 0.0)
    return total, dict(metrics, ce_loss=loss)


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, cache_len: int, *, device, ring: bool = False):
    """dense and moe: {"k", "v"} of shape (L, B, KV, cache_len, hd); ssm: {"conv"
    (L, B, W-1, conv_dim), "state" (L, B, h, p, n) fp32}; hybrid: {"ssm":
    the ssm cache with leading dims (G, per), "attn": the shared block's
    {"k", "v"} for each group, leading dim G}; audio: {"self": the
    decoder's {"k", "v"} as dense, "cross": (k, v) each (L, B,
    encoder_seq_len, KV, hd), which prefill overwrites}."""
    dtype = layers.dtype_of(cfg)
    if cfg.family == "ssm":
        return ssm_lib.init_ssm_cache(cfg, batch, dtype, device=device,
                                      stack=(cfg.num_layers,))
    if cfg.family == "hybrid":
        G, per = _hybrid_groups(cfg)
        return {"ssm": ssm_lib.init_ssm_cache(cfg, batch, dtype, device=device,
                                              stack=(G, per)),
                "attn": attention.init_kv_cache(cfg, batch, cache_len, dtype,
                                                device=device, stack=(G,))}
    kv = attention.init_kv_cache(cfg, batch, cache_len, dtype,
                                 device=device, stack=(cfg.num_layers,))
    if cfg.family == "audio":
        shape = (cfg.num_layers, batch, cfg.encoder_seq_len, cfg.num_kv_heads,
                 cfg.head_dim)
        cross = tuple(torch.zeros(shape, dtype=dtype, device=device)
                      for _ in range(2))
        return {"self": kv, "cross": cross}
    return kv


def _prefill_ssm(blocks, cfg, x, cache, backend, gather=None):
    """Each layer's mamba2 forward; its cache gets the final ssm state and
    the last W-1 positions of the conv input (before the conv).  With a
    sharded step's ``gather``, the rank's share of each layer
    (``gather.prefill_ssm``) on its gathered leaves fills its cache
    blocks."""
    for i, p in enumerate(tfm.unstack(blocks)):
        if gather is not None:
            x = gather.prefill_ssm(gather(p, "blocks"), cfg, x, tfm.layer(cache, i),
                                   backend=backend)
            continue
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        y, final, conv_tail = ssm_lib.mamba2_forward(p["ssm"], cfg, h,
                                                     backend=backend)
        cache["conv"][i] = conv_tail
        cache["state"][i] = final
        x = x + y
    return x


def prefill(params, cfg, batch: Dict[str, torch.Tensor], cache_len: int, *,
            ring: bool = False, backend: str = "auto", gather=None):
    """Run the prompt through the model, filling caches.

    Returns (cache, logits of the last position (B, V), prompt_len): a
    vlm model's prompt is its P image positions and its S tokens, and its
    cache needs ``cache_len`` >= P + S.
    For ring caches the prompt must fit in the window (serving code feeds
    the window tail only) — standard SWA semantics.

    With a sharded serve step's ``gather`` (``sharding.spmd``) the
    parameters are one rank's blocks, gathered as ``forward`` gathers
    them, and the cache is the rank's block of the whole cache
    (``gather.init_cache``), which each layer's share fills: a hybrid
    group's ssm layers through ``gather.prefill_group``, a whisper
    decoder layer's cross K/V through ``gather.write_cross``.
    """
    tokens = batch["tokens"]
    B = tokens.shape[0]
    if gather is not None:
        params = _gathered(params, gather)
        cache = gather.init_cache(B, cache_len, device=tokens.device)
    else:
        cache = init_cache(cfg, B, cache_len, device=tokens.device)
    x, prefix_len = _embed_inputs(params, cfg, batch)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    if cfg.family == "ssm":
        x = _prefill_ssm(params["blocks"], cfg, x, cache, backend, gather)
    elif cfg.family == "audio":
        enc = _encode(params, cfg, batch["audio_embeds"], x.dtype, remat=False,
                      backend=backend, gather=gather)
        x = _decode_stack(params, cfg, x, enc, positions, remat=False,
                          backend=backend, cache=cache, gather=gather)
    elif cfg.family == "hybrid":
        # the shared block fills group g's KV cache.  No window is passed,
        # so it attends within cfg.sliding_window as the JAX prefill does
        # (repro/models/model.py:303), where forward switches to the
        # long-context window past max_seq_len
        for g, gp in enumerate(tfm.unstack(params["blocks"])):
            kv = tfm.layer(cache["attn"], g)
            if gather is not None:
                x = gather.prefill_group(gp, cfg, x, tfm.layer(cache["ssm"], g),
                                         backend=backend)
                x, _ = gather.block(params["shared_attn"], cfg, x, "dense",
                                    positions=positions, backend=backend,
                                    kv_cache=gather.cache_writer(kv))
                continue
            x = _prefill_ssm(gp, cfg, x, tfm.layer(cache["ssm"], g), backend)
            x, _ = tfm.block_forward(params["shared_attn"], cfg, x, "dense",
                                     positions=positions, backend=backend,
                                     kv_cache=kv)
    else:
        x, _ = tfm.run_stacked(params["blocks"], cfg, x, cfg.block_kind,
                               positions=positions, prefix_len=prefix_len,
                               backend=backend, caches=cache, gather=gather)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    logits = layers.unembed(params["embed"], x[:, -1:])[:, 0]
    return cache, logits, S


def decode_step(params, cfg, tokens, cache, pos: int, *, ring: bool = False,
                window: int = 0, backend: str = "auto", gather=None):
    """One decode step.  tokens: (B, 1) int; pos: int position of this
    token.  ``backend`` routes the per-layer attention to the
    ``flash_decode`` kernel (``"kernel"``, or ``"auto"`` on the card) or
    the einsum cache path; ssm layers take the recurrent update; an audio
    model's cross-attention runs ``attend`` non-causal at Sq = 1 against
    the cross cache (``flash_attention`` on the card).  The cache is
    updated in place.  Returns (logits (B, V), cache).  ``gather`` as
    :func:`prefill`'s: the parameters and the cache are one rank's
    blocks, each layer's leaves gathered for it and freed after it (a
    hybrid group's as one, ``gather.decode_group``)."""
    if gather is not None:
        params = _gathered(params, gather)
    x = layers.embed_tokens(params["embed"], tokens)
    kw = dict(ring=ring, window=window, backend=backend)
    if cfg.family == "audio":
        where = torch.full((1,), int(pos), dtype=torch.int32, device=x.device)
        x = x + _sinusoidal(where, cfg.d_model).to(x.dtype)
        x, _ = tfm.run_stacked_decode(params["dec_blocks"], cfg, x, cache["self"],
                                      pos, "dec_cross", enc_kv=cache["cross"],
                                      gather=gather, where="dec_blocks", **kw)
    elif cfg.family == "hybrid":
        # each group's recurrent ssm steps, then the shared block against
        # the group's KV cache (both updated in place)
        for g in range(tfm.depth(params["blocks"])):
            if gather is not None:
                x = gather.decode_group(tfm.layer(params["blocks"], g), cfg, x,
                                        tfm.layer(cache["ssm"], g), pos, backend=backend)
                x, _ = gather.block_decode(params["shared_attn"], cfg, x,
                                           tfm.layer(cache["attn"], g), pos, "dense", **kw)
                continue
            x, _ = tfm.run_stacked_decode(tfm.layer(params["blocks"], g), cfg, x,
                                          tfm.layer(cache["ssm"], g), pos,
                                          "ssm", **kw)
            x, _ = tfm.block_decode(params["shared_attn"], cfg, x,
                                    tfm.layer(cache["attn"], g), pos, "dense",
                                    **kw)
    else:
        x, cache = tfm.run_stacked_decode(params["blocks"], cfg, x, cache, pos,
                                          cfg.block_kind, gather=gather, **kw)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    logits = layers.unembed(params["embed"], x)[:, 0]
    return logits, cache
