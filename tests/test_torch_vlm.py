"""The port's vlm family (paligemma: stub image embeddings that enter a
dense stack as a bidirectional prefix) held against the JAX package on
the CPU.

Two fp32 configs (``conftest.exact_cfg``): paligemma's smoke config (2
layers, d 256, 2 heads over 1 kv head of 64, GeGLU, 8 image tokens) and
a variant at head_dim 256, paligemma's own, so that both packages run
hd 256.  Weights come from the JAX ``init_params`` (norm scales
perturbed) and cross with ``repro_torch.bridge``; tokens and image
embeddings are numpy-seeded.

Tolerances, as ``tests/test_torch_audio.py`` holds the audio family:
logits atol/rtol 1e-4, losses rtol 2e-5 (the same fp32 sums in another
order), gradients atol 1e-4 of each leaf's largest value, served logits
and caches atol/rtol 2e-4 with greedy tokens exact; attention alone
atol 1e-5 (``tests/test_torch_kernels.py``).  The bf16 tensor-core
``flash_attention`` arithmetic at paligemma's prefix and head_dim is
rehearsed under chip_smoke's bf16 tolerance, and the split-K
``flash_decode`` at G 8, hd 256 in fp32.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import exact_cfg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.training import train_step as JTS
from repro_torch import bridge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.training import train_step as TTS
from repro_torch.tree import flatten
from test_torch_hybrid import _count_kernel_calls
from test_torch_kernels import (CS, jax_prefix_attention, pv_partition,
                                split_decode_emulated, tc_attention_emulated)

DEV = torch.device("cpu")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)
ATTN_ATOL = 1e-5
LOSS_RTOL = 2e-5
GRAD_TOL = 1e-4
CONFIGS = ["smoke", "hd256"]
PALIGEMMA_PARAMS = 2_508_662_784


@pytest.fixture(autouse=True)
def _two_threads():
    """Two cores, not all: tier-1 runs test files in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfgs(which):
    jcfg = exact_cfg("paligemma_3b")
    if which == "hd256":
        jcfg = dataclasses.replace(jcfg, head_dim=256, num_heads=2, num_kv_heads=1)
    assert jcfg.family == "vlm" and jcfg.dtype == "float32"
    assert jcfg.num_prefix_tokens == 8
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _weights(jcfg, seed=0):
    """JAX init as numpy, with every norm scale perturbed."""
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "scale":
                t[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    perturb(tree)
    return jax.tree.map(jnp.asarray, tree), tree


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "image_embeds": rng.standard_normal(
                (B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    return x.detach().float().numpy().copy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _shapes(tree):
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: v for k, sub in tree.items()
                for p, v in _shapes(sub).items()}
    return {"": (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def _grads_close(got, want):
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = want[name].astype(np.float32)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# prefix-LM attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,Sq,hd,prefix,window", [
    ("einsum", 40, 64, 8, 0), ("einsum", 40, 256, 13, 0), ("einsum", 40, 64, 20, 9),
    ("chunked", 1024, 64, 300, 0), ("chunked", 1024, 256, 256, 0)])
def test_attend_with_prefix_matches_jax(backend, Sq, hd, prefix, window):
    """The port's ``attend`` (einsum, and the chunked loop over query
    blocks) with a bidirectional prefix against ``repro.models.attention
    .attend`` on the same inputs; the prefix moves the output."""
    rng = np.random.default_rng(Sq + hd + prefix)
    B, H, KV = 1, 2, 1
    q, k, v = _randn(rng, B, Sq, H, hd), _randn(rng, B, Sq, KV, hd), _randn(rng, B, Sq, KV, hd)
    pos = np.arange(Sq, dtype=np.int32)
    kw = dict(window=window, prefix_len=prefix)
    want = JA.attend(jnp.asarray(q), jnp.repeat(k, H // KV, 2), jnp.repeat(v, H // KV, 2),
                     q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos), backend=backend, **kw)
    tq, tk, tv, tpos = map(torch.from_numpy, (q, k, v, pos))
    if backend == "chunked":
        rep = lambda t: t.repeat_interleave(H // KV, 2)
        got = TA._attend_chunked(tq, rep(tk), rep(tv), tpos, tpos, True, window, prefix,
                                 1.0 / hd ** 0.5)
    else:
        got = TA.attend(tq, tk, tv, q_pos=tpos, k_pos=tpos, backend=backend, **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=2e-5)
    plain = TA.attend(tq, tk, tv, q_pos=tpos, k_pos=tpos, backend="einsum", window=window)
    assert np.abs(_np(plain) - _np(got)).max() > 1e-2


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window,q_offset,prefix", [
    (2, 40, 40, 2, 1, 64, True, 0, 0, 8),        # the smoke config's prefix
    (1, 30, 30, 4, 1, 256, True, 0, 0, 13),      # hd 256, MQA
    (1, 70, 70, 2, 2, 64, True, 20, 0, 65),      # a prefix past a tile, window
    (1, 20, 50, 2, 1, 256, True, 0, 30, 40),     # q_offset (a prefill's tail)
    (1, 24, 24, 2, 1, 64, False, 0, 0, 10),      # non-causal: the prefix is moot
])
def test_flash_attention_ref_with_prefix_and_grad_match_jax(B, Sq, Sk, H, KV, hd, causal,
                                                           window, q_offset, prefix):
    """``ref.flash_attention_ref`` and the CPU wrapper with ``prefix_len``
    against the reference's ``_attend_einsum`` + ``_mask_bias`` (fp32,
    atol 1e-5); the gradient of the autograd Function (its plain body in
    the kernel's place, as on the card the backward recomputes the plain
    version) against ``jax.grad`` of the same, atol 1e-4 of each largest
    entry."""
    rng = np.random.default_rng(Sq * 3 + prefix)
    q, k, v = _randn(rng, B, Sq, H, hd), _randn(rng, B, Sk, KV, hd), _randn(rng, B, Sk, KV, hd)
    go = _randn(rng, B, Sq, H, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset, prefix_len=prefix)
    want = np.asarray(jax_prefix_attention(q, k, v, **kw))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    for got in (tref.flash_attention_ref(tq, tk, tv, **kw), tops.flash_attention(tq, tk, tv, **kw)):
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=ATTN_ATOL)
    if not causal:
        np.testing.assert_array_equal(
            _np(tref.flash_attention_ref(tq, tk, tv, **dict(kw, prefix_len=0))), _np(got))
    jgrads = jax.grad(lambda q, k, v: jnp.sum(jax_prefix_attention(q, k, v, **kw) * go),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    out = tops.recompute_vjp("flash_attention", tref.flash_attention_ref,
                             tref.flash_attention_ref, (tq, tk, tv), **kw)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(go))
    for g, w in zip(grads, jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=GRAD_TOL * np.abs(w).max())


# (label, B, Sq, Sk, H, KV, hd, causal, window, q_offset, prefix): chip_smoke's
# paligemma prefill cut to one batch row and two query heads, and ragged
# prefixes against the 64-key tile at hd 256
PALIGEMMA_TC = [
    ("prefill cut: S768 H2 KV1 hd256 prefix 256",) + (1, 768, 768, 2, 1, 256, True, 0, 0, 256),
    ("prefix 100, hd 256", 1, 200, 200, 2, 1, 256, True, 0, 0, 100),
    ("prefix 64 + window 40, hd 256", 1, 160, 160, 2, 1, 256, True, 40, 0, 64),
]


@pytest.mark.parametrize("case", PALIGEMMA_TC, ids=[c[0] for c in PALIGEMMA_TC])
def test_flash_attention_tensor_core_numerics_at_paligemma_shapes(case):
    """The bf16 tensor-core ``flash_attention`` arithmetic (bf16 P, four
    64-column panels at hd 256, the prefix's tiles visited by every q
    tile) against the reference's prefix-LM attention in fp32 on the same
    bf16 values, under chip_smoke's bf16 tolerance.  chip_smoke's
    ``FA_PALIGEMMA`` is this shape at four batch rows and eight heads."""
    _, B, Sq, Sk, H, KV, hd, causal, window, q_offset, prefix = case
    if case is PALIGEMMA_TC[0]:
        assert CS.FA_PALIGEMMA[2:] == (Sq, Sk, 8, KV, hd, causal, window, q_offset, prefix)
    rng = np.random.default_rng(Sq + prefix)
    q, k, v = (torch.from_numpy(_randn(rng, *s)).bfloat16()
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, prefix_len=prefix)
    want = np.asarray(jax_prefix_attention(*(t.float().numpy() for t in (q, k, v)), **kw))
    got = tc_attention_emulated(q, k, v, **kw)
    atol, rtol = CS.TOL["bfloat16"]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("pos,kw", [(95, {}), (150, dict(ring=True, window=60))])
def test_flash_decode_at_g8_hd256_matches_jax(pos, kw):
    """Decode at paligemma's grouping (8 query heads on one kv head of
    256: G x hd = 2048, the most the kernel takes): ``ref.
    decode_attention_ref`` and the CPU wrapper against the JAX oracle and
    its Pallas kernel (interpret mode); the split-K emulation with the
    kernel's P V partitions at hd 256 (bf16: 4 subsets of 16 rows, fp32:
    2 of 32), every split count, against the same."""
    rng = np.random.default_rng(pos)
    B, KV, G, S, hd = 2, 1, 8, 100, 256
    q = _randn(rng, B, KV * G, hd)
    k, v = _randn(rng, B, KV, S, hd), _randn(rng, B, KV, S, hd)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(jref.decode_attention_ref(jq, jk, jv, jnp.int32(pos), **kw))
    np.testing.assert_allclose(
        np.asarray(jops.flash_decode(jq, jk, jv, jnp.int32(pos), **kw)), want,
        rtol=0, atol=ATTN_ATOL)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (tref.decode_attention_ref(tq, tk, tv, pos, **kw),
                tops.flash_decode(tq[:, None], tk, tv, pos, **kw)):
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=ATTN_ATOL)
    assert [len(rows) for rows in pv_partition(hd, 8)] == [16] * 4
    assert [len(rows) for rows in pv_partition(hd, 4)] == [32] * 2
    for vec in (8, 4):
        for n_split in (1, 2, 3):
            got = split_decode_emulated(tq, tk, tv, pos, n_split, vec=vec, **kw)
            np.testing.assert_allclose(_np(got), want, rtol=0, atol=ATTN_ATOL)


def test_kernel_paths_launch_with_prefix_and_hd256(monkeypatch):
    """The wrappers' kernel paths, driven on meta tensors with the launch
    captured: ``attend`` with a prefix on the kernel backend reaches
    ``flash_attention``'s launch with ``prefix_len`` and hd 256, every
    argument the C entry point takes; ``flash_decode`` at G 8, hd 256
    launches with G x hd = 2048, the kernel's limit."""
    calls = []
    monkeypatch.setattr(tops, "_check", lambda name, ts: None)
    monkeypatch.setattr(tops, "_sm_count", lambda index: 132)
    monkeypatch.setattr(tops, "_stream", lambda: 0)
    monkeypatch.setattr(tops, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(tops, "resolve_backend", lambda backend, t: "kernel")
    meta = dict(device="meta", dtype=torch.bfloat16)
    B, S, H, KV, hd, P = 4, 768, 8, 1, 256, 256
    q = torch.empty(B, S, H, hd, **meta)
    k, v = torch.empty(B, S, KV, hd, **meta), torch.empty(B, S, KV, hd, **meta)
    pos = torch.arange(S, dtype=torch.int32, device="meta")
    before = tops.flash_attention.launches
    out = TA.attend(q, k, v, q_pos=pos, k_pos=pos, prefix_len=P, backend="kernel")
    assert out.shape == (B, S, H, hd) and tops.flash_attention.launches == before + 1
    (name, *args), = calls
    assert name == "flash_attention"
    assert len(args) == len(tops.build.ENTRY_POINTS[name][1])
    assert args[4:] == [B, S, S, H, KV, hd, 1, 0, 0, P, tops.DTYPE_CODES[torch.bfloat16], 0]
    calls.clear()
    kc, vc = torch.empty(B, KV, 800, hd, **meta), torch.empty(B, KV, 800, hd, **meta)
    out = tops.flash_decode(torch.empty(B, 1, H, hd, **meta), kc, vc, 799)
    assert out.shape == (B, H, hd)
    (name, *args), = calls
    assert name == "flash_decode" and len(args) == len(tops.build.ENTRY_POINTS[name][1])
    assert args[6:11] == [B, KV, H // KV, 800, hd] and (H // KV) * hd == 2048


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["smoke-bf16", "smoke", "hd256", "full"])
def test_vlm_init_names_shapes_and_counts_match_jax(which):
    """Names, shapes and dtypes of every leaf equal ``jax.eval_shape`` of
    the JAX init (the bf16 smoke config; the fp32 configs; paligemma-3b
    at full size on meta tensors), and the count the config's:
    2,508,662,784 at full size.  The stub frontend has no weights: the
    tree is a dense model's."""
    from repro.configs import get_config as jget, get_smoke_config as jsmoke
    if which == "full":
        jcfg = jget("paligemma_3b")
        tcfg = TConfig(**dataclasses.asdict(jcfg))
        tparams = TM.init_params(tcfg, None, device=torch.device("meta"))
    else:
        jcfg = jsmoke("paligemma_3b") if which == "smoke-bf16" else _cfgs(which)[0]
        tcfg = TConfig(**dataclasses.asdict(jcfg))
        tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0), device=DEV)
        wq = tparams["blocks"]["attn"]["wq"].float()
        assert not torch.equal(wq[0], wq[1])             # layers differ
    assert _shapes(tparams) == _shapes(JM.abstract_params(jcfg))
    assert sorted(tparams) == ["blocks", "embed", "final_norm"]
    assert TM.param_count(tparams) == tcfg.param_count() == JM.param_count(
        JM.abstract_params(jcfg))
    if which == "full":
        assert tcfg.param_count() == PALIGEMMA_PARAMS
        assert tcfg.head_dim == 256 and tcfg.head_dim in tops.HEAD_DIMS
        assert tparams["blocks"]["attn"]["wk"].shape == (18, 2048, 256)


def test_vlm_jax_params_cross_the_bridge_whole():
    """JAX's paligemma ``init_params`` tree (bf16 smoke config) crosses
    ``bridge.params_from_numpy`` whole: every leaf, bit for bit, in its
    dtype, with the stacked layer dim and the ``x @ W`` layouts."""
    from repro.configs import get_smoke_config as jsmoke
    jcfg = jsmoke("paligemma_3b")
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(9)))
    tparams = bridge.params_from_numpy(tree, DEV)
    want, got = flatten(tree), flatten(tparams)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        if str(w.dtype) == "bfloat16":
            assert g.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16),
                                          err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
    assert tparams["blocks"]["attn"]["wq"].shape == (jcfg.num_layers, jcfg.d_model,
                                                     jcfg.num_heads * jcfg.head_dim)


@pytest.mark.parametrize("which", CONFIGS)
def test_vlm_loss_and_grads_match_jax(which):
    """Forward logits (text positions only: the prefix rows are dropped),
    ``loss_fn``'s total and ``ce_loss``, and the gradient of every leaf
    against JAX; remat on and off give the same loss and gradients; the
    image embeddings move the text logits."""
    jcfg, tcfg = _cfgs(which)
    jparams, tree = _weights(jcfg, seed=1)
    batch = _batch(jcfg, 2, 24, seed=2)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, _jb(batch), backend="einsum"), has_aux=True)(jparams)
    jlogits, _ = JM.forward(jparams, jcfg, _jb(batch), backend="einsum")
    params = TTS.train_state_from(bridge.params_from_numpy(tree, DEV), {}, 0).params
    tlogits, _ = TM.forward(params, tcfg, _tb(batch))
    assert tuple(tlogits.shape) == (2, 24, jcfg.vocab_size)
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), **LOGIT_TOL)
    other = dict(batch, image_embeds=batch["image_embeds"][::-1].copy())
    assert np.abs(_np(TM.forward(params, tcfg, _tb(other))[0]) - _np(tlogits)).max() > 1e-3
    leaves = list(flatten(params).values())
    tloss, tm = TM.loss_fn(params, tcfg, _tb(batch))
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["ce_loss"].detach()), float(jm["ce_loss"]),
                               rtol=LOSS_RTOL)
    _grads_close(dict(zip(flatten(params), grads)),
                 flatten(jax.tree.map(np.asarray, jgrads)))
    noloss, _ = TM.loss_fn(params, tcfg, _tb(batch), remat=False)
    nograds = torch.autograd.grad(noloss, leaves)
    torch.testing.assert_close(noloss.detach(), tloss.detach(), rtol=1e-6, atol=0)
    for a, b in zip(grads, nograds):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def _serve_both(jcfg, tcfg, jparams, tparams, backend, B=2, S=16, steps=4):
    """Prefill of P image + S text positions and ``steps`` greedy decode
    steps in both packages (JAX on ``backend``): logits, caches and tokens
    held together at each; decode positions start at P + S."""
    batch = _batch(jcfg, B, S, seed=6)
    P = jcfg.num_prefix_tokens
    cache_len = P + S + steps + 2
    jcache, jlog, jplen = JM.prefill(jparams, jcfg, _jb(batch), cache_len=cache_len,
                                     backend=backend)
    with torch.inference_mode():
        tcache, tlog, plen = TM.prefill(tparams, tcfg, _tb(batch), cache_len)
    assert plen == jplen == P + S
    np.testing.assert_allclose(_np(tlog), _np(jlog), **SERVE_TOL)

    def caches_close():
        for name in ("k", "v"):
            assert tuple(tcache[name].shape) == (jcfg.num_layers, B, jcfg.num_kv_heads,
                                                 cache_len, jcfg.head_dim)
            np.testing.assert_allclose(_np(tcache[name]), np.asarray(jcache[name]),
                                       **SERVE_TOL, err_msg=name)

    caches_close()
    tok = np.argmax(_np(jlog), -1).astype(np.int32)[:, None]
    for i in range(steps):
        jlog, jcache = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jcache,
                                      jnp.int32(plen + i), backend=backend)
        with torch.inference_mode():
            tlog, tcache = TM.decode_step(tparams, tcfg, torch.from_numpy(tok), tcache,
                                          plen + i)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **SERVE_TOL)
        tok = np.argmax(_np(jlog), -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(np.argmax(_np(tlog), -1)[:, None], tok)
    caches_close()


@pytest.mark.parametrize("which", CONFIGS)
def test_vlm_prefill_and_decode_match_jax(which):
    """Prefill logits and each layer's cache (P + S rows, the image rows
    first), then 4 greedy decode steps against JAX's einsum path: logits,
    tokens and the caches after them."""
    jcfg, tcfg = _cfgs(which)
    jparams, tree = _weights(jcfg, seed=5)
    _serve_both(jcfg, tcfg, jparams, bridge.params_from_numpy(tree, DEV), "einsum")


def test_vlm_serving_matches_jax_pallas_interpret():
    """The same against JAX's ``backend="pallas"`` path: its prefill sends
    the prefix to the jnp paths (its Pallas prefill kernel has no prefix),
    and its decode runs the Pallas ``flash_decode`` in interpret mode."""
    jcfg, tcfg = _cfgs("smoke")
    jparams, tree = _weights(jcfg, seed=7)
    _serve_both(jcfg, tcfg, jparams, bridge.params_from_numpy(tree, DEV), "pallas",
                steps=2)


def test_vlm_train_step_matches_jax():
    """One AdamW step from the same state on the same batch (tokens and
    image embeddings) against JAX's ``training/train_step.py``: the loss,
    the gradient norm, the learning rate, and every parameter after the
    update (within two learning rates: a gradient entry near 0 may take
    AdamW's first, sign-like step either way)."""
    jcfg, tcfg = _cfgs("smoke")
    jstate = JTS.make_train_state(jcfg, jax.random.PRNGKey(3))
    npstate = jax.tree.map(np.asarray, jstate)
    tstate = bridge.train_state_from_numpy(npstate.params, npstate.opt_state,
                                           npstate.step, DEV)
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    batch = _batch(jcfg, 2, 32, seed=4)
    jstate, jm = jax.jit(JTS.make_train_step(jcfg, opt, backend="einsum"))(jstate,
                                                                         _jb(batch))
    step = TTS.make_train_step(tcfg, tadamw.AdamWConfig(**dataclasses.asdict(opt)))
    tstate, tm = step(tstate, _tb(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert tstate.step == int(jstate.step) == 1
    got, want = flatten(tstate.params), flatten(jax.tree.map(np.asarray, jstate.params))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(_np(got[k]), want[k], rtol=0, atol=2 * opt.lr + 1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the kernel path
# ---------------------------------------------------------------------------

def test_vlm_kernel_launch_counts(monkeypatch):
    """Where the card launches, counted on the CPU (smoke: 2 layers).  A
    prefill launches 2 ``flash_attention``, each with the prefix P; each
    decode call 2 ``flash_decode`` and no ``flash_attention``; a
    ``loss_fn`` backward with remat launches 2 x 2 ``flash_attention``
    (the forward and the recompute), without remat 2.  The kernel path's
    loss, gradients, logits and caches equal the plain path's."""
    jcfg, tcfg = _cfgs("smoke")
    _, tree = _weights(jcfg, seed=8)
    counts = _count_kernel_calls(monkeypatch)
    counted = tops.flash_attention
    prefixes = []

    def flash_attention(q, k, v, **kw):
        prefixes.append(kw["prefix_len"])
        return counted(q, k, v, **kw)

    monkeypatch.setattr(tops, "flash_attention", flash_attention)
    params = TTS.train_state_from(bridge.params_from_numpy(tree, DEV), {}, 0).params
    leaves = list(flatten(params).values())
    tb = _tb(_batch(jcfg, 2, 24, seed=9))
    plain, _ = TM.loss_fn(params, tcfg, tb, backend="einsum")
    plain_grads = torch.autograd.grad(plain, leaves)
    assert not counts
    for remat, runs in ((True, 2), (False, 1)):
        counts.clear()
        loss, _ = TM.loss_fn(params, tcfg, tb, remat=remat, backend="kernel")
        grads = torch.autograd.grad(loss, leaves)
        assert counts == {"flash_attention": runs * 2}, (remat, counts)
        torch.testing.assert_close(loss.detach(), plain.detach(), rtol=1e-6, atol=0)
        for a, b in zip(grads, plain_grads):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert set(prefixes) == {jcfg.num_prefix_tokens}
    with torch.inference_mode():
        runs = {}
        for backend in ("einsum", "kernel"):
            counts.clear()
            cache, logits, plen = TM.prefill(params, tcfg, tb, 8 + 24 + 4, backend=backend)
            assert plen == 8 + 24
            assert counts == ({"flash_attention": 2} if backend == "kernel" else {})
            out = [logits]
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            for i in range(3):
                counts.clear()
                logits, cache = TM.decode_step(params, tcfg, tok, cache, plen + i,
                                               backend=backend)
                out.append(logits)
                assert counts == ({"flash_decode": 2} if backend == "kernel" else {})
            runs[backend] = (out, cache)
    for a, b in zip(runs["kernel"][0], runs["einsum"][0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(flatten(runs["kernel"][1]).values(), flatten(runs["einsum"][1]).values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the launchers and the profiler
# ---------------------------------------------------------------------------

def test_vlm_serve_launcher_cpu_counts_the_prefix(tmp_path, monkeypatch):
    """The serve launcher serves paligemma's smoke config at prompt 16, 4
    tokens, where the JAX launcher's cache (max(plan, prompt + gen) = 20
    slots for 8 + 16 + 4 positions) makes its prefill raise: the port's
    linear cache holds P + prompt + gen = 28 slots, and its tokens are
    those of prefill + greedy decode from the same weights and images."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import serve

    B, S, gen = 2, 16, 4
    tcfg = get_smoke_config("paligemma_3b")
    P = tcfg.num_prefix_tokens
    jcfg, _ = _cfgs("smoke")
    jparams, _ = _weights(jcfg)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        JM.prefill(jparams, jcfg, _jb(_batch(jcfg, B, S, seed=0)), cache_len=S + gen)
    sizes = []
    prefill = TM.prefill
    monkeypatch.setattr(TM, "prefill", lambda *a, **kw: sizes.append(kw["cache_len"])
                        or prefill(*a, **kw))
    res = serve.main(["--arch", "paligemma_3b", "--smoke", "--device", "cpu",
                      "--batch", str(B), "--prompt-len", str(S), "--gen", str(gen),
                      "--run-dir", str(tmp_path)])
    assert sizes == [P + S + gen]
    assert res["num_layers"] == tcfg.num_layers and res["decode_calls"] == gen
    with torch.inference_mode():
        params = TM.init_params(tcfg, torch.Generator().manual_seed(0), device=DEV)
        src = SyntheticTokens(tcfg, DataConfig(batch_size=B, seq_len=S))
        batch = {k: torch.from_numpy(v) for k, v in src.next_batch().items()}
        assert tuple(batch["image_embeds"].shape) == (B, P, tcfg.d_model)
        cache, logits, plen = prefill(params, tcfg, batch, P + S + gen)
        assert plen == P + S
        toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
        for i in range(gen - 1):
            logits, cache = TM.decode_step(params, tcfg, toks[-1], cache, plen + i)
            toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    torch.testing.assert_close(res["tokens"], torch.cat(toks, dim=1), rtol=0, atol=0)


def test_vlm_train_launcher_cpu_loss_falls(tmp_path):
    """The train launcher trains paligemma's smoke config on the
    synthetic stream (tokens and image embeddings): finite losses that
    fall."""
    from repro_torch.launch import train
    res = train.main(["--arch", "paligemma_3b", "--smoke", "--device", "cpu",
                      "--batch", "4", "--seq", "32", "--log-every", "4", "--steps", "12",
                      "--run-dir", str(tmp_path)])
    losses = res["losses"]
    assert res["num_layers"] == 2 and len(losses) == 12
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0] - 0.3


def test_vlm_pipeline_refused_with_the_reference_fault(tmp_path):
    """The pipeline launcher refuses vlm, naming the reference's fault
    (its pipeline embeds the tokens alone and drops the image prefix)."""
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="vlm.*image prefix.*ROADMAP C"):
        train.main(["--arch", "paligemma_3b", "--smoke", "--device", "cpu",
                    "--pipeline-parallel", "2", "--p2p", "host", "--steps", "1",
                    "--run-dir", str(tmp_path)])


def test_vlm_profiler_cpu():
    """``measure_layer_profile`` on paligemma's bf16 smoke config at hd
    256 on the CPU returns every field, finite and positive, on the plain path (a
    dense block without a prefix, as the reference's; the decode step a
    whole vlm decode step)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import profiler

    tcfg = dataclasses.replace(get_smoke_config("paligemma_3b"), head_dim=256,
                               num_heads=2, num_kv_heads=1)
    meas = profiler.measure_layer_profile(tcfg, 64, iters=1, device="cpu")
    assert meas.pop("backend") == "einsum"
    assert sorted(meas) == sorted(["t_fwd", "t_bwd", "t_recomp", "t_dgrad", "t_wgrad",
                                   "wgrad_frac", "t_attn", "t_rmsnorm", "t_decode"])
    assert all(np.isfinite(v) and v >= 0 for v in meas.values()), meas
    assert all(meas[k] > 0 for k in ("t_fwd", "t_bwd", "t_dgrad", "t_attn", "t_decode"))
