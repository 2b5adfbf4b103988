"""The port's audio family (whisper: a non-causal encoder stack and a
decoder of ``dec_cross`` blocks, self-attention then cross-attention
then MLP, no RoPE anywhere) held against the JAX package on the CPU.

Two fp32 configs (``conftest.exact_cfg``): whisper's smoke config (2 + 2
layers, 32 encoder frames) and a variant with 3 decoder layers over 1
encoder layer, 100 encoder frames (no multiple of the kernels' 64-key
tile), q/k/v biases and one kv head (GQA 2) in both attentions.
Weights come from the JAX ``init_params`` (biases and norm scales
perturbed) and cross with ``repro_torch.bridge``; tokens and frames are
numpy-seeded.

Tolerances, as ``tests/test_torch_hybrid.py`` and
``tests/test_torch_moe.py`` hold the other families: logits atol/rtol
1e-4, losses rtol 2e-5 (the same fp32 sums in another order), gradients
atol 1e-4 of each leaf's largest value, served logits and caches
atol/rtol 2e-4 with greedy tokens exact.  The bf16 tensor-core
``flash_attention`` arithmetic at whisper's shapes is rehearsed under
chip_smoke's bf16 tolerance, as ``tests/test_torch_kernels.py`` does at
its cases.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import exact_cfg
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.training import train_step as JTS
from repro_torch import bridge
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.training import train_step as TTS
from repro_torch.tree import flatten
from test_torch_hybrid import _count_kernel_calls
from test_torch_kernels import CS, tc_attention_emulated

DEV = torch.device("cpu")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_RTOL = 2e-5
GRAD_TOL = 1e-4
CONFIGS = ["smoke", "var"]
WHISPER_BASE_PARAMS = 97_950_720


@pytest.fixture(autouse=True)
def _two_threads():
    """Two cores, not all: tier-1 runs test files in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfgs(which):
    jcfg = exact_cfg("whisper_base")
    if which == "var":
        jcfg = dataclasses.replace(jcfg, num_layers=3, num_encoder_layers=1,
                                   encoder_seq_len=100, qkv_bias=True, num_kv_heads=1)
    assert jcfg.family == "audio" and jcfg.dtype == "float32"
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _weights(jcfg, seed=0):
    """JAX init as numpy, with every bias and norm scale perturbed."""
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("bq", "bk", "bv", "bias", "scale"):
                t[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    perturb(tree)
    return jax.tree.map(jnp.asarray, tree), tree


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "audio_embeds": rng.standard_normal(
                (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)}


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
    """Each leaf's gradient within GRAD_TOL of its largest entry.  A key
    bias (``bk``) adds the same q . bk to every score of a row, which the
    softmax cancels: without RoPE its gradient is zero, and both packages
    give rounding noise there, held below GRAD_TOL of the largest entry
    of the same attention's ``wk`` gradient."""
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = want[name].astype(np.float32)
        if name.endswith("/bk"):
            floor = GRAD_TOL * np.abs(want[name[:-2] + "wk"]).max()
            assert np.abs(w).max() <= floor and np.abs(_np(g)).max() <= floor, name
            continue
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# cross-attention and the dec_cross block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", CONFIGS)
@pytest.mark.parametrize("Sq,Se", [(1, 100), (1, 1500), (24, 100), (7, 64)])
def test_cross_attention_and_encode_kv_match_jax(which, Sq, Se):
    """``encode_cross_kv``'s K/V (B, Se, KV, hd) and ``cross_attention``'s
    output, decode's Sq = 1 included, at encoder lengths that are and are
    not multiples of 64."""
    jcfg, tcfg = _cfgs(which)
    jcfg = dataclasses.replace(jcfg, encoder_seq_len=Se)
    tcfg = dataclasses.replace(tcfg, encoder_seq_len=Se)
    _, tree = _weights(jcfg, seed=Sq + Se)
    p = jax.tree.map(lambda t: t[0], tree["dec_blocks"]["xattn"])
    rng = np.random.default_rng(Se)
    x = rng.standard_normal((2, Sq, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, Se, jcfg.d_model)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, p), bridge.params_from_numpy(p, DEV)
    jkv = JA.encode_cross_kv(jp, jcfg, jnp.asarray(enc))
    tkv = TA.encode_cross_kv(tp, tcfg, torch.from_numpy(enc))
    for got, want in zip(tkv, jkv):
        assert tuple(got.shape) == (2, Se, jcfg.num_kv_heads, jcfg.head_dim)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
    want = JA.cross_attention(jp, jcfg, jnp.asarray(x), jkv, backend="einsum")
    got = TA.cross_attention(tp, tcfg, torch.from_numpy(x), tkv)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)


def _block_inputs(jcfg, seed):
    _, tree = _weights(jcfg, seed=seed)
    p = jax.tree.map(lambda t: t[0], tree["dec_blocks"])
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)
    return p, x, enc


@pytest.mark.parametrize("which", CONFIGS)
def test_dec_cross_block_forward_matches_jax_without_rope(which, monkeypatch):
    """The ``dec_cross`` block's forward against ``repro.models.transformer
    .block_forward``; neither output moves when the positions are
    stretched (RoPE is off for audio: ``rope = cfg.family != "audio"``),
    where the same block under a dense-family config, RoPE on, moves; and
    the port's block calls ``apply_rope`` zero times."""
    jcfg, tcfg = _cfgs(which)
    p, x, enc = _block_inputs(jcfg, seed=3)
    jp, tp = jax.tree.map(jnp.asarray, p), bridge.params_from_numpy(p, DEV)
    assert sorted(tp) == ["attn", "ln1", "ln2", "ln3", "mlp", "xattn"]
    jkv = JA.encode_cross_kv(jp["xattn"], jcfg, jnp.asarray(enc))
    tkv = TA.encode_cross_kv(tp["xattn"], tcfg, torch.from_numpy(enc))
    S = x.shape[1]
    pos = np.arange(S, dtype=np.int32)
    stretched = 3 * pos + 5

    def jrun(cfg, positions):
        return np.asarray(JT.block_forward(jp, cfg, jnp.asarray(x), "dec_cross",
                                           positions=jnp.asarray(positions), enc_kv=jkv,
                                           backend="einsum")[0])

    def trun(cfg, positions):
        return _np(TT.block_forward(tp, cfg, torch.from_numpy(x), "dec_cross",
                                    positions=torch.from_numpy(positions), enc_kv=tkv)[0])

    ropes = []
    apply_rope = TL.apply_rope
    monkeypatch.setattr(TL, "apply_rope", lambda *a: ropes.append(1) or apply_rope(*a))
    want = jrun(jcfg, pos)
    got = trun(tcfg, pos)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    np.testing.assert_array_equal(jrun(jcfg, stretched), want)
    np.testing.assert_array_equal(trun(tcfg, stretched), got)
    assert not ropes
    dense_j = dataclasses.replace(jcfg, family="dense", is_encoder_decoder=False)
    dense_t = dataclasses.replace(tcfg, family="dense", is_encoder_decoder=False)
    assert np.abs(jrun(dense_j, stretched) - jrun(dense_j, pos)).max() > 1e-3
    assert np.abs(trun(dense_t, stretched) - trun(dense_t, pos)).max() > 1e-3
    assert ropes


@pytest.mark.parametrize("which", CONFIGS)
def test_dec_cross_block_decode_matches_jax(which):
    """One token through the ``dec_cross`` block against a filled cache:
    the output and the cache against ``block_decode``'s, and the slot it
    writes holds the un-roped K projection of ``ln1(x)``."""
    jcfg, tcfg = _cfgs(which)
    p, x, enc = _block_inputs(jcfg, seed=4)
    jp, tp = jax.tree.map(jnp.asarray, p), bridge.params_from_numpy(p, DEV)
    rng = np.random.default_rng(5)
    B, KV, hd, S_cache, pos = 2, jcfg.num_kv_heads, jcfg.head_dim, 24, 17
    cache = {k: rng.standard_normal((B, KV, S_cache, hd)).astype(np.float32)
             for k in ("k", "v")}
    x1 = x[:, :1]
    jkv = JA.encode_cross_kv(jp["xattn"], jcfg, jnp.asarray(enc))
    tkv = TA.encode_cross_kv(tp["xattn"], tcfg, torch.from_numpy(enc))
    want, jcache = JT.block_decode(jp, jcfg, jnp.asarray(x1),
                                   {k: jnp.asarray(v) for k, v in cache.items()},
                                   jnp.int32(pos), "dec_cross", enc_kv=jkv,
                                   backend="einsum")
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, tcache = TT.block_decode(tp, tcfg, torch.from_numpy(x1), tcache, pos,
                                  "dec_cross", enc_kv=tkv)
    np.testing.assert_allclose(_np(got), np.asarray(want), **SERVE_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[k]), np.asarray(jcache[k]), **SERVE_TOL)
    h = TL.apply_norm(tp["ln1"], torch.from_numpy(x1), tcfg.norm)
    k_new = h @ tp["attn"]["wk"] + (tp["attn"]["bk"] if tcfg.qkv_bias else 0)
    np.testing.assert_allclose(_np(tcache["k"][:, :, pos]),
                               _np(k_new.reshape(B, KV, hd)), rtol=1e-6, atol=1e-6)


def test_sinusoidal_matches_jax():
    """``_sinusoidal`` over whisper's 448 decoder positions at d 512 and
    the smoke width.  The two packages' fp32 ``exp`` give some of the
    frequencies one ulp apart (at most 6e-8), which moves the angle at
    position p by up to p x 6e-8: 2.7e-5 at 447, the tolerance's origin."""
    pos = np.arange(448, dtype=np.int32)
    for d in (512, 256):
        want = np.asarray(JM._sinusoidal(jnp.asarray(pos), d))
        got = TM._sinusoidal(torch.from_numpy(pos), d)
        assert got.dtype == torch.float32 and tuple(got.shape) == (len(pos), d)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=3e-5)
        np.testing.assert_array_equal(_np(got)[0], np.repeat([0.0, 1.0], d // 2))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["smoke-bf16", "var", "full"])
def test_audio_init_names_shapes_and_counts_match_jax(which):
    """Names, shapes and dtypes of every leaf equal ``jax.eval_shape`` of
    the JAX init (the bf16 smoke config; the variant; whisper-base at
    full size on meta tensors), and the count the config's:
    97,950,720 at full size."""
    from repro.configs import get_config as jget, get_smoke_config as jsmoke
    if which == "full":
        jcfg = jget("whisper_base")
        tcfg = TConfig(**dataclasses.asdict(jcfg))
        tparams = TM.init_params(tcfg, None, device=torch.device("meta"))
    else:
        jcfg = jsmoke("whisper_base") if which == "smoke-bf16" else _cfgs(which)[0]
        tcfg = TConfig(**dataclasses.asdict(jcfg))
        tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0), device=DEV)
        wq = tparams["dec_blocks"]["xattn"]["wq"].float()
        assert not torch.equal(wq[0], wq[1])             # layers differ
    assert _shapes(tparams) == _shapes(JM.abstract_params(jcfg))
    assert sorted(tparams) == ["dec_blocks", "embed", "enc_blocks", "enc_final_norm",
                               "enc_pos", "final_norm"]
    assert TM.param_count(tparams) == tcfg.param_count() == JM.param_count(
        JM.abstract_params(jcfg))
    if which == "full":
        assert tcfg.param_count() == WHISPER_BASE_PARAMS
        assert tcfg.head_dim == 64 and tparams["enc_pos"].shape == (1500, 512)


def test_audio_jax_params_cross_the_bridge_whole():
    """JAX's whisper ``init_params`` tree (bf16 smoke config) crosses
    ``bridge.params_from_numpy`` whole: every leaf, bit for bit, in its
    dtype, and the count the config's."""
    from repro.configs import get_smoke_config as jsmoke
    jcfg = jsmoke("whisper_base")
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(9)))
    tparams = bridge.params_from_numpy(tree, DEV)
    want, got = flatten(tree), flatten(tparams)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if str(w.dtype) == "bfloat16":
            assert g.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16),
                                          err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
    assert TM.param_count(tparams) == TConfig(**dataclasses.asdict(jcfg)).param_count()


@pytest.mark.parametrize("which", CONFIGS)
def test_audio_loss_and_grads_match_jax(which):
    """Forward logits, ``loss_fn``'s total and ``ce_loss``, and the gradient
    of every leaf (encoder, decoder, ``enc_pos``, the norms) against JAX;
    remat on (one checkpoint a layer, the cross K/V projected inside it)
    and off give the same loss and gradients."""
    jcfg, tcfg = _cfgs(which)
    jparams, tree = _weights(jcfg, seed=1)
    batch = _batch(jcfg, 2, 40, seed=2)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, _jb(batch), backend="einsum"), has_aux=True)(jparams)
    jlogits, _ = JM.forward(jparams, jcfg, _jb(batch), backend="einsum")
    params = TTS.train_state_from(bridge.params_from_numpy(tree, DEV), {}, 0).params
    tlogits, _ = TM.forward(params, tcfg, _tb(batch))
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), **LOGIT_TOL)
    leaves = list(flatten(params).values())
    tloss, tm = TM.loss_fn(params, tcfg, _tb(batch))
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["ce_loss"].detach()), float(jm["ce_loss"]),
                               rtol=LOSS_RTOL)
    assert float(tm["aux_loss"]) == 0.0
    _grads_close(dict(zip(flatten(params), grads)),
                 flatten(jax.tree.map(np.asarray, jgrads)))
    noloss, _ = TM.loss_fn(params, tcfg, _tb(batch), remat=False)
    nograds = torch.autograd.grad(noloss, leaves)
    torch.testing.assert_close(noloss.detach(), tloss.detach(), rtol=1e-6, atol=0)
    for a, b in zip(grads, nograds):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def _caches_close(tcache, jcache):
    got = flatten({"self": tcache["self"], "cross": dict(zip("kv", tcache["cross"]))})
    want = flatten({"self": jax.tree.map(np.asarray, jcache["self"]),
                    "cross": dict(zip("kv", map(np.asarray, jcache["cross"])))})
    assert list(got) == list(want) == ["cross/k", "cross/v", "self/k", "self/v"]
    for name in got:
        assert tuple(got[name].shape) == want[name].shape, name
        np.testing.assert_allclose(_np(got[name]), want[name], **SERVE_TOL, err_msg=name)


def _serve_both(jcfg, tcfg, jparams, tparams, backend, B=2, S=20, steps=4):
    """Prefill and ``steps`` greedy decode steps in both packages (JAX on
    ``backend``), logits, caches and tokens held together at each."""
    batch = _batch(jcfg, B, S, seed=6)
    cache_len = S + steps + 2
    jcache, jlog, jplen = JM.prefill(jparams, jcfg, _jb(batch), cache_len=cache_len,
                                     backend=backend)
    with torch.inference_mode():
        tcache, tlog, plen = TM.prefill(tparams, tcfg, _tb(batch), cache_len)
    assert plen == jplen == S
    assert tuple(tcache["cross"][0].shape) == (jcfg.num_layers, B, jcfg.encoder_seq_len,
                                               jcfg.num_kv_heads, jcfg.head_dim)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **SERVE_TOL)
    _caches_close(tcache, jcache)
    cross = [t.clone() for t in tcache["cross"]]
    tok = np.argmax(_np(jlog), -1).astype(np.int32)[:, None]
    for i in range(steps):
        jlog, jcache = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jcache,
                                      jnp.int32(S + i), backend=backend)
        with torch.inference_mode():
            tlog, tcache = TM.decode_step(tparams, tcfg, torch.from_numpy(tok), tcache,
                                          S + i)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **SERVE_TOL)
        tok = np.argmax(_np(jlog), -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(np.argmax(_np(tlog), -1)[:, None], tok)
    _caches_close(tcache, jcache)
    for a, b in zip(cross, tcache["cross"]):          # decode reads it only
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", CONFIGS)
def test_audio_prefill_and_decode_match_jax(which):
    """Prefill logits and both caches (each decoder layer's un-roped self
    K/V and its cross K/V), then 4 greedy decode steps against JAX's
    einsum path: logits, tokens and the caches after them."""
    jcfg, tcfg = _cfgs(which)
    jparams, tree = _weights(jcfg, seed=5)
    _serve_both(jcfg, tcfg, jparams, bridge.params_from_numpy(tree, DEV), "einsum")


def test_audio_serving_matches_jax_pallas_interpret():
    """The same against JAX's ``backend="pallas"`` path, whose kernels run
    in interpret mode on the CPU: the prefill and cross-attention through
    ``flash_attention`` (decode's at Sq = 1), self-attention decode
    through ``flash_decode``."""
    jcfg, tcfg = _cfgs("smoke")
    jparams, tree = _weights(jcfg, seed=7)
    _serve_both(jcfg, tcfg, jparams, bridge.params_from_numpy(tree, DEV), "pallas",
                steps=2)


def test_audio_train_step_matches_jax():
    """One AdamW step from the same state on the same batch against JAX's
    ``training/train_step.py``: the loss, the gradient norm, the
    learning rate, and every parameter after the update (within two
    learning rates: a gradient entry near 0 may take AdamW's first,
    sign-like step either way)."""
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

def test_audio_kernel_launch_counts(monkeypatch):
    """Where the card launches, counted on the CPU (smoke: 2 encoder + 2
    decoder layers).  A prefill launches 3 x 2 ``flash_attention``
    (encoder, decoder self, cross); each decode call 2 ``flash_decode``
    (self) and 2 ``flash_attention`` (cross, Sq = 1).  A ``loss_fn``
    backward with remat launches 2 x 6 ``flash_attention`` (the forward
    and the recompute), without remat 6.  The kernel path's loss,
    gradients, logits and caches equal the plain path's."""
    jcfg, tcfg = _cfgs("smoke")
    _, tree = _weights(jcfg, seed=8)
    counts = _count_kernel_calls(monkeypatch)
    params = TTS.train_state_from(bridge.params_from_numpy(tree, DEV), {}, 0).params
    leaves = list(flatten(params).values())
    tb = _tb(_batch(jcfg, 2, 40, seed=9))
    plain, _ = TM.loss_fn(params, tcfg, tb, backend="einsum")
    plain_grads = torch.autograd.grad(plain, leaves)
    assert not counts
    for remat, runs in ((True, 2), (False, 1)):
        counts.clear()
        loss, _ = TM.loss_fn(params, tcfg, tb, remat=remat, backend="kernel")
        grads = torch.autograd.grad(loss, leaves)
        assert counts == {"flash_attention": runs * 6}, (remat, counts)
        torch.testing.assert_close(loss.detach(), plain.detach(), rtol=1e-6, atol=0)
        for a, b in zip(grads, plain_grads):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    with torch.inference_mode():
        runs = {}
        for backend in ("einsum", "kernel"):
            counts.clear()
            cache, logits, plen = TM.prefill(params, tcfg, tb, 46, backend=backend)
            assert counts == ({"flash_attention": 6} if backend == "kernel" else {})
            out = [logits]
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            for i in range(3):
                counts.clear()
                logits, cache = TM.decode_step(params, tcfg, tok, cache, plen + i,
                                               backend=backend)
                out.append(logits)
                assert counts == ({"flash_decode": 2, "flash_attention": 2}
                                  if backend == "kernel" else {})
            runs[backend] = (out, cache)
    for a, b in zip(runs["kernel"][0], runs["einsum"][0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(flatten(runs["kernel"][1]["self"]).values(),
                    flatten(runs["einsum"][1]["self"]).values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# (B, Sq, Sk, H, KV, hd, causal, q_offset): whisper's attention calls at
# one batch row and two heads, with the q_offset ``attend`` passes
WHISPER_SHAPES = [
    (1, 1, 1500, 2, 2, 64, False, 1499),        # decode cross-attention
    (1, 130, 1500, 2, 2, 64, False, 1370),      # prefill cross-attention
    (1, 1500, 1500, 2, 2, 64, False, 0),        # the encoder
    (1, 200, 200, 2, 2, 64, True, 0),           # decoder self-attention
]


@pytest.mark.parametrize("case", WHISPER_SHAPES, ids=["decode-cross", "cross",
                                                      "encoder", "self"])
def test_flash_attention_tensor_core_numerics_at_whisper_shapes(case):
    """The bf16 tensor-core ``flash_attention`` arithmetic (bf16 P, the
    ragged last K tile of 1500 = 23 x 64 + 28 masked to -inf, q_offset
    ignored without a causal mask) against the JAX ``attention_ref``
    under chip_smoke's bf16 tolerance; the plain version the card checks
    it against (the CPU wrapper) against the same in fp32."""
    B, Sq, Sk, H, KV, hd, causal, q_offset = case
    rng = np.random.default_rng(Sq + Sk)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    kw = dict(causal=causal, window=0, q_offset=q_offset)
    tq, tk, tv = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (tq, tk, tv))
    want = np.asarray(jref.attention_ref(jq, jk, jv, **kw).astype(jnp.float32))
    got = tc_attention_emulated(tq, tk, tv, **kw)
    atol, rtol = CS.TOL["bfloat16"]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)
    from repro_torch.kernels import ops as tops
    want32 = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           **kw))
    got32 = tops.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(_np(got32), want32, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the launchers and the profiler
# ---------------------------------------------------------------------------

def test_audio_serve_launcher_cpu(tmp_path):
    """The serve launcher takes whisper's smoke config: its tokens are
    those of prefill + greedy decode from the same weights and frames (the
    warm-up decode writes slot ``plen`` in place and leaves the cross
    cache alone)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import serve

    B, P, gen = 2, 32, 5
    res = serve.main(["--arch", "whisper_base", "--smoke", "--device", "cpu",
                      "--batch", str(B), "--prompt-len", str(P), "--gen", str(gen),
                      "--run-dir", str(tmp_path)])
    tcfg = get_smoke_config("whisper_base")
    assert res["num_layers"] == tcfg.num_layers and res["decode_calls"] == gen
    with torch.inference_mode():
        params = TM.init_params(tcfg, torch.Generator().manual_seed(0), device=DEV)
        src = SyntheticTokens(tcfg, DataConfig(batch_size=B, seq_len=P))
        batch = {k: torch.from_numpy(v) for k, v in src.next_batch().items()}
        assert tuple(batch["audio_embeds"].shape) == (B, tcfg.encoder_seq_len,
                                                      tcfg.d_model)
        cache, logits, plen = TM.prefill(params, tcfg, batch, P + gen)
        toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
        for i in range(gen - 1):
            logits, cache = TM.decode_step(params, tcfg, toks[-1], cache, plen + i)
            toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    torch.testing.assert_close(res["tokens"], torch.cat(toks, dim=1), rtol=0, atol=0)


def test_audio_train_launcher_cpu_loss_falls(tmp_path):
    """The train launcher trains whisper's smoke config on the synthetic
    stream (tokens and frames): finite losses that fall; the checkpoint it
    writes (``--ckpt-dir``) loads back bit for bit."""
    import math

    from repro_torch.checkpointing import io as tio
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train
    ckpt = str(tmp_path / "ckpt")
    res = train.main(["--arch", "whisper_base", "--smoke", "--device", "cpu",
                      "--batch", "4", "--seq", "32", "--log-every", "4", "--steps", "12",
                      "--run-dir", str(tmp_path / "run"), "--ckpt-dir", ckpt])
    losses = res["losses"]
    assert res["num_layers"] == 2 and len(losses) == 12
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0] - 0.3
    assert tio.checkpoint_step(ckpt) == 12
    fresh = TTS.make_train_state(get_smoke_config("whisper_base"),
                                 torch.Generator().manual_seed(1), device=DEV)
    back = tio.load_checkpoint(ckpt, fresh)
    for (k, a), b in zip(flatten(back.params).items(), flatten(res["state"].params).values()):
        assert torch.equal(a.detach(), b.detach()), k


def test_audio_pipeline_refused_with_the_reference_fault(tmp_path):
    """The pipeline launcher refuses audio, naming the reference's fault
    (its pipeline has no audio path) rather than the port."""
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="audio.*ROADMAP C"):
        train.main(["--arch", "whisper_base", "--smoke", "--device", "cpu",
                    "--pipeline-parallel", "2", "--p2p", "host", "--steps", "1",
                    "--run-dir", str(tmp_path)])


def test_audio_profiler_cpu(monkeypatch):
    """``measure_layer_profile`` on whisper's smoke config on the CPU
    returns every field, finite and positive, on the plain path; its
    dense block (and the whisper decode step) applies no RoPE."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import profiler

    ropes = []
    apply_rope = TL.apply_rope
    monkeypatch.setattr(TL, "apply_rope", lambda *a: ropes.append(1) or apply_rope(*a))
    meas = profiler.measure_layer_profile(get_smoke_config("whisper_base"), 64, iters=1,
                                          device="cpu")
    assert meas.pop("backend") == "einsum"
    assert sorted(meas) == sorted(["t_fwd", "t_bwd", "t_recomp", "t_dgrad", "t_wgrad",
                                   "wgrad_frac", "t_attn", "t_rmsnorm", "t_decode"])
    assert all(np.isfinite(v) and v >= 0 for v in meas.values()), meas
    assert all(meas[k] > 0 for k in ("t_fwd", "t_bwd", "t_dgrad", "t_attn", "t_decode"))
    assert not ropes
