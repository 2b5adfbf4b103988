"""The port's hybrid family (zamba2: groups of Mamba2 layers, each group
followed by one weight-shared attention + MLP block) held against
``repro.models.model`` on the CPU.

Two fp32 configs (``conftest.exact_cfg``): the zamba2 smoke config (2
groups of 1 ssm layer) and a variant of 4 layers in 2 groups of 2, so
that a group's own layer loop runs.  Sequences stay within the smoke
``max_seq_len`` (512), where the JAX forward and prefill agree on the
shared block's window.  Weights come from the JAX ``init_params`` (with
biases, norm scales, ``conv_b``, ``D`` and ``dt_bias`` perturbed) and
cross with ``repro_torch.bridge``; tokens are numpy-seeded.

Tolerances, as ``tests/test_torch_train.py`` and
``tests/test_torch_ssm.py`` hold the other families: logits atol/rtol
1e-4 and losses rtol 2e-5 (the same fp32 sums in another order);
gradients atol 1e-4 of each leaf's largest value (they sum over every
token, and the SSD backward differentiates the chunked form where JAX
differentiates the sequential one); served logits and caches atol/rtol
2e-4, greedy tokens exact.  AdamW steps of the smoke config run in
``tests/test_torch_train.py::test_train_steps_match_jax_fp32``.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import exact_cfg
from repro.models import model as JM
from repro.training import train_step as JTS
from repro_torch import bridge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.training import train_step as TTS
from repro_torch.tree import flatten

DEV = torch.device("cpu")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 2e-5
GRAD_TOL = 1e-4
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)
CONFIGS = ["smoke", "per2"]


@pytest.fixture(autouse=True)
def _two_threads():
    """Two cores, not all: tier-1 runs test files in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfgs(which):
    jcfg = exact_cfg("zamba2_2p7b")
    if which == "per2":
        jcfg = dataclasses.replace(jcfg, num_layers=4, hybrid_attn_every=2)
    assert jcfg.family == "hybrid"
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _weights(jcfg, seed=0):
    """JAX init as numpy, with every bias, norm scale, conv_b, D and
    dt_bias perturbed so they are not the trivial zeros/ones."""
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("bq", "bk", "bv", "bias", "scale", "conv_b", "D", "dt_bias"):
                t[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    perturb(tree)
    return jax.tree.map(jnp.asarray, tree), tree


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _np(x):
    return x.detach().float().numpy().copy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _shapes(tree):
    """{path: (shape, dtype name)} of a JAX abstract tree or a port tree."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: v for k, sub in tree.items()
                for p, v in _shapes(sub).items()}
    return {"": (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("which", CONFIGS + ["full"])
def test_hybrid_init_names_shapes_and_counts_match_jax(which):
    """Names, shapes and dtypes of every leaf equal ``jax.eval_shape`` of
    the JAX init (the full zamba2-2.7b built on meta tensors), the ssm
    blocks stacked (G, per) and ``shared_attn`` unstacked, and the count
    equal to ``cfg.param_count()``."""
    if which == "full":
        from repro.configs import get_config as jget
        jcfg = jget("zamba2_2p7b")
        tcfg = TConfig(**dataclasses.asdict(jcfg))
        tparams = TM.init_params(tcfg, None, device=torch.device("meta"))
    else:
        jcfg, tcfg = _cfgs(which)
        tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0), device=DEV)
    want = _shapes(JM.abstract_params(jcfg))
    assert _shapes(tparams) == want
    G, per = tcfg.num_layers // tcfg.hybrid_attn_every, tcfg.hybrid_attn_every
    assert tparams["blocks"]["ssm"]["in_proj"].shape[:2] == (G, per)
    assert tparams["shared_attn"]["attn"]["wq"].shape == \
        (tcfg.d_model, tcfg.num_heads * tcfg.head_dim)
    assert TM.param_count(tparams) == tcfg.param_count() == JM.param_count(
        JM.abstract_params(jcfg))
    if which == "full":
        assert tcfg.head_dim == 80 and tcfg.head_dim in tops.HEAD_DIMS


@pytest.mark.parametrize("which", CONFIGS)
def test_hybrid_loss_and_grads_match_jax(which):
    """Forward logits, the loss and every gradient (the ssm stack's and the
    shared block's, which sums over the groups) against JAX; remat on
    (one checkpoint a group) and off give the same loss and gradients."""
    jcfg, tcfg = _cfgs(which)
    jparams, tree = _weights(jcfg, seed=1)
    batch = _tokens(jcfg, 2, 64, seed=2)
    jb = {"tokens": jnp.asarray(batch)}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jb, backend="einsum"), has_aux=True)(jparams)
    jlogits, _ = JM.forward(jparams, jcfg, jb, backend="einsum")
    params = TTS.train_state_from(bridge.params_from_numpy(tree, DEV), {}, 0).params
    tb = {"tokens": torch.from_numpy(batch)}
    tlogits, _ = TM.forward(params, tcfg, tb)
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), **LOGIT_TOL)
    leaves = list(flatten(params).values())
    tloss, tm = TM.loss_fn(params, tcfg, tb)
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["ce_loss"].detach()), float(jm["ce_loss"]),
                               rtol=LOSS_RTOL)
    want = flatten(jax.tree.map(np.asarray, jgrads))
    assert list(flatten(params)) == list(want)
    for name, g in zip(flatten(params), grads):
        w = want[name].astype(np.float32)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)
    noloss, _ = TM.loss_fn(params, tcfg, tb, remat=False)
    nograds = torch.autograd.grad(noloss, leaves)
    torch.testing.assert_close(noloss.detach(), tloss.detach(), rtol=1e-6, atol=0)
    for a, b in zip(grads, nograds):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("which", CONFIGS)
def test_hybrid_prefill_and_decode_match_jax(which):
    """Prefill logits and both caches (each layer's conv tail and ssm
    state, each group's K/V of the shared block), then 4 greedy decode
    steps: logits, tokens and the caches after them."""
    jcfg, tcfg = _cfgs(which)
    jparams, tree = _weights(jcfg, seed=5)
    tparams = bridge.params_from_numpy(tree, DEV)
    B, S, steps = 2, 64, 4
    cache_len = S + steps + 2
    tokens = _tokens(jcfg, B, S, seed=6)
    jcache, jlog, jplen = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                                     cache_len=cache_len)
    with torch.inference_mode():
        tcache, tlog, plen = TM.prefill(tparams, tcfg,
                                        {"tokens": torch.from_numpy(tokens)}, cache_len)
    assert plen == jplen == S

    def caches_close():
        want = flatten(jax.tree.map(np.asarray, jcache))
        got = flatten(tcache)
        assert list(got) == list(want) == ["attn/k", "attn/v", "ssm/conv", "ssm/state"]
        for name in got:
            assert tuple(got[name].shape) == want[name].shape, name
            np.testing.assert_allclose(_np(got[name]), want[name], **SERVE_TOL,
                                       err_msg=name)

    np.testing.assert_allclose(_np(tlog), _np(jlog), **SERVE_TOL)
    caches_close()
    tok = np.argmax(_np(jlog), -1).astype(np.int32)[:, None]
    for i in range(steps):
        jlog, jcache = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jcache,
                                      jnp.int32(S + i))
        with torch.inference_mode():
            tlog, tcache = TM.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                          tcache, S + i)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **SERVE_TOL)
        tok = np.argmax(_np(jlog), -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(np.argmax(_np(tlog), -1)[:, None], tok)
    caches_close()


def _count_kernel_calls(monkeypatch):
    """The kernel path on the CPU: ``backend="kernel"`` resolves to the
    kernels for CPU tensors, and each wrapper is replaced by one that
    counts a call where the card would launch and computes its plain
    version (the differentiable ones inside the same autograd Function,
    backward through the plain version as on the card)."""
    counts = collections.Counter()

    def counted(name, plain):
        def body(*ins, **kw):
            counts[name] += 1
            return plain(*ins, **kw)
        return body

    def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0, prefix_len=0):
        return tops.recompute_vjp(
            "flash_attention", counted("flash_attention", tref.flash_attention_ref),
            tref.flash_attention_ref, (q, k, v), causal=causal, window=window,
            q_offset=q_offset, prefix_len=prefix_len)

    def ssd_scan(x, dt, A, Bm, Cm, *, chunk=128, initial_state=None):
        assert initial_state is None
        return tops.recompute_vjp("ssd_scan", counted("ssd_scan", tops._ssd_chunked),
                                  tops._ssd_chunked, (x, dt, A, Bm, Cm), chunk=chunk)

    def flash_decode(q, k, v, pos, *, window=0, softcap=0.0, ring=False):
        counts["flash_decode"] += 1
        return tref.decode_attention_ref(q[:, 0] if q.dim() == 4 else q, k, v, pos,
                                         window=window, softcap=softcap, ring=ring)

    resolve = tops.resolve_backend
    monkeypatch.setattr(tops, "resolve_backend", lambda backend, x: "kernel"
                        if backend == "kernel" else resolve(backend, x))
    monkeypatch.setattr(tops, "flash_attention", flash_attention)
    monkeypatch.setattr(tops, "ssd_scan", ssd_scan)
    monkeypatch.setattr(tops, "flash_decode", flash_decode)
    return counts


@pytest.mark.parametrize("which", CONFIGS)
def test_hybrid_kernel_launch_counts(monkeypatch, which):
    """Where the card launches, counted on the CPU.  A train step with
    remat (one checkpoint a group, nothing checkpointed inside it) runs
    each group's forward twice: 2·L ``ssd_scan`` and 2·G
    ``flash_attention``; without remat L and G.  The backward passes
    differentiate plain versions and launch nothing.  A prefill launches
    L ``ssd_scan`` and G ``flash_attention``; a decode step G
    ``flash_decode`` (its ssm layers take the recurrent update).  The
    kernel path's loss equals the plain path's."""
    jcfg, tcfg = _cfgs(which)
    _, tree = _weights(jcfg, seed=3)
    L, G = tcfg.num_layers, tcfg.num_layers // tcfg.hybrid_attn_every
    counts = _count_kernel_calls(monkeypatch)
    params = TTS.train_state_from(bridge.params_from_numpy(tree, DEV), {}, 0).params
    leaves = list(flatten(params).values())
    tb = {"tokens": torch.from_numpy(_tokens(jcfg, 2, 64, seed=4))}
    plain, _ = TM.loss_fn(params, tcfg, tb, backend="einsum")
    assert not counts
    for remat, runs in ((True, 2), (False, 1)):
        counts.clear()
        loss, _ = TM.loss_fn(params, tcfg, tb, remat=remat, backend="kernel")
        torch.autograd.grad(loss, leaves)
        assert counts == {"ssd_scan": runs * L, "flash_attention": runs * G}, (remat, counts)
        torch.testing.assert_close(loss.detach(), plain.detach(), rtol=1e-6, atol=0)
    counts.clear()
    with torch.inference_mode():
        cache, logits, plen = TM.prefill(params, tcfg, tb, 70, backend="kernel")
        assert counts == {"ssd_scan": L, "flash_attention": G}
        counts.clear()
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        for i in range(3):
            logits, cache = TM.decode_step(params, tcfg, tok, cache, plen + i,
                                           backend="kernel")
    assert counts == {"flash_decode": 3 * G}


def test_hybrid_checkpoints_cross_load(tmp_path):
    """A JAX checkpoint of the smoke model (bf16 weights, (G, per) ssm
    stack, unstacked shared block) loads in the port bit for bit, and
    one the port writes loads in the JAX package."""
    from repro.checkpointing import io as jio
    from repro.configs import get_smoke_config
    from repro_torch.checkpointing import io as tio

    jcfg = get_smoke_config("zamba2_2p7b")
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    jstate = JTS.make_train_state(jcfg, jax.random.PRNGKey(0))
    jio.save_checkpoint(str(tmp_path / "jax"), jstate, step=3)
    target = TTS.make_train_state(tcfg, torch.Generator().manual_seed(1), device=DEV)
    tstate = tio.load_checkpoint(str(tmp_path / "jax"), target)

    def bits(t):
        t = t.detach()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()

    def same(got, want):
        assert got.keys() == want.keys()
        for k in got:
            w = np.asarray(want[k])
            w = w.view(np.int16) if str(w.dtype) == "bfloat16" else w
            np.testing.assert_array_equal(bits(got[k]), w, err_msg=k)

    want = {k: v for k, v in jio._flatten(jstate).items() if k != "2"}
    same(flatten({"0": tstate.params, "1": tstate.opt_state}), want)
    assert tstate.params["blocks"]["ssm"]["in_proj"].dtype == torch.bfloat16
    with torch.no_grad():
        for t in flatten({"0": tstate.params, "1": tstate.opt_state}).values():
            t.add_(0.5)
    tio.save_checkpoint(str(tmp_path / "torch"), tstate, step=4)
    back = jio.load_checkpoint(str(tmp_path / "torch"), jax.eval_shape(lambda: jstate))
    assert jio.checkpoint_step(str(tmp_path / "torch")) == 4
    same(flatten({"0": tstate.params, "1": tstate.opt_state}),
         {k: v for k, v in jio._flatten(back).items() if k != "2"})


def test_hybrid_serve_launcher_warm_up_leaves_the_cache(tmp_path):
    """The serve launcher's untimed warm-up decode runs on a copy of a
    hybrid cache (its ssm states advance in place): the tokens it
    generates are those of prefill + greedy decode from the same
    weights."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import serve

    B, P, gen = 2, 64, 5
    res = serve.main(["--arch", "zamba2_2p7b", "--smoke", "--device", "cpu",
                      "--batch", str(B), "--prompt-len", str(P), "--gen", str(gen),
                      "--run-dir", str(tmp_path)])
    from repro_torch.configs import get_smoke_config
    tcfg = get_smoke_config("zamba2_2p7b")
    with torch.inference_mode():
        params = TM.init_params(tcfg, torch.Generator().manual_seed(0), device=DEV)
        src = SyntheticTokens(tcfg, DataConfig(batch_size=B, seq_len=P))
        batch = {k: torch.from_numpy(v) for k, v in src.next_batch().items()}
        cache, logits, plen = TM.prefill(params, tcfg, batch, P + gen)
        toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
        for i in range(gen - 1):
            logits, cache = TM.decode_step(params, tcfg, toks[-1], cache, plen + i)
            toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    assert res["decode_calls"] == gen
    torch.testing.assert_close(res["tokens"], torch.cat(toks, dim=1), rtol=0, atol=0)
