"""The port's dense serving path held against ``repro.models.model`` on
the CPU.

Weights come from ``repro.models.model.init_params`` (with the biases
and norm parameters perturbed, so they are not the trivial zeros/ones)
and cross with ``repro_torch.bridge``; prompts are numpy-seeded.  Both
packages run ``prefill`` and 4 greedy ``decode_step``s in fp32
(``conftest.exact_cfg``); logits and caches must agree to atol/rtol
2e-4 (as ``tests/test_serve.py``) and the greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import exact_cfg
from repro.models import model as JM
from repro.training import serve_step as JSS
from repro_torch import bridge
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.training import serve_step as TSS

TOL = dict(rtol=2e-4, atol=2e-4)
DEV = torch.device("cpu")


def _cfgs(name):
    if name == "granite_8b_gqa":
        jcfg = dataclasses.replace(exact_cfg("granite_8b"), num_heads=4,
                                   num_kv_heads=2)
    else:
        jcfg = exact_cfg(name)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _weights(jcfg, seed=0):
    """JAX init as numpy, with every bias and norm leaf perturbed."""
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("bq", "bk", "bv", "bias"):
                t[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
            elif k == "scale":
                t[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    perturb(tree)
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree, DEV)


def _np(x):
    """numpy copy (writable, so torch.from_numpy may take it)."""
    return x.numpy().copy() if isinstance(x, torch.Tensor) else np.array(x)


@pytest.mark.parametrize("name", ["granite_8b", "granite_8b_gqa",
                                  "qwen1p5_0p5b", "starcoder2_7b"])
def test_prefill_and_decode_match_jax(name):
    jcfg, tcfg = _cfgs(name)
    jparams, tparams = _weights(jcfg)
    B, S, steps = 2, 12, 4
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    cache_len = S + steps + 2
    jcache, jlog, jplen = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                                     cache_len=cache_len)
    tcache, tlog, tplen = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens)},
                                     cache_len)
    assert tplen == jplen == S
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), **TOL)

    tok = np.argmax(_np(jlog), -1).astype(np.int32)[:, None]
    np.testing.assert_array_equal(np.argmax(_np(tlog), -1)[:, None], tok)
    pos = S
    for _ in range(steps):
        jlog, jcache = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jcache,
                                      jnp.int32(pos))
        tlog, tcache = TM.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                      tcache, pos)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
        jtok = np.argmax(_np(jlog), -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(np.argmax(_np(tlog), -1)[:, None], jtok)
        tok, pos = jtok, pos + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), **TOL)


def test_ring_cache_through_cache_plan_matches_jax():
    """A sliding-window config whose plan is a ring cache of window size:
    decode wraps around the ring in both packages alike."""
    jcfg = dataclasses.replace(exact_cfg("granite_8b"), sliding_window=8)
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    total = 16
    assert TSS.cache_plan(tcfg, total) == JSS.cache_plan(jcfg, total) == \
        {"cache_len": 8, "ring": True, "window": 8}
    jparams, tparams = _weights(jcfg, seed=3)
    jstep, plan = JSS.make_decode_step(jcfg, total)
    tstep, _ = TSS.make_decode_step(tcfg, total)
    B, S = 2, 6                              # the prompt fits in the window
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jcache, jlog, _ = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                                 cache_len=plan["cache_len"])
    tcache, tlog, _ = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens)},
                                 plan["cache_len"])
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    tok = np.argmax(_np(jlog), -1).astype(np.int32)[:, None]
    for pos in range(S, total):              # positions 8.. wrap the ring
        jlog, jnext, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(pos))
        tlog, tnext, tcache = tstep(tparams, tcache, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
        np.testing.assert_array_equal(_np(tnext), _np(jnext))
        tok = _np(jnext)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), **TOL)


def test_linear_cache_overflow_raises():
    """JAX clamps a decode position past a linear cache onto the last
    slot; the port raises instead."""
    _, tcfg = _cfgs("granite_8b")
    tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0), device=DEV)
    cache = TM.init_cache(tcfg, 1, 4, device=DEV)
    tok = torch.zeros(1, 1, dtype=torch.int32)
    TM.decode_step(tparams, tcfg, tok, cache, 3)
    with pytest.raises(ValueError, match="outside a linear cache"):
        TM.decode_step(tparams, tcfg, tok, cache, 4)
    with pytest.raises(ValueError, match="overflows"):
        TM.prefill(tparams, tcfg, {"tokens": torch.zeros(1, 5, dtype=torch.int32)}, 4)


@pytest.mark.parametrize("name", ["granite_8b", "qwen1p5_0p5b", "starcoder2_7b"])
def test_init_params_names_shapes_and_counts_match_jax(name):
    """The port's own init has the JAX tree's names, shapes and dtypes
    (bf16 smoke config) and the config's analytic parameter count."""
    from repro.configs import get_smoke_config
    jcfg = get_smoke_config(name)
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    want = jax.tree_util.tree_flatten_with_path(JM.abstract_params(jcfg))[0]
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype)) for p, x in want}
    got = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + f"['{k}']")
            else:
                got[path + f"['{k}']"] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0), device=DEV)
    walk(tparams, "")
    assert got == want
    assert TM.param_count(tparams) == tcfg.param_count()
    # stacked leaves differ layer to layer (drawn a slice at a time)
    wq = tparams["blocks"]["attn"]["wq"].float()
    assert not torch.equal(wq[0], wq[1])
    assert abs(float(wq.std()) - tcfg.d_model ** -0.5) < 0.1 * tcfg.d_model ** -0.5


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_and_norms_match_jax(kind):
    from repro.models import layers as JL
    rng = np.random.default_rng(4)
    d, ff = 16, 24
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    p = {"wi": rng.standard_normal((d, ff)).astype(np.float32) * 0.3,
         "wg": rng.standard_normal((d, ff)).astype(np.float32) * 0.3,
         "wo": rng.standard_normal((ff, d)).astype(np.float32) * 0.3}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    np.testing.assert_allclose(
        TL.apply_mlp(tp, torch.from_numpy(x), kind).numpy(),
        np.asarray(JL.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), kind)),
        rtol=1e-5, atol=1e-5)
    norm = {"scale": rng.standard_normal(d).astype(np.float32),
            "bias": rng.standard_normal(d).astype(np.float32)}
    for nk in ("rmsnorm", "layernorm"):
        np.testing.assert_allclose(
            TL.apply_norm({k: torch.from_numpy(v) for k, v in norm.items()},
                          torch.from_numpy(x), nk).numpy(),
            np.asarray(JL.apply_norm(jax.tree.map(jnp.asarray, norm),
                                     jnp.asarray(x), nk)),
            rtol=1e-5, atol=1e-5)
