"""The port's SSD functions, Mamba2 block, ``flash_attention`` gradient
and SSM serving path, held against the JAX package on the CPU.

Inputs are numpy-seeded; weights come from ``repro.models.model.
init_params`` (fp32 ``conftest.exact_cfg``, with biases and norm scales
perturbed) and cross with ``repro_torch.bridge``.  Where JAX reaches a
Pallas kernel it runs in interpret mode, as ``tests/test_kernels.py``
runs it.  The CUDA kernels run only on the card (``chip_smoke.py``); on
the CPU the wrappers compute their plain versions, and the autograd
Functions are driven with the plain version as their forward body.

Tolerances: the SSD functions and the block are the same fp32
arithmetic in another order, atol 2e-5 on O(1) values (the sequential
and chunked forms sum ~64 terms differently); gradients, which sum
over every position, rtol 1e-4 of each leaf's largest value; the
served logits and caches atol/rtol 2e-4 as ``tests/test_serve.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import exact_cfg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as TTF
from repro_torch.models.config import ModelConfig as TConfig

ATOL = 2e-5
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)
DEV = torch.device("cpu")


def _ssd_inputs(seed, b=2, S=64, h=4, p=16, g=1, n=8, state=False):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    x = f(b, S, h, p)
    dt = (np.log1p(np.exp(f(b, S, h))) * 0.5).astype(np.float32)
    A = (-np.exp(f(h, scale=0.3))).astype(np.float32)
    out = [x, dt, A, f(b, S, g, n, scale=0.3), f(b, S, g, n, scale=0.3)]
    if state:
        out.append(f(b, h, p, n, scale=0.3))
    return out


def _t(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _grad_close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("g,state", [(1, False), (2, False), (1, True), (2, True)])
def test_ssd_ref_and_chunked_match_jax(g, state):
    arrs = _ssd_inputs(g + 10 * state, g=g, state=state)
    *ins, s0 = arrs if state else (*arrs, None)
    jins = list(map(jnp.asarray, ins))
    js0 = None if s0 is None else jnp.asarray(s0)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    want_y, want_f = jref.ssd_ref(*jins, initial_state=js0)
    jc_y, jc_f = jssm.ssd_chunked(*jins, 16, js0)
    for got_y, got_f in (tref.ssd_ref(*_t(ins), initial_state=ts0),
                         tssm.ssd_chunked(*_t(ins), 16, ts0)):
        for want in ((want_y, want_f), (jc_y, jc_f)):
            _close(got_y, want[0])
            _close(got_f, want[1])


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_plain_matches_pallas_interpret(g):
    ins = _ssd_inputs(20 + g, S=64, h=4, p=32, g=g, n=16)
    want_y, want_f = pallas_ssd_scan(*map(jnp.asarray, ins), chunk=32,
                                     interpret=True)
    got_y, got_f = tops.ssd_scan(*_t(ins), chunk=32)    # CPU: plain version
    _close(got_y, want_y, atol=1e-4, rtol=1e-3)          # as tests/test_kernels.py
    _close(got_f, want_f, atol=1e-4, rtol=1e-3)
    assert got_y.dtype == got_f.dtype == torch.float32
    assert tops.ssd_scan.launches == 0


def _plain_ssd_body(x, dt, A, Bm, Cm, *, chunk):
    return tref.ssd_ref(x, dt, A, Bm, Cm)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_grad_matches_jax(g):
    """The autograd Function (forward: the kernel's plain version;
    backward: the chunked form) against ``jax.grad`` of the JAX wrapper
    (forward: the interpret-mode Pallas kernel; backward: ``ssd_ref``)."""
    ins = _ssd_inputs(30 + g, S=64, h=4, p=16, g=g, n=8)
    rng = np.random.default_rng(40 + g)
    gy = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    gf = rng.standard_normal((2, 4, 16, 8)).astype(np.float32)

    def jloss(*a):
        y, fin = jops.ssd_scan(*a, chunk=16)
        return jnp.sum(y * gy) + jnp.sum(fin * gf)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))
    tins = [t.requires_grad_() for t in _t(ins)]
    y, fin = tops.recompute_vjp("ssd_scan", _plain_ssd_body, tops._ssd_chunked,
                                tins, chunk=16)
    got = torch.autograd.grad([y, fin], tins, _t([gy, gf]))
    for a, b in zip(got, want):
        _grad_close(a, b)
    # an unused final state (the training path) brings no gradient
    y, _ = tops.recompute_vjp("ssd_scan", _plain_ssd_body, tops._ssd_chunked,
                                tins, chunk=16)
    gx, = torch.autograd.grad(y, tins[0], torch.from_numpy(gy))
    want_x = jax.grad(lambda x: jnp.sum(jops.ssd_scan(
        x, *map(jnp.asarray, ins[1:]), chunk=16)[0] * gy))(jnp.asarray(ins[0]))
    _grad_close(gx, want_x)


def test_ssd_routing_refuses_what_the_kernel_cannot_do():
    cfg = TConfig(**dataclasses.asdict(exact_cfg("mamba2_780m")))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device=DEV)
    p = TTF.layer(params["blocks"]["ssm"], 0)
    u = torch.randn(1, 32, cfg.d_model)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        tssm.mamba2_forward(p, cfg, u, backend="kernel")
    state = torch.zeros(1, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)
    with pytest.raises(ValueError, match="initial_state"):
        tssm.mamba2_forward(p, cfg, u, backend="kernel", initial_state=state)
    x, dt, A, Bm, Cm = _t(_ssd_inputs(0, S=48))
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        tops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError):
        tops.ssd_scan(x, dt[:, :5], A, Bm, Cm, chunk=16)


def _weights(jcfg, seed=0):
    """JAX init as numpy, with biases, norm scales, D and dt_bias
    perturbed so they are not the trivial zeros/ones."""
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("bq", "bk", "bv", "bias", "scale", "conv_b", "D", "dt_bias"):
                t[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    perturb(tree)
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree, DEV)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _np(x):
    return x.detach().numpy().copy() if isinstance(x, torch.Tensor) else np.array(x)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_forward_matches_jax(with_state):
    jcfg = exact_cfg("mamba2_780m")
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    jparams, tparams = _weights(jcfg, seed=1)
    jp = _layer0(jparams["blocks"]["ssm"])
    tp = TTF.layer(tparams["blocks"]["ssm"], 0)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    s0 = (rng.standard_normal((2, jcfg.ssm_nheads, jcfg.ssm_headdim,
                               jcfg.ssm_state)) * 0.3).astype(np.float32) \
        if with_state else None
    jy, jf = jssm.mamba2_forward(jp, jcfg, jnp.asarray(u), backend="einsum",
                                 initial_state=None if s0 is None else jnp.asarray(s0))
    ty, tf, _ = tssm.mamba2_forward(tp, tcfg, torch.from_numpy(u), backend="einsum",
                                 initial_state=None if s0 is None else torch.from_numpy(s0))
    _close(ty, jy, atol=1e-4, rtol=1e-4)
    _close(tf, jf, atol=1e-4, rtol=1e-4)
    # auto on the CPU is the same chunked path
    ty2, _, _ = tssm.mamba2_forward(tp, tcfg, torch.from_numpy(u))
    if s0 is None:
        torch.testing.assert_close(ty2, ty, rtol=0, atol=0)

    cache = tssm.init_ssm_cache(tcfg, 2, torch.float32, device=DEV)
    jcache = jssm.init_ssm_cache(jcfg, 2, jnp.float32)
    ut = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    for _ in range(3):
        jo, jcache = jssm.mamba2_decode_step(jp, jcfg, jnp.asarray(ut), jcache)
        to, cache = tssm.mamba2_decode_step(tp, tcfg, torch.from_numpy(ut), cache)
        _close(to, jo, atol=1e-4, rtol=1e-4)
    for key in ("conv", "state"):
        _close(cache[key], jcache[key], atol=1e-5, rtol=1e-4)


FA_GRAD_CASES = [
    (2, 16, 16, 4, 2, 64, True, 0, 0),        # causal, GQA
    (1, 24, 24, 2, 2, 64, True, 6, 0),        # causal + window
    (1, 8, 24, 2, 1, 128, True, 0, 16),       # q_offset, hd 128
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window,q_offset", FA_GRAD_CASES)
def test_flash_attention_grad_matches_jax(B, Sq, Sk, H, KV, hd, causal, window,
                                          q_offset):
    rng = np.random.default_rng(Sq + 7 * Sk)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    go = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = jax.grad(lambda q, k, v: jnp.sum(jops.flash_attention(q, k, v, **kw) * go),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = [t.requires_grad_() for t in _t((q, k, v))]
    out = tops.recompute_vjp("flash_attention", tref.flash_attention_ref,
                             tref.flash_attention_ref, (tq, tk, tv), **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(go))
    for a, b in zip(got, want):
        _grad_close(a, b)
    # the CPU branch of the wrapper is the plain version, differentiable
    out2 = tops.flash_attention(tq, tk, tv, **kw)
    assert out2.grad_fn is not None
    torch.testing.assert_close(out2, out, rtol=0, atol=0)


def test_ssm_prefill_and_decode_match_jax():
    jcfg = exact_cfg("mamba2_780m")
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    jparams, tparams = _weights(jcfg, seed=5)
    B, S, steps = 2, 64, 4
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jcache, jlog, _ = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                                 cache_len=0)
    with torch.inference_mode():
        tcache, tlog, plen = TM.prefill(tparams, tcfg,
                                        {"tokens": torch.from_numpy(tokens)}, 0)
    assert plen == S
    np.testing.assert_allclose(_np(tlog), _np(jlog), **SERVE_TOL)
    for key in ("conv", "state"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), **SERVE_TOL)
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
    for key in ("conv", "state"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), **SERVE_TOL)


def test_ssm_init_names_shapes_and_counts_match_jax():
    from repro.configs import get_smoke_config
    jcfg = get_smoke_config("mamba2_780m")
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    want = jax.tree_util.tree_flatten_with_path(JM.abstract_params(jcfg))[0]
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype)) for p, x in want}
    tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0), device=DEV)
    got = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + f"['{k}']")
            else:
                got[path + f"['{k}']"] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    walk(tparams, "")
    assert got == want
    assert TM.param_count(tparams) == tcfg.param_count()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))["blocks"]["ssm"]
    tp = tparams["blocks"]["ssm"]
    for k in ("A_log", "D", "dt_bias"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6)


def test_row_strided_reads_column_slices_in_place():
    """B and C reach the kernel as column slices of one (b, S, 2·g·n)
    tensor; the wrapper passes them with their row stride, uncopied, and
    copies only a layout the kernel cannot read."""
    BC = torch.randn(2, 16, 2 * 3 * 8)
    Bm = BC[..., :24].view(2, 16, 3, 8)
    t, rs = tops._row_strided(Bm)
    assert t.data_ptr() == Bm.data_ptr() and rs == 48
    x = torch.randn(2, 16, 4, 8)
    t, rs = tops._row_strided(x)
    assert t is x and rs == 32
    xt = torch.randn(2, 4, 16, 8).transpose(1, 2)          # (b, S, h, p) view
    t, rs = tops._row_strided(xt)
    assert t.is_contiguous() and rs == 32 and torch.equal(t, xt)
