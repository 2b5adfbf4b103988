"""The port's MoE family (``repro_torch.models.moe`` and the moe branches
of the block, the model, the launchers and the profiler) held against
the JAX package on the CPU.

Weights come from the JAX package's ``init_moe`` / ``init_params`` (the
model's biases and norm scales perturbed) and cross with
``repro_torch.bridge``; inputs are numpy-seeded.  The block runs at
(E 4, k 2) and (E 16, k 8, d 64) at capacity factors 8.0 (no drops),
1.25 and 0.25 (drops), with a zero router (every probability tied) and
with tied router columns; the model at the three moe smoke configs
(``conftest.exact_cfg``, fp32, capacity factor 8.0) and at qwen3-moe's
with drops (capacity factor 0.5).

Tolerances: the block's output and aux metrics rtol 2e-4, atol 2e-5 in
fp32, as ``tests/test_moe.py`` holds the block against its oracle (the
same fp32 arithmetic in another order); gradients atol 1e-4 of each
leaf's largest value, logits atol/rtol 1e-4, losses rtol 2e-5 and
served logits and caches atol/rtol 2e-4, as ``tests/test_torch_hybrid.py``
holds the other families.  The expert ids and the valid slots, integers,
must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import exact_cfg
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models.config import ModelConfig as JConfig
from repro_torch import bridge
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.training import train_step as TTS
from repro_torch.tree import flatten
from test_torch_hybrid import _count_kernel_calls

DEV = torch.device("cpu")
BLOCK_TOL = dict(rtol=2e-4, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_RTOL = 2e-5
GRAD_TOL = 1e-4
MOE_ARCHS = ["qwen3_moe_30b_a3b", "moonshot_v1_16b_a3b", "dbrx_132b"]
METRICS = ("moe_aux_loss", "moe_z_loss", "moe_drop_frac")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two cores, not all: tier-1 runs test files in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().float().numpy().copy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _block_cfgs(E=4, k=2, d=64, cf=8.0, mlp="swiglu"):
    jcfg = JConfig(name="t", family="moe", num_layers=1, d_model=d, num_heads=2,
                   num_kv_heads=2, d_ff=96, vocab_size=64, num_experts=E,
                   experts_per_token=k, moe_capacity_factor=cf, mlp=mlp,
                   dtype="float32")
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _block_inputs(jcfg, seed, B=2, S=24, skew=False):
    """JAX-initialised block weights and a numpy-seeded x; with ``skew``
    x leans toward expert 0 (an offset of 0.3 on every feature, 0.05
    added to the router's column 0), so its capacity overflows at a
    capacity factor of 1.25."""
    tree = jax.tree.map(np.array, JMoE.init_moe(jax.random.PRNGKey(seed), jcfg,
                                                jnp.float32))
    x = np.random.default_rng(seed).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    if skew:
        tree["router"][:, 0] += 0.05
        x += 0.3
    return tree, x


def _jax_valid(jparams, jcfg, x):
    """The JAX package's expert ids and valid flags (B, S·k) of ``x``."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jparams["router"], axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, jcfg.experts_per_token)
    C = JMoE.capacity(jcfg, x.shape[1])
    _, _, valid = jax.vmap(lambda xx, gv, ei: JMoE._dispatch_one_group(
        xx, gv, ei, jcfg.num_experts, C))(jnp.asarray(x), gate_vals, expert_ids)
    return np.asarray(expert_ids), np.asarray(valid)


def _port_valid(tparams, tcfg, x):
    _, _, _, expert_ids = TMoE.route(tparams, tcfg, x)
    _, _, valid = TMoE.dispatch(x, expert_ids, tcfg.num_experts,
                                TMoE.capacity(tcfg, x.shape[1]))
    return expert_ids.numpy(), valid.numpy()


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
@pytest.mark.parametrize("E,k", [(4, 2), (16, 8)])
def test_moe_block_matches_jax(E, k, cf):
    """y and the three metrics; the same expert ids and the same valid
    slots (drops at 1.25 and 0.25); without drops both equal their
    loop-over-experts oracles."""
    jcfg, tcfg = _block_cfgs(E, k, cf=cf)
    tree, x = _block_inputs(jcfg, seed=E + k, skew=cf < 8.0)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = bridge.params_from_numpy(tree, DEV)
    y, m = JMoE.moe_block(jparams, jcfg, jnp.asarray(x))
    ty, tm = TMoE.moe_block(tparams, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(ty), np.asarray(y), **BLOCK_TOL)
    for key in METRICS:
        np.testing.assert_allclose(float(tm[key]), float(m[key]), **BLOCK_TOL,
                                   err_msg=key)
    (jids, jvalid), (tids, tvalid) = _jax_valid(jparams, jcfg, x), \
        _port_valid(tparams, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tvalid, jvalid)
    assert (float(tm["moe_drop_frac"]) > 0) == (cf < 8.0)
    if cf == 8.0:
        np.testing.assert_allclose(
            _np(TMoE.moe_reference(tparams, tcfg, torch.from_numpy(x))),
            np.asarray(JMoE.moe_reference(jparams, jcfg, jnp.asarray(x))), **BLOCK_TOL)
        np.testing.assert_allclose(_np(ty), _np(TMoE.moe_reference(
            tparams, tcfg, torch.from_numpy(x))), **BLOCK_TOL)


@pytest.mark.parametrize("router", ["zero", "tied_columns"])
def test_tied_router_probabilities_pick_jax_experts(router):
    """A zero router ties every probability, and a router whose columns
    come in equal pairs ties each pair: the expert ids are those of
    ``jax.lax.top_k`` (the lower index first), and so are y, the metrics
    and the valid slots, with drops (capacity factor 1.25)."""
    jcfg, tcfg = _block_cfgs(16, 8, cf=1.25)
    tree, x = _block_inputs(jcfg, seed=7)
    if router == "zero":
        tree["router"] = np.zeros_like(tree["router"])
    else:
        tree["router"][:, 1::2] = tree["router"][:, 0::2]
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = bridge.params_from_numpy(tree, DEV)
    (jids, jvalid), (tids, tvalid) = _jax_valid(jparams, jcfg, x), \
        _port_valid(tparams, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tvalid, jvalid)
    if router == "zero":
        assert (tids == np.arange(8)).all()
    y, m = JMoE.moe_block(jparams, jcfg, jnp.asarray(x))
    ty, tm = TMoE.moe_block(tparams, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(ty), np.asarray(y), **BLOCK_TOL)
    for key in METRICS:
        np.testing.assert_allclose(float(tm[key]), float(m[key]), **BLOCK_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("mlp", ["swiglu", "glu", "geglu", "gelu"])
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_block_grads_match_jax(cf, mlp):
    """The gradients with respect to x and every leaf, the router's
    included (through the gates, the aux loss and the z loss), against
    ``jax.grad`` of the same scalar: sum(y · w) + aux + z."""
    jcfg, tcfg = _block_cfgs(8, 2, cf=cf, mlp=mlp)
    tree, x = _block_inputs(jcfg, seed=11, skew=cf < 8.0)
    w = np.random.default_rng(12).standard_normal(x.shape).astype(np.float32)

    def jf(p, xx):
        y, m = JMoE.moe_block(p, jcfg, xx)
        return jnp.sum(y * w) + m["moe_aux_loss"] + m["moe_z_loss"]

    jg, jgx = jax.grad(jf, argnums=(0, 1))(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    tparams = {k: v.requires_grad_() for k, v in bridge.params_from_numpy(tree, DEV).items()}
    tx = torch.from_numpy(x).requires_grad_()
    ty, tm = TMoE.moe_block(tparams, tcfg, tx)
    f = torch.sum(ty * torch.from_numpy(w)) + tm["moe_aux_loss"] + tm["moe_z_loss"]
    names = list(tparams)
    got = torch.autograd.grad(f, [tparams[k] for k in names] + [tx])
    assert set(names) == set(jg)
    for name, g in zip(names + ["x"], got):
        want = np.asarray(jgx if name == "x" else jg[name])
        np.testing.assert_allclose(_np(g), want, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(want).max(), 1e-6),
                                   err_msg=name)
    assert float(got[names.index("router")].abs().sum()) > 0


def test_capacity_equal_jax():
    for E, k, cf in ((4, 2, 8.0), (128, 8, 1.25), (16, 4, 0.25), (64, 6, 1.25)):
        jcfg, tcfg = _block_cfgs(E, k, cf=cf)
        for S in (1, 7, 64, 512, 2048):
            assert TMoE.capacity(tcfg, S) == JMoE.capacity(jcfg, S)
    # decode (S = 1) at qwen3-moe's E 128, k 8, cf 1.25: the floor of 4
    assert TMoE.capacity(_block_cfgs(128, 8, cf=1.25)[1], 1) == 4


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _model_cfgs(name):
    if name == "qwen3_moe_30b_a3b-drops":
        jcfg = dataclasses.replace(exact_cfg("qwen3_moe_30b_a3b"), moe_capacity_factor=0.5)
    else:
        jcfg = exact_cfg(name)
    assert jcfg.family == "moe"
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


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _shapes(tree):
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: v for k, sub in tree.items()
                for p, v in _shapes(sub).items()}
    return {"": (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("name", MOE_ARCHS + ["qwen3_moe_30b_a3b-full"])
def test_moe_init_names_shapes_and_counts_match_jax(name):
    """Names, shapes and dtypes of every leaf equal ``jax.eval_shape`` of
    the JAX init (bf16 smoke configs, and qwen3-moe-30b-a3b at full size
    on meta tensors), the router fp32, and the count the config's."""
    from repro.configs import get_config as jget, get_smoke_config as jsmoke
    if name.endswith("-full"):
        jcfg = jget(name[:-len("-full")])
        tcfg = TConfig(**dataclasses.asdict(jcfg))
        tparams = TM.init_params(tcfg, None, device=torch.device("meta"))
    else:
        jcfg = jsmoke(name)
        tcfg = TConfig(**dataclasses.asdict(jcfg))
        tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0), device=DEV)
        wi = tparams["blocks"]["moe"]["wi"].float()
        assert not torch.equal(wi[0, 0], wi[0, 1])       # experts differ
    assert _shapes(tparams) == _shapes(JM.abstract_params(jcfg))
    assert tparams["blocks"]["moe"]["router"].dtype == torch.float32
    assert TM.param_count(tparams) == tcfg.param_count() == JM.param_count(
        JM.abstract_params(jcfg))


@pytest.mark.parametrize("name", MOE_ARCHS + ["qwen3_moe_30b_a3b-drops"])
def test_moe_loss_and_grads_match_jax(name):
    """Logits, ``loss_fn``'s total, ``ce_loss`` and ``aux_loss``, and every
    gradient against JAX; remat on and off give the same loss and
    gradients (the aux leaves each checkpoint beside x)."""
    jcfg, tcfg = _model_cfgs(name)
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
    for key, got, want in (("total", tloss, jloss), ("ce_loss", tm["ce_loss"], jm["ce_loss"]),
                           ("aux_loss", tm["aux_loss"], jm["aux_loss"])):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL,
                                   err_msg=key)
    assert float(tm["aux_loss"].detach()) > 0
    want = flatten(jax.tree.map(np.asarray, jgrads))
    assert set(flatten(params)) == set(want)
    for path, g in zip(flatten(params), grads):
        w = want[path].astype(np.float32)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(w).max(), 1e-6),
                                   err_msg=path)
    noloss, _ = TM.loss_fn(params, tcfg, tb, remat=False)
    nograds = torch.autograd.grad(noloss, leaves)
    torch.testing.assert_close(noloss.detach(), tloss.detach(), rtol=1e-6, atol=0)
    for a, b in zip(grads, nograds):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_prefill_and_decode_match_jax(name):
    """Prefill logits and K/V caches, then 4 greedy decode steps (each
    token's moe block at the decode capacity C = 4): logits, tokens and
    the caches after them."""
    jcfg, tcfg = _model_cfgs(name)
    jparams, tree = _weights(jcfg, seed=5)
    tparams = bridge.params_from_numpy(tree, DEV)
    B, S, steps = 2, 24, 4
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
        assert sorted(got) == sorted(want) == ["k", "v"]
        for key in got:
            np.testing.assert_allclose(_np(got[key]), want[key], **SERVE_TOL, err_msg=key)

    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **SERVE_TOL)
    caches_close()
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
    for i in range(steps):
        jlog, jcache = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jcache,
                                      jnp.int32(S + i))
        with torch.inference_mode():
            tlog, tcache = TM.decode_step(tparams, tcfg, torch.from_numpy(tok), tcache, S + i)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **SERVE_TOL)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(np.argmax(_np(tlog), -1)[:, None], tok)
    caches_close()


def test_moe_kernel_launch_counts(monkeypatch):
    """Where the card launches, counted on the CPU (qwen3-moe smoke, QK
    norm before the kernel): a train step with remat launches 2·L
    ``flash_attention`` (forward and recompute), without remat L; a
    prefill L; each decode call L ``flash_decode``.  The kernel path's
    loss equals the plain path's."""
    jcfg, tcfg = _model_cfgs("qwen3_moe_30b_a3b")
    _, tree = _weights(jcfg, seed=3)
    L = tcfg.num_layers
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
        assert counts == {"flash_attention": runs * L}, (remat, counts)
        torch.testing.assert_close(loss.detach(), plain.detach(), rtol=1e-6, atol=0)
    counts.clear()
    with torch.inference_mode():
        cache, logits, plen = TM.prefill(params, tcfg, tb, 70, backend="kernel")
        assert counts == {"flash_attention": L}
        counts.clear()
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        for i in range(3):
            logits, cache = TM.decode_step(params, tcfg, tok, cache, plen + i,
                                           backend="kernel")
    assert counts == {"flash_decode": 3 * L}


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "dbrx_132b"])
def test_moe_serve_launcher_cpu(arch, tmp_path):
    """The serve launcher takes a moe smoke config: its tokens are those
    of prefill + greedy decode from the same weights."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import serve

    B, P, gen = 2, 32, 4
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", str(B),
                      "--prompt-len", str(P), "--gen", str(gen), "--run-dir", str(tmp_path)])
    tcfg = get_smoke_config(arch)
    assert res["num_layers"] == tcfg.num_layers and res["decode_calls"] == gen
    with torch.inference_mode():
        params = TM.init_params(tcfg, torch.Generator().manual_seed(0), device=DEV)
        src = SyntheticTokens(tcfg, DataConfig(batch_size=B, seq_len=P))
        batch = {k: torch.from_numpy(v) for k, v in src.next_batch().items()}
        cache, logits, plen = TM.prefill(params, tcfg, batch, P + gen)
        toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
        for i in range(gen - 1):
            logits, cache = TM.decode_step(params, tcfg, toks[-1], cache, plen + i)
            toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    torch.testing.assert_close(res["tokens"], torch.cat(toks, dim=1), rtol=0, atol=0)


def test_moe_train_launcher_cpu_loss_falls(tmp_path):
    """The train launcher trains the qwen3-moe smoke config: the losses
    are finite and fall, and every logged step carries a positive
    ``aux_loss``."""
    import json
    import math

    from repro_torch.launch import train
    run_dir = tmp_path / "run"
    res = train.main(["--arch", "qwen3_moe_30b_a3b", "--smoke", "--device", "cpu",
                      "--steps", "12", "--batch", "4", "--seq", "32", "--log-every", "4",
                      "--run-dir", str(run_dir)])
    losses = res["losses"]
    assert res["num_layers"] == 2 and len(losses) == 12
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0] - 0.3
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    steps = [row for row in rows if row["kind"] == "metrics"]
    assert steps and all(row["aux_loss"] > 0 for row in steps)
