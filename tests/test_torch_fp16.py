"""float16 in the port, held against the JAX package's float16 on the CPU.

The JAX package builds a model in any dtype (``jnp.dtype(cfg.dtype)``)
and its Pallas kernels take fp16; the port builds, trains, serves and
checkpoints a ``float16`` config the same way.  Weights come from
``repro.models.model.init_params`` in fp16 and cross with
``repro_torch.bridge``; tokens are numpy-seeded.

Tolerances: the two frameworks round to fp16 at different places (their
products' outputs, the softmax's input), each rounding a step of 2^-11
relative.  At smoke size the logits of the two packages sit 1.0e-3 to
2.3e-3 apart in relative L2 and up to 1.05e-2 in max abs (logits up to
~4); bf16 in the same places reads 9.6e-3 to 1.5e-2 rel L2.  The limits,
5e-3 rel L2 and 2e-2 max abs, hold fp16 with a 2x margin and would catch
a path that rounds to bf16 where it should keep fp16.  Checkpoints and
the bridge are exact.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import io as jio
from repro.configs import get_smoke_config
from repro.models import model as JM
from repro.training import train_step as JTS
from repro_torch import bridge
from repro_torch.checkpointing import io as tio
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.training import train_step as TTS
from repro_torch.tree import flatten

DEV = torch.device("cpu")
REL_L2, MAX_ABS = 5e-3, 2e-2


@pytest.fixture(autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)          # two cores, not all: tier-1 runs files in parallel
    yield
    torch.set_num_threads(threads)


def _cfgs(name):
    jcfg = dataclasses.replace(get_smoke_config(name), dtype="float16")
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _weights(jcfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), DEV)


def _assert_near(got, want):
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert np.isfinite(g).all()
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= REL_L2 and np.abs(g - w).max() <= MAX_ABS, (rel, np.abs(g - w).max())


def test_float16_is_a_model_dtype():
    """On the seed tree ``dtype_of`` raised ``KeyError`` for float16."""
    _, tcfg = _cfgs("qwen1p5_0p5b")
    assert TL.dtype_of(tcfg) == torch.float16
    assert set(TL.DTYPES) == {"float32", "bfloat16", "float16"}


@pytest.mark.parametrize("name", ["qwen1p5_0p5b", "mamba2_780m", "zamba2_2p7b"])
def test_float16_config_builds_and_forward_matches_jax(name):
    """The port's own init in fp16 has the JAX init's leaves, names and
    dtypes; on the JAX weights both forwards and losses agree."""
    jcfg, tcfg = _cfgs(name)
    own = flatten(TM.init_params(tcfg, torch.Generator().manual_seed(0), device=DEV))
    jp, tp = _weights(jcfg)
    want = flatten(jax.tree.map(np.asarray, jp))
    assert own.keys() == want.keys()
    for k in own:
        assert str(own[k].dtype).split(".")[-1] == str(want[k].dtype), k
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jl, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(tokens)}, remat=False)
    tl, _ = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(tokens)}, remat=False)
    assert tl.dtype == torch.float16 and tuple(tl.shape) == jl.shape
    _assert_near(tl, jl)
    jloss, _ = JM.loss_fn(jp, jcfg, {"tokens": jnp.asarray(tokens)}, remat=False)
    tloss, _ = TM.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(tokens)}, remat=False)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=REL_L2)


def test_float16_prefill_and_decode_match_jax():
    """Serving in fp16: the cache takes the model's dtype; prefill and 3
    greedy decode steps fed the JAX package's tokens."""
    jcfg, tcfg = _cfgs("qwen1p5_0p5b")
    jp, tp = _weights(jcfg)
    B, S, steps = 2, 12, 3
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jcache, jlog, _ = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                                 cache_len=S + steps)
    tcache, tlog, _ = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(tokens)}, S + steps)
    assert tcache["k"].dtype == tcache["v"].dtype == torch.float16
    _assert_near(tlog, jlog)
    for i in range(steps):
        tok = np.argmax(np.asarray(jlog.astype(jnp.float32)), -1).astype(np.int32)[:, None]
        jlog, jcache = JM.decode_step(jp, jcfg, jnp.asarray(tok), jcache, jnp.int32(S + i))
        tlog, tcache = TM.decode_step(tp, tcfg, torch.from_numpy(tok), tcache, S + i)
        _assert_near(tlog, jlog)


def test_float16_train_steps_match_jax():
    """Three AdamW steps from the JAX package's fp16 train state on the
    same batches: every loss within the forward's limit, and finite."""
    jcfg, tcfg = _cfgs("qwen1p5_0p5b")
    jstate = JTS.make_train_state(jcfg, jax.random.PRNGKey(0))
    np_state = jax.tree.map(np.asarray, jstate)
    tstate = bridge.train_state_from_numpy(np_state.params, np_state.opt_state,
                                           np_state.step, DEV)
    jstep = jax.jit(JTS.make_train_step(jcfg, remat=False))
    tstep = TTS.make_train_step(tcfg, remat=False)
    rng = np.random.default_rng(3)
    for _ in range(3):
        batch = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(batch)})
        assert np.isfinite(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=REL_L2)
    assert all(p.dtype == torch.float16 for k, p in flatten(tstate.params).items()
               if not k.endswith("scale"))


def test_float16_checkpoint_round_trips(tmp_path):
    """fp16 leaves are stored as ``"float16"``, as the JAX writer stores
    them, and load bit for bit in either package."""
    jcfg, tcfg = _cfgs("qwen1p5_0p5b")
    jstate = JTS.make_train_state(jcfg, jax.random.PRNGKey(0))
    jio.save_checkpoint(str(tmp_path / "jax"), jstate, step=3)
    target = TTS.make_train_state(tcfg, torch.Generator().manual_seed(1), device=DEV)
    tstate = tio.load_checkpoint(str(tmp_path / "jax"), target)
    want = {k: v for k, v in jio._flatten(jstate).items() if k != "2"}
    got = flatten({"0": tstate.params, "1": tstate.opt_state})
    assert got.keys() == want.keys()
    for k in got:
        w = np.asarray(want[k])
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
        np.testing.assert_array_equal(got[k].detach().numpy(), w, err_msg=k)
    tio.save_checkpoint(str(tmp_path / "torch"), tstate, step=4)
    with open(tmp_path / "torch" / "index.json") as f:
        tidx = json.load(f)["entries"]
    with open(tmp_path / "jax" / "index.json") as f:
        assert json.load(f)["entries"] == tidx
    assert tidx["0/embed/tok"]["dtype"] == "float16"
    back = jio.load_checkpoint(str(tmp_path / "torch"), jax.eval_shape(lambda: jstate))
    for k, v in jio._flatten(back).items():
        if k != "2":
            np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]), err_msg=k)


def test_float16_drops_the_softmax_gradient_as_the_reference_does():
    """Without loss scaling (the reference has none), the logits'
    gradient under float16 rounds to zero wherever p_j / N_tokens is
    below fp16's least subnormal half-step (2.98e-8): at qwen1.5-0.5b's
    vocabulary (151936, p_j ~ 6.6e-6) and 1022 tokens nearly every token
    absent from the batch gets none, so its tied embedding row's
    gradient is exactly zero, the same rows in the JAX package and in the
    port; fp32 drops none.  (At the smoke vocabulary of 512 nothing
    underflows; PERF.md, phase 32: the fp16 loss curve's MRE.)"""
    base = dataclasses.replace(get_smoke_config("qwen1p5_0p5b"), vocab_size=151936)
    tokens = np.random.default_rng(4).integers(0, 4096, (2, 512)).astype(np.int32)
    absent = np.setdiff1d(np.arange(base.vocab_size), tokens)
    for dtype in ("float32", "float16"):
        jcfg = dataclasses.replace(base, dtype=dtype)
        tcfg = TConfig(**dataclasses.asdict(jcfg))
        jp, tp = _weights(jcfg)
        jg = jax.grad(lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)},
                                           remat=False)[0])(jp)["embed"]["tok"]
        leaf = tp["embed"]["tok"].requires_grad_()
        loss, _ = TM.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(tokens)}, remat=False)
        tg = torch.autograd.grad(loss, leaf)[0]
        zero = lambda g: np.flatnonzero(np.abs(np.asarray(g, np.float32)).max(-1) == 0)
        jz, tz = zero(jnp.asarray(jg).astype(jnp.float32)), zero(tg.float().numpy())
        if dtype == "float32":
            assert jz.size == tz.size == 0
        else:
            np.testing.assert_array_equal(tz, jz)
            assert np.isin(tz, absent).all() and tz.size >= 0.99 * absent.size


def test_float16_bridge_is_bit_exact():
    bits = np.arange(-2**15, 2**15, 7, dtype=np.int64).astype(np.int16)
    arr = bits.view(np.float16)                      # inf, nan and subnormals among them
    t = bridge.tensor_from_numpy(arr, DEV)
    assert t.dtype == torch.float16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), bits)
