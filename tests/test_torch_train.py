"""The port's training path held against the JAX package on the CPU:
forward, loss and every parameter's gradient, the chunked loss, AdamW,
train steps (with and without accumulation), cross-loading checkpoints,
and the single-device train launcher.

Weights and optimizer state come from the JAX package and cross with
``repro_torch.bridge``; batches are numpy-seeded or ``SyntheticTokens``.
Tolerances, fp32 (``conftest.exact_cfg``) unless said otherwise: losses
rtol 2e-5 (the same fp32 sums in another order); gradients atol 1e-4
of each leaf's largest value (they sum over every token, and the SSD
backward differentiates the chunked form where JAX differentiates the
sequential one); parameters after AdamW steps atol 2·lr·steps + 1e-6
(AdamW's step is ~lr whatever the gradient's size, so a near-zero
gradient entry whose sign differs in the last bit moves by up to 2·lr);
bf16 runs the 1.5% loss-trajectory MRE of ``repro/precision/align.py``.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import exact_cfg
from repro.checkpointing import io as jio
from repro.configs import get_smoke_config
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.precision.align import MRE_CRITERION, loss_mre
from repro.training import train_step as JTS
from repro_torch import bridge
from repro_torch.checkpointing import io as tio
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.training import train_step as TTS
from repro_torch.tree import flatten

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEV = torch.device("cpu")
LOSS_RTOL = 2e-5
GRAD_TOL = 1e-4


def _np(x):
    return x.detach().float().numpy().copy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _pair(cfg_or_name, seed=0):
    jcfg = exact_cfg(cfg_or_name) if isinstance(cfg_or_name, str) else cfg_or_name
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("bq", "bk", "bv", "bias", "scale", "conv_b", "D", "dt_bias"):
                t[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    perturb(tree)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tree


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _leaves_close(got_tree, want_tree, tol):
    got, want = flatten(got_tree), flatten(jax.tree.map(np.asarray, want_tree))
    assert got.keys() == want.keys()
    for name in got:
        w = np.asarray(want[name], dtype=np.float32)
        np.testing.assert_allclose(_np(got[name]), w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)


@pytest.mark.parametrize("name", ["mamba2_780m", "qwen1p5_0p5b", "granite_8b"])
def test_loss_and_grads_match_jax(name):
    jcfg, tcfg, jparams, tree = _pair(name, seed=1)
    S = 64 if jcfg.family == "ssm" else 24
    batch = _tokens(jcfg, 2, S, seed=2)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(batch)},
                             backend="einsum"), has_aux=True)(jparams)
    jlogits, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(batch)},
                            backend="einsum")
    tstate = TTS.train_state_from(bridge.params_from_numpy(tree, DEV), {}, 0)
    tb = {"tokens": torch.from_numpy(batch)}
    tlogits, _ = TM.forward(tstate.params, tcfg, tb)
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), rtol=1e-4,
                               atol=1e-4)
    leaves = list(flatten(tstate.params).values())
    tloss, tm = TM.loss_fn(tstate.params, tcfg, tb)
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["ce_loss"]), float(jm["ce_loss"]),
                               rtol=LOSS_RTOL)
    _leaves_close(dict(zip(flatten(tstate.params), grads)),
                  flatten(jgrads), GRAD_TOL)
    # remat changes no gradient
    nograds = torch.autograd.grad(TM.loss_fn(tstate.params, tcfg, tb,
                                             remat=False)[0], leaves)
    for a, b in zip(grads, nograds):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_chunked_ce_long_sequence_matches_jax():
    """S = 2·LOSS_CHUNK, so the chunked (checkpointed) branch runs."""
    assert TM.LOSS_CHUNK == JM.LOSS_CHUNK
    rng = np.random.default_rng(3)
    B, S, d, V = 1, 2 * TM.LOSS_CHUNK, 16, 64
    hid = rng.standard_normal((B, S, d)).astype(np.float32)
    emb = (rng.standard_normal((V, d)) * 0.3).astype(np.float32)
    tgt = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    jval, (jgh, jge) = jax.value_and_grad(
        lambda h, e: JM.chunked_ce({"tok": e}, h, jnp.asarray(tgt), jnp.asarray(mask)),
        argnums=(0, 1))(jnp.asarray(hid), jnp.asarray(emb))
    th = torch.from_numpy(hid).requires_grad_()
    te = torch.from_numpy(emb).requires_grad_()
    tval = TM.chunked_ce({"tok": te}, th, torch.from_numpy(tgt), torch.from_numpy(mask))
    whole = TM._ce_chunk({"tok": te}, th, torch.from_numpy(tgt), torch.from_numpy(mask))
    gh, ge = torch.autograd.grad(tval, (th, te))
    np.testing.assert_allclose(float(tval), float(jval), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tval), float(whole), rtol=LOSS_RTOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), atol=1e-5)
    np.testing.assert_allclose(ge.numpy(), np.asarray(jge), atol=1e-4)


def test_lr_and_adamw_match_jax():
    jcfg_o = jadamw.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=10)
    tcfg_o = tadamw.AdamWConfig(**dataclasses.asdict(jcfg_o))
    assert dataclasses.asdict(tadamw.AdamWConfig()) == \
        dataclasses.asdict(jadamw.AdamWConfig())
    for step in range(12):
        np.testing.assert_allclose(tadamw.lr_at(tcfg_o, step),
                                   float(jadamw.lr_at(jcfg_o, jnp.int32(step))),
                                   rtol=1e-6)
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": {"c": rng.standard_normal(9).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jadamw.init_opt_state(jp)
    tp = bridge.params_from_numpy(params, DEV)
    topt = tadamw.init_opt_state(tp)
    for step in range(4):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * (step + 1)
                                    ).astype(np.float32), params)
        jp, jopt, jm = jadamw.apply_update(jcfg_o, jopt, jax.tree.map(jnp.asarray, g),
                                           jnp.int32(step), jp)
        tp, topt, tm = tadamw.apply_update(tcfg_o, topt, bridge.params_from_numpy(g, DEV),
                                           step, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    _leaves_close(tp, jp, 1e-6)
    _leaves_close(topt, jopt, 1e-6)


def _run_both(jcfg, tcfg, steps, accum=1, seed=0, B=4, S=64, gnorm_rtol=1e-4):
    jstate = JTS.make_train_state(jcfg, jax.random.PRNGKey(seed))
    npstate = jax.tree.map(np.asarray, jstate)
    tstate = bridge.train_state_from_numpy(npstate.params, npstate.opt_state,
                                           npstate.step, DEV)
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    jstep = jax.jit(JTS.make_train_step(jcfg, opt, accum_steps=accum,
                                        backend="einsum"))
    tstep = TTS.make_train_step(tcfg, tadamw.AdamWConfig(**dataclasses.asdict(opt)),
                                accum_steps=accum)
    jl, tl = [], []
    for i in range(steps):
        batch = _tokens(jcfg, B, S, seed=100 + i)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(batch)})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=gnorm_rtol)
    assert tstate.step == int(jstate.step) == steps
    return np.array(jl), np.array(tl), jstate, tstate, opt


@pytest.mark.parametrize("name,accum", [("mamba2_780m", 1), ("qwen1p5_0p5b", 1),
                                        ("mamba2_780m", 2), ("zamba2_2p7b", 1)])
def test_train_steps_match_jax_fp32(name, accum):
    jcfg = exact_cfg(name)
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    jl, tl, jstate, tstate, opt = _run_both(jcfg, tcfg, 3, accum=accum)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    tol = 2 * opt.lr * 3 + 1e-6
    got, want = flatten(tstate.params), flatten(jax.tree.map(np.asarray, jstate.params))
    for k in got:
        np.testing.assert_allclose(_np(got[k]), want[k], rtol=0, atol=tol, err_msg=k)


def test_train_steps_bf16_within_align_mre():
    jcfg = get_smoke_config("mamba2_780m")               # bf16 weights
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    # bf16 keeps ~3 significant digits: the gradient norms agree to 1%
    jl, tl, *_ = _run_both(jcfg, tcfg, 3, gnorm_rtol=1e-2)
    assert np.isfinite(tl).all()
    assert loss_mre(tl, jl) < MRE_CRITERION


def _leaves_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in got:
        g, w = got[k].detach(), np.asarray(want[k])
        if str(w.dtype) == "bfloat16":
            assert g.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16), err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


def test_checkpoints_cross_load(tmp_path):
    jcfg = get_smoke_config("mamba2_780m")               # bf16 params, fp32 state
    jstate = JTS.make_train_state(jcfg, jax.random.PRNGKey(0))
    jstate = JTS.TrainState(jstate.params, jstate.opt_state, jnp.int32(7))
    jio.save_checkpoint(str(tmp_path / "jax"), jstate, step=7)
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    target = TTS.make_train_state(tcfg, torch.Generator().manual_seed(1), device=DEV)
    assert tio.checkpoint_step(str(tmp_path / "jax")) == 7
    tstate = tio.load_checkpoint(str(tmp_path / "jax"), target)
    assert tstate.step == 7
    want = jio._flatten(jstate)
    got = flatten({"0": tstate.params, "1": tstate.opt_state})
    _leaves_equal(got, {k: v for k, v in want.items() if k != "2"})
    assert all(p.requires_grad for p in flatten(tstate.params).values())

    # the port writes (after changing every leaf), JAX loads
    for t in flatten({"0": tstate.params, "1": tstate.opt_state}).values():
        with torch.no_grad():
            t.add_(0.5)
    tstate.step = 9
    tio.save_checkpoint(str(tmp_path / "torch"), tstate, step=9)
    back = jio.load_checkpoint(str(tmp_path / "torch"), jax.eval_shape(lambda: jstate))
    assert int(back.step) == 9 and jio.checkpoint_step(str(tmp_path / "torch")) == 9
    got = flatten({"0": tstate.params, "1": tstate.opt_state})
    _leaves_equal(got, {k: v for k, v in jio._flatten(back).items() if k != "2"})
    with open(tmp_path / "torch" / "index.json") as f:
        jidx = json.load(f)["entries"]
    with open(tmp_path / "jax" / "index.json") as f:
        assert json.load(f)["entries"] == jidx


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_train_launcher_cpu_loss_falls(tmp_path):
    run_dir = tmp_path / "run"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mamba2_780m",
         "--smoke", "--device", "cpu", "--steps", "20", "--batch", "4", "--seq", "64",
         "--log-every", "5", "--run-dir", str(run_dir),
         "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "arch=mamba2-780m-smoke family=ssm params~" in r.stdout
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    steps = [row for row in rows if row["kind"] == "metrics"]
    assert [row["step"] for row in steps] == [1, 5, 10, 15, 20]
    for key in ("tokens_per_s", "tgs", "step_time_s", "peak_bytes_in_use", "loss",
                "ce_loss", "aux_loss", "grad_norm", "lr"):
        assert key in steps[0], key
    first, last = steps[0]["loss"], steps[-1]["loss"]
    assert abs(first - math.log(512)) < 0.3             # near ln(vocab) at init
    assert last < first - 0.3
    assert tio.checkpoint_step(str(tmp_path / "ckpt")) == 20


def test_train_launcher_refuses_pipeline_and_missing_card(tmp_path):
    # the pipeline runs (tests/test_torch_heteropp*.py); tp on the ssm
    # family is refused with the JAX package's words
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "mamba2_780m", "--smoke", "--device", "cpu",
                        "--pipeline-parallel", "2", "--tensor-parallel", "2"],
                       capture_output=True, text=True, env=_env(), timeout=120,
                       cwd=tmp_path)
    assert r.returncode != 0 and "tensor_parallel=2" in r.stderr \
        and "dense decoder blocks only" in r.stderr
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "mamba2_780m", "--smoke", "--steps", "1"],
                       capture_output=True, text=True,
                       env=_env(CUDA_VISIBLE_DEVICES=""), timeout=120, cwd=tmp_path)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_eval_step_matches_loss_without_remat():
    _, tcfg, _, tree = _pair("mamba2_780m", seed=2)
    params = bridge.params_from_numpy(tree, DEV)
    batch = {"tokens": torch.from_numpy(_tokens(tcfg, 2, 32, seed=3))}
    out = TTS.make_eval_step(tcfg)(params, batch)
    loss, _ = TM.loss_fn(params, tcfg, batch, remat=False)
    torch.testing.assert_close(out["loss"], loss)
