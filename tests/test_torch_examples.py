"""The port's examples (``repro_torch.examples``) held against the JAX
package's on the CPU: the same steps on the same seeds, the weights
drawn by the JAX package's init and crossed with ``repro_torch.bridge``,
on the fp32 ``exact_cfg`` variant of each smoke config (``get_smoke_config``
patched in the example's module).

Tolerances: logits, losses and prefill logits 1e-5 (fp32, the same sums
in another order); greedy tokens equal.  ``hetero_search`` plans with the
port's copies of the planning modules, so its output equals the JAX
example's, but for the search's own wall time."""
import ast
import dataclasses
import io
import pathlib
import re
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import exact_cfg
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.data.pipeline import make_loader as jmake_loader
from repro.models import model as JM
from repro.models.config import ModelConfig as JConfig
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.training import serve_step as JSS
from repro.training import train_step as JTS
from repro_torch import bridge
from repro_torch.checkpointing.io import checkpoint_step
from repro_torch.examples import hetero_search, quickstart, serve_batch, train_e2e
from repro_torch.models.config import ModelConfig as TConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEV = torch.device("cpu")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)         # two cores, not all: tier-1 runs files in parallel
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().float().numpy()


def _exact_smoke(monkeypatch, module):
    monkeypatch.setattr(module, "get_smoke_config",
                        lambda name: TConfig(**dataclasses.asdict(exact_cfg(name))))


def _jax_state(cfg, seed=0):
    """The JAX state and its parts as numpy trees."""
    state = JTS.make_train_state(cfg, jax.random.PRNGKey(seed))
    return state, jax.tree.map(np.asarray, state.params), \
        jax.tree.map(np.asarray, state.opt_state)


def _jax_greedy(params, cfg, batch, cache_len, steps, decode=None):
    """The JAX examples' serving: prefill, then ``steps`` greedy tokens."""
    cache, lg, plen = JM.prefill(params, cfg, batch, cache_len=cache_len)
    first = lg
    out = [jnp.argmax(lg, -1).astype(jnp.int32)[:, None]]
    for i in range(steps - 1):
        if decode is None:
            lg, cache = JM.decode_step(params, cfg, out[-1], cache, jnp.int32(plen + i))
            out.append(jnp.argmax(lg, -1).astype(jnp.int32)[:, None])
        else:
            _, tok, cache = decode(params, cache, out[-1], jnp.int32(plen + i))
            out.append(tok)
    return first, np.asarray(jnp.concatenate(out, 1))


@pytest.mark.parametrize("arch", ["granite_8b", "mamba2_780m"])
def test_quickstart_matches_jax(arch, monkeypatch):
    _exact_smoke(monkeypatch, quickstart)
    cfg = exact_cfg(arch)
    jstate, params, opt_state = _jax_state(cfg)
    batch = jax.tree.map(jnp.asarray, JSyntheticTokens(
        cfg, JDataConfig(batch_size=2, seq_len=64)).next_batch())
    jlogits, _ = JM.forward(jstate.params, cfg, batch, remat=False)
    _, jm = jax.jit(JTS.make_train_step(cfg, remat=False))(jstate, batch)
    prompt = {k: v[:, :32] if k == "tokens" else v for k, v in batch.items()}
    _, jtokens = _jax_greedy(jstate.params, cfg, prompt, 48, 8)

    out = quickstart.run(quickstart.parse_args(["--arch", arch, "--device", "cpu"]),
                         params=bridge.params_from_numpy(params, DEV),
                         state=bridge.train_state_from_numpy(params, opt_state, 0, DEV))
    np.testing.assert_allclose(_np(out["logits"]), np.asarray(jlogits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out["loss"], float(jm["loss"]), rtol=TOL)
    np.testing.assert_array_equal(out["tokens"].numpy(), jtokens)
    assert out["tokens"].shape == (2, 8)


@pytest.mark.parametrize("arch", ["mamba2_780m", "granite_8b"])
def test_serve_batch_matches_jax(arch, monkeypatch):
    _exact_smoke(monkeypatch, serve_batch)
    cfg = exact_cfg(arch)
    R, P, G = 2, 16, 6
    jstate, params, _ = _jax_state(cfg)
    batch = jax.tree.map(jnp.asarray, JSyntheticTokens(
        cfg, JDataConfig(batch_size=R, seq_len=P)).next_batch())
    decode, plan = JSS.make_decode_step(cfg, P + G)
    jlogits, jtokens = _jax_greedy(jstate.params, cfg, batch,
                                   max(plan["cache_len"], P + G), G, jax.jit(decode))

    args = serve_batch.parse_args(["--arch", arch, "--requests", str(R), "--prompt-len",
                                   str(P), "--gen", str(G), "--device", "cpu"])
    out = serve_batch.run(args, params=bridge.params_from_numpy(params, DEV))
    np.testing.assert_allclose(_np(out["prefill_logits"]), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(out["tokens"].numpy(), jtokens)
    assert out["prefill_s"] > 0 and out["decode_tok_per_s"] > 0


def _e2e_cut(full):
    """e2e-20m cut to test size: the same family, dtype and head layout."""
    return dict(name="e2e-cut", family="dense", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32")


def test_train_e2e_matches_jax_and_resumes(monkeypatch, tmp_path):
    """Three steps' losses against the JAX example's at 1e-5, its
    checkpoint written (step 3), and the resume check: the restored state
    and the live one take the same step on the seed-99 batch, equal to
    each other exactly and to the JAX example's live state's at 1e-5."""
    monkeypatch.setattr(train_e2e, "model_config", lambda full: TConfig(**_e2e_cut(full)))
    cfg = JConfig(**_e2e_cut(False))
    steps, B, S = 3, 2, 32
    jstate, params, opt_state = _jax_state(cfg)
    step = jax.jit(JTS.make_train_step(
        cfg, JAdamWConfig(lr=6e-4, warmup_steps=20, total_steps=steps), remat=True))
    loader = jmake_loader(cfg, JDataConfig(batch_size=B, seq_len=S))
    try:
        jlosses = []
        for _ in range(steps):
            jstate, m = step(jstate, next(loader))
            jlosses.append(float(m["loss"]))
    finally:
        loader.close()
    src = jmake_loader(cfg, JDataConfig(batch_size=B, seq_len=S, seed=99))
    try:
        _, m = step(jstate, next(src))
    finally:
        src.close()

    args = train_e2e.parse_args(["--steps", str(steps), "--batch", str(B), "--seq", str(S),
                                 "--device", "cpu", "--ckpt", str(tmp_path / "ckpt")])
    out = train_e2e.run(args, state=bridge.train_state_from_numpy(params, opt_state, 0, DEV))
    np.testing.assert_allclose(out["losses"], jlosses, rtol=TOL)
    assert out["resume"][0] == out["resume"][1]
    np.testing.assert_allclose(out["resume"][0], float(m["loss"]), rtol=TOL)
    assert checkpoint_step(str(tmp_path / "ckpt")) == steps
    assert len(out["step_times_s"]) == steps and out["peak_mem_bytes"] is None


def test_hetero_search_prints_the_jax_examples_lines(monkeypatch, tmp_path):
    argv = ["--cluster", "A:8,B:8", "--gbs-mtokens", "0.5", "--model", "qwen1p5_0p5b",
            "--save-plan"]
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import hetero_search as jexample
    finally:
        sys.path.remove(str(ROOT / "examples"))
    outs = []
    for name, call in (("jax", lambda p: jexample.main()),
                       ("torch", lambda p: hetero_search.main(argv + [p]))):
        path = str(tmp_path / f"{name}.json")
        monkeypatch.setattr(sys, "argv", ["hetero_search.py"] + argv + [path])
        buf = io.StringIO()
        with redirect_stdout(buf):
            call(path)
        text = buf.getvalue().replace(path, "PLAN.json")
        # the search's own wall time is the one line that differs
        outs.append(re.sub(r"HeteroAuto plan \(\d+\.\d+s,", "HeteroAuto plan (Ts,", text))
        outs[-1] = (outs[-1], (tmp_path / f"{name}.json").read_text())
    assert "HeteroSpeedupRatio" in outs[0][0] and "plan saved to" in outs[0][0]
    assert outs[1] == outs[0]


@pytest.mark.parametrize("example", [quickstart, serve_batch, train_e2e])
def test_examples_raise_without_a_card(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])


def test_examples_import_no_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch" / "examples").glob("*.py"))
    assert {f.name for f in files} == {"__init__.py", "quickstart.py", "serve_batch.py",
                                       "train_e2e.py", "hetero_search.py"}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level \
                else []
            assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")], \
                (f.name, names)
