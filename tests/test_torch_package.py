"""Package-level checks of the PyTorch port: its copies of the JAX
package's data modules agree with the originals, it imports nothing of
``jax`` or ``repro``, its weight bridge is bit-exact, it refuses to run
on a missing card unless asked for the CPU, and its serve launcher runs
end to end on the CPU."""
import ast
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models.config import reduced as jreduced
from repro.obs import metrics as jmetrics
from repro_torch import bridge, configs as tconfigs, device as tdevice
from repro_torch.data import pipeline as tpipe
from repro_torch.models.config import reduced as treduced
from repro_torch.obs import metrics as tmetrics

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.mark.parametrize("arch", jconfigs.list_configs())
def test_configs_equal_jax(arch):
    full_j, full_t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(treduced(full_t)) == dataclasses.asdict(jreduced(full_j))
    assert dataclasses.asdict(tconfigs.get_smoke_config(arch)) == \
        dataclasses.asdict(jconfigs.get_smoke_config(arch))
    assert full_t.param_count() == full_j.param_count()


def test_registry_equal_jax():
    assert tconfigs.list_configs() == jconfigs.list_configs()
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    for alias in ("granite-8b", "qwen1.5-0.5b", "zamba2-2.7b", "foo-bar.1"):
        assert tconfigs.canonical(alias) == jconfigs.canonical(alias)


@pytest.mark.parametrize("arch", ["granite_8b", "paligemma_3b", "whisper_base"])
def test_synthetic_tokens_bit_identical(arch):
    cfg_j, cfg_t = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    dj = jpipe.DataConfig(batch_size=3, seq_len=17, seed=7)
    dt = tpipe.DataConfig(**dataclasses.asdict(dj))
    sj, st = jpipe.SyntheticTokens(cfg_j, dj), tpipe.SyntheticTokens(cfg_t, dt)
    for _ in range(3):
        bj, bt = sj.next_batch(), st.next_batch()
        assert bj.keys() == bt.keys()
        for k in bj:
            assert bj[k].dtype == bt[k].dtype
            np.testing.assert_array_equal(bt[k], bj[k])


def test_bf16_bridge_round_trip_bit_exact():
    rng = np.random.default_rng(0)
    bits = rng.integers(-2**15, 2**15, size=(64, 33), dtype=np.int64).astype(np.int16)
    bits[0, :4] = np.array([0x7F80, 0xFF80, 0x7FC0, 0x8000], dtype=np.uint16).view(np.int16)
    arr = bits.view(ml_dtypes.bfloat16)              # inf, -inf, nan, -0.0, ...
    tree = {"blocks": {"w": arr[None]}, "scale": rng.standard_normal(5).astype(np.float32)}
    out = bridge.params_from_numpy(tree, "cpu")
    t = out["blocks"]["w"]
    assert t.dtype == torch.bfloat16 and t.shape == (1, 64, 33)
    np.testing.assert_array_equal(t[0].view(torch.int16).numpy(), bits)
    finite = np.isfinite(arr.astype(np.float32))
    np.testing.assert_array_equal(t[0].float().numpy()[finite],
                                  arr.astype(np.float32)[finite])
    assert out["scale"].dtype == torch.float32
    np.testing.assert_array_equal(out["scale"].numpy(), tree["scale"])
    assert bridge.params_from_numpy(tree, "cpu", torch.float32)["blocks"]["w"].dtype \
        == torch.float32


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _banned(mod):
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_imports_no_jax_or_repro_ast():
    assert len(PORT_FILES) > 20
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    planning = {f"src/repro_torch/{m}.py" for m in (
        "core/chips", "core/profiler", "core/cost_model", "core/schedule",
        "core/resharding", "core/schedules/base", "core/schedules/library",
        "core/schedules/simulator", "core/dataparallel/batch_domain",
        "core/dataparallel/grad_sync", "comm/latency",
        "core/tickprogram", "core/heteroauto", "core/heteropp", "core/tp_rules",
        "comm/p2p",
        "kernels/constraints", "launch/ranks", "analysis/__init__",
        "analysis/diagnostics", "analysis/schedule_safety", "analysis/collectives",
        "analysis/resources", "analysis/kernel_lint", "analysis/plan_verifier",
        "analysis/lint", "obs/__init__", "obs/metrics", "obs/trace", "obs/align",
        "obs/straggler", "obs/validate", "obs/runtime",
        "precision/__init__", "precision/backends", "precision/align")}
    assert planning <= scanned, planning - scanned
    bad = [(p.relative_to(ROOT).as_posix(), m) for p in PORT_FILES
           for m in _imports(p) if _banned(m)]
    assert not bad, bad


def test_port_imports_no_jax_or_repro_at_runtime():
    mods = sorted({".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                   .replace(".__init__", "") for p in PORT_FILES[:-1]})
    code = ("import sys; sys.path.insert(0, %r); import chip_smoke\n"
            "import importlib\n"
            "for m in %r: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(%r), bad); sys.exit(1 if bad else 0)") % (str(ROOT), mods, mods)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdevice.resolve(dev)
    assert tdevice.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        tdevice.resolve("mps")


def test_serve_cpu_smoke_writes_metrics(tmp_path):
    run_dir = tmp_path / "run"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite_8b",
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
         "--gen", "5", "--run-dir", str(run_dir)],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "prefill:" in r.stdout and "decode:" in r.stdout
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert rows[0]["kind"] == "meta" and rows[0]["device"] == "cpu"
    assert rows[0]["schema_version"] == jmetrics.MET_SCHEMA_VERSION
    hist = [r for r in rows if r["kind"] == "histogram"]
    assert hist and hist[-1]["name"] == "decode_latency_s" and hist[-1]["count"] == 4
    assert any(r["kind"] == "metrics" and "decode_tok_per_s" in r for r in rows)


def test_serve_and_chip_smoke_refuse_without_gpu(tmp_path):
    """No card and no CPU request: the launcher raises, and chip_smoke
    exits non-zero without a result, here and alone in a directory."""
    env = _env(CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                        "granite_8b", "--smoke", "--run-dir", str(tmp_path / "r")],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for script in (ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py"):
        r = subprocess.run([sys.executable, str(script)], capture_output=True,
                           text=True, env=env, timeout=120, cwd=tmp_path)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_metrics_copy_matches_jax():
    samples = [0.5, 3.0, 1.0, 2.0, 7.0, 4.0]
    for q in (0.5, 0.95, 1.0):
        assert tmetrics.percentile(sorted(samples), q) == \
            jmetrics.percentile(sorted(samples), q)
    hj, ht = jmetrics.Histogram(), tmetrics.Histogram()
    for s in samples:
        hj.observe(s)
        ht.observe(s)
    assert ht.summary() == hj.summary()
    with pytest.raises(ValueError):
        tmetrics.percentile([], 0.5)
    cj, ct = jmetrics.Counter(), tmetrics.Counter()
    assert [ct.inc(n) for n in (1, 0, 3)] == [cj.inc(n) for n in (1, 0, 3)]
    with pytest.raises(ValueError):
        ct.inc(-1)
    snaps = []
    for m in (jmetrics, tmetrics):
        reg = m.MetricsRegistry()
        reg.counter("steps").inc(3)
        reg.gauge("lr").set(1e-3)
        reg.gauge("unset")
        for s in samples:
            reg.histogram("lat").observe(s)
        snaps.append(reg.snapshot())
    assert snaps[1] == snaps[0] and snaps[1]["steps"] == 3 and "unset" not in snaps[1]


# the port's copies of JAX constants and config dataclasses: (port module,
# JAX module, attribute)
COPIES = [
    ("repro_torch.models.model", "repro.models.model", "LOSS_CHUNK"),
    ("repro_torch.optim.adamw", "repro.optim.adamw", "AdamWConfig"),
    ("repro_torch.checkpointing.io", "repro.checkpointing.io", "_SHARD_BYTES"),
    ("repro_torch.data.pipeline", "repro.data.pipeline", "DataConfig"),
    ("repro_torch.training.serve_step", "repro.training.serve_step", "LONG_THRESHOLD"),
    ("repro_torch.core.profiler", "repro.core.profiler", "BYTES_ACT"),
    ("repro_torch.core.profiler", "repro.core.profiler", "ACT_FACTOR"),
    ("repro_torch.core.profiler", "repro.core.profiler", "ACT_BOUNDARY"),
    ("repro_torch.core.profiler", "repro.core.profiler", "OPT_STEP_TIME"),
    ("repro_torch.core.cost_model", "repro.core.cost_model", "MEM_SAFETY"),
    ("repro_torch.core.cost_model", "repro.core.cost_model", "DEFAULT_BUCKET_BYTES"),
]


@pytest.mark.parametrize("tmod,jmod,attr", COPIES)
def test_copied_constants_equal_jax(tmod, jmod, attr):
    import importlib
    got = getattr(importlib.import_module(tmod), attr)
    want = getattr(importlib.import_module(jmod), attr)
    if dataclasses.is_dataclass(want):
        assert dataclasses.asdict(got()) == dataclasses.asdict(want())
    else:
        assert got == want


def test_make_loader_yields_the_jax_batches():
    cfg_j, cfg_t = jconfigs.get_smoke_config("mamba2_780m"), \
        tconfigs.get_smoke_config("mamba2_780m")
    dj = jpipe.DataConfig(batch_size=2, seq_len=33, seed=5)
    jl = jpipe.make_loader(cfg_j, dj)
    tl = tpipe.make_loader(cfg_t, tpipe.DataConfig(**dataclasses.asdict(dj)),
                           device="cpu")
    try:
        for _ in range(3):
            bj, bt = next(jl), next(tl)
            assert bt["tokens"].dtype == torch.int32
            np.testing.assert_array_equal(bt["tokens"].numpy(), np.asarray(bj["tokens"]))
    finally:
        jl.close()


def test_serve_ssm_cpu_smoke(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mamba2_780m",
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "64",
         "--gen", "5", "--run-dir", str(tmp_path / "run")],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "prefill:" in r.stdout and "decode:" in r.stdout
