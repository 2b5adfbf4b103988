"""The port's HeteroPP (``repro_torch.core.heteropp`` on
``torch.distributed``) held against the JAX package's on the CPU.

In process: the copied tick programs equal the originals array by array;
``from_plan``, ``split_stage_params`` and ``simulate_pipeline_forward``
equal the JAX package's (rtol 1e-4, atol 1e-5 for the forward, the
reference's own tolerance, ``tests/test_heteropp.py:26``); the refusals.

Across ranks (gloo CPU ranks started by ``repro_torch.launch.ranks``;
the rank functions are ``tests/helpers/torch_pipeline_ranks.py``): with
2 ranks, 4 ranks and a split with zero-layer stages, every library
schedule gives the JAX package's ``M.loss_fn`` mean over the
microbatches to 1e-5 rel (fp32, ``conftest.exact_cfg``) and its
``jax.grad`` laid out as stages to 1e-4 of each leaf's largest entry;
gpipe, 1f1b and zb_h1 run one tick program and agree bit for bit, and
the chunked schedules give the same loss bit for bit (as
``tests/helpers/run_spmd_pipeline.py`` holds the JAX pipeline); one
train step leaves the port's single-device step's first moment (to 1e-4
of each leaf's largest entry) and, where the gradient fixes the update's
sign, its update (1e-3 rel), and its parameters within 2·lr + 1e-6 (as
``tests/test_torch_train.py``).  Then the launcher end to end.
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
from repro.core import cost_model as jcm, heteropp as JHP, tickprogram as jtp
from repro.core import chips as jchips
from repro.core.schedules import available_schedules
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core import cost_model as tcm, heteropp as THP, tickprogram as ttp
from repro_torch.launch import ranks
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.training import train_step as TTS
from repro_torch.tree import flatten, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests" / "helpers"))
import torch_pipeline_ranks as W  # noqa: E402

CPU = torch.device("cpu")
SCHEDULES = available_schedules()
SINGLE = ("gpipe", "1f1b", "zb_h1")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    """Keep the parent's torch to two threads beside the other workers
    (ROADMAP: wall-clock tests share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(arch, seed=0):
    """The JAX params of ``exact_cfg(arch)`` with perturbed biases and
    scales, as numpy (for the ranks) and as port tensors."""
    jcfg = exact_cfg(arch)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("bq", "bk", "bv", "bias", "scale", "conv_b", "D", "dt_bias"):
                t[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    perturb(tree)
    return jcfg, TConfig(**dataclasses.asdict(jcfg)), tree


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the copied tick programs
# ---------------------------------------------------------------------------

def _tables_equal(got, want):
    assert got.ticks == want.ticks
    for f in ("mb", "chunk", "src", "active", "emit"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("S,b", [(2, 4), (3, 6), (4, 4), (4, 8)])
@pytest.mark.parametrize("name", SCHEDULES)
def test_tick_tables_equal_jax(name, S, b):
    from repro.core.schedules import get_schedule
    if not get_schedule(name).supports(S, b):
        with pytest.raises(ValueError):
            ttp.spmd_tick_tables(name, S, b)
        return
    _tables_equal(ttp.spmd_tick_tables(name, S, b), jtp.spmd_tick_tables(name, S, b))
    assert (ttp.SRC_INJECT, ttp.SRC_PREV, ttp.SRC_NEXT, ttp.SRC_LOCAL) == \
        (jtp.SRC_INJECT, jtp.SRC_PREV, jtp.SRC_NEXT, jtp.SRC_LOCAL)
    phys = [(i * 7) % 5 for i in range(S)]
    assert ttp.chunk_layer_counts(phys, name) == jtp.chunk_layer_counts(phys, name)
    if get_schedule(name).n_chunks == 1:
        assert ttp.schedule_injection_order(name, S, b) == \
            jtp.schedule_injection_order(name, S, b)
    allocs = (b, max(1, b - 1))
    try:
        want = jtp.domain_tick_tables(name, S, allocs)
    except (ValueError, NotImplementedError) as e:
        with pytest.raises(type(e)):
            ttp.domain_tick_tables(name, S, allocs)
    else:
        _tables_equal(ttp.domain_tick_tables(name, S, allocs), want)


def test_group_layout_and_boundary_tables_equal_jax():
    for stage_tp in ((1, 2), (2, 4, 1), (4, 4)):
        got, want = ttp.group_layout(stage_tp), jtp.group_layout(stage_tp)
        for f in ("stage_of", "rank_of", "tp_of", "offset", "member"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        reshard = tuple("sr_ag" if i % 2 else "naive" for i in range(len(stage_tp) - 1))
        for a, b in zip(ttp.boundary_tables(got, reshard, 16),
                        jtp.boundary_tables(want, reshard, 16)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# specs, layouts, the oracle
# ---------------------------------------------------------------------------

def _plan(schedule, layers=(10, 14), recompute=(True, False), pp=(1, 1), mb=4):
    g = lambda n, c: jchips.ChipGroup(jchips.CHIPS[n], c)
    jplan = jcm.ParallelPlan(
        [jcm.StagePlan(g("A", pp[0]), 1, pp[0], layers[0], recompute[0]),
         jcm.StagePlan(g("B", pp[1]), 1, pp[1], layers[1], recompute[1])],
        dp=1, microbatches=mb, schedule=schedule)
    return jplan, tcm.ParallelPlan.from_dict(jplan.to_dict())


@pytest.mark.parametrize("schedule,layers,pp", [
    ("1f1b", (12, 12), (1, 1)),          # uniform
    ("1f1b", (10, 14), (1, 1)),          # non-uniform
    ("zb_h1", (9, 15), (2, 1)),          # a stage type with two stages
    ("zb_v", (10, 14), (1, 1)),
    ("interleaved", (11, 13), (1, 1)),
    ("wave", (10, 14), (1, 1)),
])
def test_from_plan_equal_jax(schedule, layers, pp):
    jplan, tplan = _plan(schedule, layers, pp=pp)
    for mb in (None, 4, 8):
        want = JHP.from_plan(jplan, microbatches=mb)
        got = THP.from_plan(tplan, microbatches=mb)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        # a pipe-only plan executes with execute_tp / execute_dp too
        got = THP.from_plan(tplan, microbatches=mb, execute_tp=True, execute_dp=True)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            JHP.from_plan(jplan, microbatches=mb, execute_tp=True, execute_dp=True))


def test_from_plan_refusals():
    # the verifier's refusal, in both: interleaved needs b % S == 0
    jplan, tplan = _plan("interleaved", mb=3)
    with pytest.raises(ValueError) as jerr:
        JHP.from_plan(jplan)
    with pytest.raises(ValueError) as terr:
        THP.from_plan(tplan)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    # uniform tp and dp, non-uniform tp (a grouped spec, its reshard
    # chosen per boundary) and an uneven batch domain all build the JAX
    # package's spec
    g = lambda n, c: jchips.ChipGroup(jchips.CHIPS[n], c)
    for stages, dp, domain in (([(2, 1), (2, 1)], 1, None),
                               ([(1, 1), (1, 1)], 2, None),
                               ([(1, 1), (2, 1)], 1, None),
                               ([(4, 1), (2, 2)], 1, None),
                               ([(1, 1), (1, 1)], 2, (4, 3))):
        jplan = jcm.ParallelPlan(
            [jcm.StagePlan(g("A", tp * pp * dp), tp, pp, 12, True)
             for (tp, pp) in stages[:1]]
            + [jcm.StagePlan(g("B", tp * pp * dp), tp, pp, 12, True)
               for (tp, pp) in stages[1:]], dp=dp, microbatches=4, batch_domain=domain)
        want = JHP.from_plan(jplan, execute_tp=True, execute_dp=True, verify=False)
        tplan = tcm.ParallelPlan.from_dict(jplan.to_dict())
        got = THP.from_plan(tplan, execute_tp=True, execute_dp=True, verify=False)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.grouped == want.grouped and got.batch_domain == want.batch_domain
        # as cost-model dimensions (the defaults) both lay out the split
        assert dataclasses.asdict(THP.from_plan(tplan, verify=False)) == \
            dataclasses.asdict(JHP.from_plan(jplan, verify=False))


def test_spec_checks_and_refusals():
    with pytest.raises(ValueError, match="allocations"):
        THP.PipelineSpec(2, (1, 1), 4, data_parallel=2, batch_domain=(4,))
    with pytest.raises(ValueError, match="stage_tp"):
        THP.PipelineSpec(2, (1, 1), 4, stage_tp=(1, 2, 3))
    # uniform tp and dp are accepted, with the JAX package's fields
    for kw in (dict(tensor_parallel=2), dict(data_parallel=2, bucket_bytes=8)):
        assert dataclasses.asdict(THP.PipelineSpec(2, (1, 1), 4, **kw)) == \
            dataclasses.asdict(JHP.PipelineSpec(2, (1, 1), 4, **kw))
    # uneven batch domains and grouped tp too, with its default reshard
    for kw in (dict(data_parallel=2, batch_domain=(4, 3)), dict(stage_tp=(1, 2)),
               dict(data_parallel=2, batch_domain=(4, 4))):
        got, want = THP.PipelineSpec(2, (1, 1), 4, **kw), JHP.PipelineSpec(2, (1, 1), 4, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.stage_tps, got.pipe_width, got.batch_allocations,
                got.total_microbatches) == (want.stage_tps, want.pipe_width,
                                            want.batch_allocations, want.total_microbatches)
    # tp on an ssm block kind: the JAX package's refusal, word for word
    with pytest.raises(NotImplementedError) as terr:
        THP.validate_spec_tp(tsmoke("mamba2_780m"),
                             THP.PipelineSpec(2, (1, 1), 4, tensor_parallel=2))
    with pytest.raises(NotImplementedError) as jerr:
        JHP.validate_tensor_parallel(exact_cfg("mamba2_780m"), 2)
    assert str(terr.value) == str(jerr.value)


def test_hybrid_moe_and_other_families_refused():
    with pytest.raises(NotImplementedError, match="hybrid.*ROADMAP C"):
        THP.pipeline_block_kind(tsmoke("zamba2_2p7b"))
    with pytest.raises(NotImplementedError, match="A11"):
        THP.pipeline_block_kind(tsmoke("qwen3_moe_30b_a3b"))
    with pytest.raises(NotImplementedError, match="A12"):
        THP.pipeline_block_kind(tsmoke("paligemma_3b"))
    assert THP.pipeline_block_kind(tsmoke("granite_8b")) == "dense"
    assert THP.pipeline_block_kind(tsmoke("mamba2_780m")) == "ssm"


@pytest.mark.parametrize("arch,phys,schedule", [
    ("granite_8b", (1, 1), "1f1b"),
    ("granite_8b", (2, 0), "1f1b"),
    ("granite_8b", (1, 1), "zb_v"),
    ("mamba2_780m", (1, 1), "1f1b"),
    ("mamba2_780m", (0, 2), "interleaved"),
])
def test_split_stage_params_equal_jax(arch, phys, schedule):
    jcfg, tcfg, tree = _pair(arch)
    spec_t = W.schedule_spec(schedule, phys, 4)
    spec_j = JHP.PipelineSpec(**dataclasses.asdict(spec_t))
    want, wmask = JHP.split_stage_params(jax.tree.map(jnp.asarray, tree), jcfg, spec_j)
    got, gmask = THP.split_stage_params(bridge.params_from_numpy(tree, CPU), tcfg, spec_t)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    fw, fg = flatten(jax.tree.map(np.asarray, want)), flatten(got)
    assert fw.keys() == fg.keys()
    for k in fw:
        np.testing.assert_array_equal(_np(fg[k]), fw[k], err_msg=k)
    for s in range(spec_t.num_stages):
        np.testing.assert_array_equal(THP.stage_mask(spec_t, s).numpy(),
                                      np.asarray(wmask[s]))


@pytest.mark.parametrize("arch,phys,schedule", [
    ("granite_8b", (1, 1), "1f1b"),
    ("granite_8b", (2, 0), "1f1b"),
    ("granite_8b", (1, 1), "zb_v"),
    ("mamba2_780m", (1, 1), "1f1b"),
    ("mamba2_780m", (1, 1), "wave"),
])
def test_simulate_pipeline_forward_equal_jax(arch, phys, schedule):
    jcfg, tcfg, tree = _pair(arch)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    spec_t = W.schedule_spec(schedule, phys, 2)
    spec_j = JHP.PipelineSpec(**dataclasses.asdict(spec_t))
    want, _ = JHP.simulate_pipeline_forward(jax.tree.map(jnp.asarray, tree), jcfg, spec_j,
                                            {"tokens": jnp.asarray(tokens)})
    params = bridge.params_from_numpy(tree, CPU)
    with torch.no_grad():
        got, _ = THP.simulate_pipeline_forward(params, tcfg, spec_t,
                                               {"tokens": torch.from_numpy(tokens)})
        mono, _ = TM.forward(params, tcfg, {"tokens": torch.from_numpy(tokens)}, remat=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got, mono, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# gloo CPU ranks
# ---------------------------------------------------------------------------

RANK_CASES = {
    # (arch, physical split, per-stage recompute, train step)
    "granite-2-ranks": ("granite_8b", (1, 1), (True, False), True),
    "granite-4-ranks-zero-layer-stages": ("granite_8b", (1, 0, 0, 1), (), False),
    "mamba2-2-ranks": ("mamba2_780m", (1, 1), (False, True), True),
}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _jax_reference(jcfg, tree, tokens):
    """The mean of the JAX package's ``M.loss_fn`` over the microbatches
    and its gradient: every microbatch counts the same tokens, so that
    mean is ``M.loss_fn`` of the whole batch (one jitted call)."""
    full = jnp.asarray(tokens.reshape(-1, tokens.shape[-1]))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": full}, backend="einsum")[0]))(
        jax.tree.map(jnp.asarray, tree))
    return float(loss), grads


def _stacked(results, name):
    """The ranks' gradient trees as the stage layout: block leaves stacked
    over ranks, the replicated leaves (equal on every rank) once."""
    trees = [r[name]["grads"] for r in results]
    for t in trees[1:]:
        for a, b in zip(flatten({k: t[k] for k in ("embed", "final_norm")}).values(),
                        flatten({k: trees[0][k] for k in ("embed", "final_norm")}).values()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    return {"blocks": tree_map(lambda *ls: torch.stack(ls), *[t["blocks"] for t in trees]),
            "embed": trees[0]["embed"], "final_norm": trees[0]["final_norm"]}


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_pipeline_ranks_match_jax(case, tmp_path):
    arch, phys, recompute, train = RANK_CASES[case]
    jcfg, tcfg, tree = _pair(arch, seed=2)
    b, mb, S = 4, 2, 32
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (b, mb, S)).astype(np.int64)
    res = ranks.spawn(W.loss_and_grads, len(phys),
                      (dataclasses.asdict(tcfg), tree, tokens, phys, SCHEDULES, recompute,
                       OPT if train else None),
                      workdir=str(tmp_path), threads=1, timeout=300)
    want_loss, jgrads = _jax_reference(jcfg, tree, tokens.astype(np.int32))
    first = res[0]["1f1b"]
    for name in SCHEDULES:
        losses = {r[name]["loss"] for r in res}
        assert losses == {first["loss"]}, (name, losses)     # chunked ones too
        spec = W.schedule_spec(name, phys, b, recompute)
        want, _ = JHP.split_stage_params(jgrads, jcfg,
                                         JHP.PipelineSpec(**dataclasses.asdict(spec)))
        fw, fg = flatten(jax.tree.map(np.asarray, want)), flatten(_stacked(res, name))
        assert fw.keys() == fg.keys()
        for k in fw:
            np.testing.assert_allclose(_np(fg[k]), fw[k], rtol=0,
                                       atol=GRAD_TOL * max(np.abs(fw[k]).max(), 1e-6),
                                       err_msg=f"{name} {k}")
        if name in SINGLE:
            for k, v in flatten(_stacked(res, "1f1b")).items():
                torch.testing.assert_close(fg[k], v, rtol=0, atol=0)
    assert abs(first["loss"] - want_loss) / abs(want_loss) < LOSS_RTOL
    assert res[0]["1f1b"]["ticks"] == b + len(phys) - 1
    if not train:
        return
    # one train step against the port's single-device step on the same
    # weights and microbatches (the whole batch at once)
    state = TTS.train_state_from(bridge.params_from_numpy(tree, CPU), None, 0)
    state.opt_state = tadamw.init_opt_state(state.params)
    step = TTS.make_train_step(tcfg, tadamw.AdamWConfig(**OPT))
    state, m = step(state, {"tokens": torch.from_numpy(tokens.reshape(b * mb, S))})
    spec = W.schedule_spec(SCHEDULES[0], phys, b, recompute)
    staged = lambda tree: flatten(THP.split_stage_params(tree, tcfg, spec)[0])
    ranked = lambda key: flatten({
        "blocks": tree_map(lambda *ls: torch.stack(ls), *[r["train"][key]["blocks"] for r in res]),
        "embed": res[0]["train"][key]["embed"],
        "final_norm": res[0]["train"][key]["final_norm"]})
    p0 = staged(bridge.params_from_numpy(tree, CPU))
    want_m, got_m = staged(state.opt_state["m"]), ranked("m")
    want, got, got_master = staged(state.params), ranked("params"), ranked("master")
    for k, mk in want_m.items():
        # m = (1 - b1)·clipped g: the gradient and the clip reached the state
        torch.testing.assert_close(got_m[k], mk, rtol=0,
                                   atol=GRAD_TOL * max(float(mk.abs().max()), 1e-12), msg=k)
        # the update reached the parameters; where m is well above rounding
        # its sign is fixed and the update equals the single device's
        torch.testing.assert_close(got[k], got_master[k], rtol=0, atol=0, msg=k)
        sure = mk.abs() > 1e-3 * float(mk.abs().max())
        assert sure.any(), k
        torch.testing.assert_close((got[k] - p0[k])[sure], (want[k] - p0[k])[sure],
                                   rtol=1e-3, atol=0, msg=k)
        torch.testing.assert_close(got[k], want[k], rtol=0,
                                   atol=2 * OPT["lr"] + 1e-6, msg=k)
    assert abs(res[0]["train"]["loss"] - float(m["loss"])) / float(m["loss"]) < LOSS_RTOL
    assert math.isclose(res[0]["train"]["grad_norm"], float(m["grad_norm"]), rel_tol=1e-4)


def test_a_failing_rank_fails_the_spawn(tmp_path):
    """Rank 1 raises while rank 0 waits on it in a barrier: the spawn
    raises rank 1's error instead of hanging."""
    with pytest.raises(Exception, match="rank 1 fails"):
        ranks.spawn(W.failing_rank, 2, workdir=str(tmp_path), threads=1, timeout=120)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


TRAIN = ["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu", "--steps", "3",
         "--batch", "4", "--seq", "32", "--log-every", "1"]


def _metrics(run_dir):
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return rows[0], [row["loss"] for row in rows if row["kind"] == "metrics"]


@pytest.fixture
def fp32_launcher(monkeypatch):
    """``launch.train`` on the fp32 smoke config, where the pipeline and
    the single device agree to 1e-5 (the spawned ranks get the config
    from the launcher)."""
    from repro_torch.launch import train
    monkeypatch.setattr(train, "get_smoke_config", W.fp32_smoke_config)
    return train


def test_pipeline_launcher_matches_single_device(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.train --pipeline-parallel 2 --p2p
    host`` as a command, on the bfloat16 smoke config: its first loss is
    the single-device launcher's (later steps drift by bfloat16 rounding,
    and three bfloat16 steps need not fall).  Then through ``main`` on the
    fp32 smoke config, the even split, ``--plan`` (non-uniform zb_v,
    recompute on one stage) and ``--search``: the losses of three steps
    fall and equal the single-device launcher's on the same seed."""
    from repro_torch.launch import train
    run_dir = tmp_path / "pp"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *TRAIN,
                        "--pipeline-parallel", "2", "--p2p", "host", "--run-dir",
                        str(run_dir)],
                       capture_output=True, text=True, env=_env(), timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "pipeline: stages=2 v=1 layers/global-stage=(1, 1)" in r.stdout
    assert r.stdout.count("step ") == 3
    meta, got = _metrics(run_dir)
    assert meta["mode"] == "pipeline" and meta["stages"] == 2 and meta["p2p"] == "host"
    assert all(map(math.isfinite, got))
    first = train.main(TRAIN + ["--steps", "1", "--run-dir", str(tmp_path / "bf16")])
    np.testing.assert_allclose(got[0], first["losses"][0], rtol=LOSS_RTOL)

    monkeypatch.setattr(train, "get_smoke_config", W.fp32_smoke_config)
    want = train.main(TRAIN + ["--run-dir", str(tmp_path / "single")])["losses"]
    assert all(map(math.isfinite, want)) and want[-1] < want[0]
    res = train.main(TRAIN + ["--pipeline-parallel", "2", "--p2p", "host",
                              "--run-dir", str(tmp_path / "even")])
    np.testing.assert_allclose(res["losses"], want, rtol=LOSS_RTOL)

    _, tplan = _plan("zb_v", layers=(1, 1), recompute=(False, True), mb=2)
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(tplan.to_dict()))
    res = train.main(TRAIN + ["--plan", str(path), "--p2p", "host",
                              "--run-dir", str(tmp_path / "plan")])
    meta, got = _metrics(tmp_path / "plan")
    assert meta["schedule"] == "zb_v" and meta["layers_per_stage"] == [1, 1, 0, 0]
    assert meta["recompute"] == [False, True] and meta["microbatches"] == 2
    assert got == res["losses"] and res["mode"] == "pipeline" and res["ticks"] == 6
    assert len(res["peak_mem_bytes_per_rank"]) == 2
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)

    res = train.main(TRAIN + ["--search", "A:1,B:1", "--p2p", "host",
                              "--run-dir", str(tmp_path / "search")])
    assert "searched plan" in capsys.readouterr().out
    np.testing.assert_allclose(res["losses"], want, rtol=LOSS_RTOL)


def test_pipeline_launcher_joins_a_torchrun_job(tmp_path, fp32_launcher):
    """A job started outside the launcher, as torchrun starts one: each
    process has joined the group (here through a ``file://`` store) and
    calls ``main``, which runs that process's rank.  Two processes train
    what one command trains: rank 0 logs, and the losses equal the
    single device's."""
    argv = TRAIN + ["--pipeline-parallel", "2", "--p2p", "host",
                    "--run-dir", str(tmp_path / "job")]
    res = ranks.spawn(W.launcher_rank, 2, (argv,), workdir=str(tmp_path / "store"),
                      threads=1, timeout=300)
    assert [r["rank"] for r in res] == [0, 1] and {r["mode"] for r in res} == {"pipeline"}
    meta, got = _metrics(tmp_path / "job")
    assert meta["mode"] == "pipeline" and meta["devices"] == 2
    assert got == res[0]["losses"] == res[1]["losses"]
    want = fp32_launcher.main(TRAIN + ["--run-dir", str(tmp_path / "single")])["losses"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("flags,message", [
    (["--pipeline-parallel", "2", "--grad-sync", "psum"], "needs --data-parallel"),
    (["--pipeline-parallel", "2", "--data-parallel", "2", "--bucket-bytes", "1000"],
     "only shapes the psum"),
    (["--arch", "mamba2_780m", "--pipeline-parallel", "2", "--tensor-parallel", "2"],
     "dense decoder blocks only"),
    (["--plan", "p.json", "--data-parallel", "2"], "sets dp from the plan"),
    (["--trace"], "--pipeline-parallel"),
    (["--plan", "p.json", "--search", "A:1,B:1"], "mutually exclusive"),
    (["--plan", "p.json", "--schedule", "zb_v"], "plan's schedule"),
    (["--search", "A:1,B:1", "--pipeline-parallel", "2"], "stage count from the plan"),
    (["--schedule", "zb_v"], "only apply to the pipeline"),
    (["--pipeline-parallel", "2", "--accum", "2"], "--accum"),
    (["--pipeline-parallel", "2"], "--p2p host"),
    (["--pipeline-parallel", "2", "--p2p", "device"], "--p2p host"),
])
def test_launcher_refusals(flags, message):
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match=message):
        train.main(["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu", *flags])
