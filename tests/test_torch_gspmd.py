"""The port's (data, model) grid path held against the JAX package on the
CPU: ``repro_torch.sharding.spmd`` (the GSPMD train step written with
explicit collectives), ``repro_torch.training.manual_dp`` (ZeRO-1) and
the launcher's ``--model-parallel`` branch, on gloo CPU ranks started by
``repro_torch.launch.ranks`` (rank functions in
``tests/helpers/torch_gspmd_ranks.py``), one spawn of four ranks and one
of two.

Reference: the JAX package's single-device ``make_train_step``, whose
loss GSPMD preserves, on fp32 ``conftest.exact_cfg`` smoke configs from
the same weights (``M.init_params``, biases and scales perturbed) and the
same numpy batches.  Each grid's first-step loss within 1e-5 relative,
grad norm within 1e-4, every parameter after the step within 5e-4 and
the second step's loss within 1e-4: ``tests/helpers/run_manual_dp.py``'s
tolerances or tighter.  Cases: the 2 x 2 grid on granite (GQA),
qwen1.5 and paligemma (one kv head, which both members' query heads
share) with ``accum_steps`` 2, granite and qwen1.5 under GSPMD and
ZeRO-1; model 1 x data 2 on moe, ssm, hybrid, audio and vlm (the model
axis of those families: ``tests/test_torch_gspmd_families.py``).  Each rank's blocks from the seeded
initialisation equal the JAX rules' slices of the single-device state,
and its bytes their closed form; a checkpoint written from the grid
resumes on one device and on a (4, 1) grid to the same next loss; the
``DataLoader`` yields the JAX loader's batches and surfaces a worker's
failure; the launcher's ``main`` trains the grid, at a model axis that does not
divide a count its members split too (that part computed whole and
named), and refuses what it cannot run.
"""
import dataclasses
import json
import pathlib
import sys
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import exact_cfg
from repro.configs import get_smoke_config as jsmoke
from repro.data import pipeline as jpipe
from repro.optim import adamw as JA
from repro.sharding import rules as jrules
from repro.training import manual_dp as jmdp, train_step as JTS
from repro_torch.checkpointing.io import load_checkpoint
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import dryrun, ranks, train
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.shapes import InputShape
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.training import train_step as TTS
from repro_torch.tree import flatten
from test_torch_heteropp import _pair

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests" / "helpers"))
import torch_gspmd_ranks as W  # noqa: E402

CPU = torch.device("cpu")
B, SEQ = 8, 32
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
LOSS_RTOL, GNORM_RTOL, PARAM_ATOL, LOSS2_RTOL = 1e-5, 1e-4, 5e-4, 1e-4
GRID_CASES = [("granite", "granite_8b", 2, 2, 2, "gspmd"),
              ("qwen", "qwen1p5_0p5b", 2, 2, 2, "gspmd"),
              ("paligemma", "paligemma_3b", 2, 2, 2, "gspmd"),
              ("granite-zero1", "granite_8b", 2, 2, 2, "manual"),
              ("qwen-zero1", "qwen1p5_0p5b", 2, 2, 2, "manual")]
# seeded-initialisation cases: (arch, bf16 smoke config or fp32, placement)
INITS = {"granite": ("granite_8b", False, "gspmd"),
         "qwen-zero1": ("qwen1p5_0p5b", False, "manual"),
         "zamba2": ("zamba2_2p7b", False, "gspmd"),
         "qwen-bf16": ("qwen1p5_0p5b", True, "gspmd")}
FAMILY_CASES = [(arch, arch, 1, 2, 1, "gspmd") for arch in
                ("qwen3_moe_30b_a3b", "mamba2_780m", "zamba2_2p7b", "whisper_base",
                 "paligemma_3b")]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _init_cfgs(arch, bf16):
    """(JAX config, port config) of a seeded-initialisation case."""
    jcfg = jsmoke(arch) if bf16 else exact_cfg(arch)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _batches(jcfg, seed, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, jcfg.vocab_size, (B, SEQ)).astype(np.int32)}
        if jcfg.family == "vlm":
            b["image_embeds"] = rng.standard_normal(
                (B, jcfg.num_prefix_tokens, jcfg.d_model)).astype(np.float32)
        if jcfg.family == "audio":
            b["audio_embeds"] = rng.standard_normal(
                (B, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _jax_run(jcfg, tree, batches, accum):
    """The JAX package's single-device steps: each step's metrics and the
    parameters after the first."""
    params = jax.tree.map(jnp.asarray, tree)
    state = JTS.TrainState(params, JA.init_opt_state(params), jnp.zeros((), jnp.int32))
    step = jax.jit(JTS.make_train_step(jcfg, JA.AdamWConfig(**OPT), accum_steps=accum,
                                       backend="einsum"))
    metrics, params1 = [], None
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            params1 = flatten(jax.tree.map(np.asarray, state.params))
    return metrics, params1


def _case_jobs(cases):
    jobs, refs = [], {}
    for name, arch, model, data, accum, mode in cases:
        jcfg, tcfg, tree = _pair(arch)
        batches = _batches(jcfg, len(refs))
        refs[name] = (jcfg, tree, batches, accum)
        jobs.append((name, dataclasses.asdict(tcfg), tree, batches, model, data, accum, mode))
    return jobs, refs


def _spawn(world, jobs, tmp):
    return ranks.spawn(W.run_all, world, (jobs,), workdir=str(tmp), timeout=300, threads=1)


@pytest.fixture(scope="module")
def grid4(tmp_path_factory):
    """One spawn of four ranks: the 2 x 2 cases, the seeded blocks, the
    checkpoint round trip and the launcher."""
    tmp = tmp_path_factory.mktemp("grid4")
    cases, refs = _case_jobs(GRID_CASES)
    inits = [(name, dataclasses.asdict(_init_cfgs(arch, bf16)[1]), 2, 2, mode, 3)
             for name, (arch, bf16, mode) in INITS.items()]
    jcfg, tcfg, tree = _pair("qwen1p5_0p5b")
    ck = (dataclasses.asdict(tcfg), tree, _batches(jcfg, 7), OPT, str(tmp / "ckpt"))
    run_dir = str(tmp / "run")
    argv = ["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu", "--model-parallel",
            "2", "--p2p", "host", "--steps", "2", "--batch", "4", "--seq", "32",
            "--log-every", "1", "--run-dir", run_dir]
    jobs = [("cases", "train_cases", (cases, OPT)), ("init", "init_blocks", (inits,)),
            ("ckpt", "checkpoint_case", ck),
            ("launcher", "launcher", (argv, dataclasses.asdict(tcfg))),
            ("scatter", "reduce_scatter_case", ())]
    return _spawn(4, jobs, tmp / "ranks"), refs, inits, ck, (argv, tcfg)


@pytest.fixture(scope="module")
def grid2(tmp_path_factory):
    """One spawn of two ranks: model 1 x data 2 on every other family."""
    cases, refs = _case_jobs(FAMILY_CASES)
    return _spawn(2, [("cases", "train_cases", (cases, OPT))],
                  tmp_path_factory.mktemp("grid2") / "ranks"), refs


def _hold(outs, refs, name, ref=None):
    """Case ``name`` of every rank held to ``ref`` (each step's metrics and
    the parameters after the first), by default the JAX package's
    single-device steps; an auxiliary metric the reference does not
    report is not held."""
    jcfg, tree, batches, accum = refs[name]
    want, p1 = ref or _jax_run(jcfg, tree, batches, accum)
    got = [o["cases"][name]["metrics"] for o in outs]
    for r in got:                       # every rank reports the same metrics
        assert r == got[0]
    got = got[0]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-9)
    assert rel(got[0]["loss"], want[0]["loss"]) < LOSS_RTOL, (got[0], want[0])
    assert rel(got[0]["grad_norm"], want[0]["grad_norm"]) < GNORM_RTOL, (got[0], want[0])
    assert rel(got[1]["loss"], want[1]["loss"]) < LOSS2_RTOL, (got[1], want[1])
    mine = outs[0]["cases"][name]["params1"]
    assert set(mine) == set(p1)
    worst = max(float(np.max(np.abs(mine[k].float().numpy() - p1[k].astype(np.float32))))
                for k in p1)
    assert worst < PARAM_ATOL, worst
    for k in ("aux_loss", "ce_loss"):
        if k not in want[0]:
            continue
        assert rel(got[0][k], want[0][k]) < LOSS_RTOL or abs(got[0][k] - want[0][k]) < 1e-7
    for o in outs:
        assert o["cases"][name]["state_bytes"] == o["cases"][name]["block_bytes"]


@pytest.mark.parametrize("name", [c[0] for c in GRID_CASES])
def test_grid_2x2_matches_jax_single_device(grid4, name):
    outs, refs, *_ = grid4
    _hold(outs, refs, name)
    stats = outs[0]["cases"][name]["stats"]
    if name.endswith("zero1"):
        # one reduce-scatter and one all-gather a parameter over data, at
        # step end; the layers' gathers run over model only
        assert stats["data_scatter_bytes"] > 0 and stats["data_gather_bytes"] > 0
    else:
        assert stats["data_gather_bytes"] > 0 and stats["model_gather_bytes"] > 0
    assert stats["model_reduce_bytes"] > 0        # the Megatron all-reduces


@pytest.mark.parametrize("name", [c[0] for c in FAMILY_CASES])
def test_model1_data2_matches_jax_single_device(grid2, name):
    outs, refs = grid2
    _hold(outs, refs, name)


def _hold_standin(outs, refs, case):
    """The dry-run's estimate of each rank of ``case`` (its counting
    stand-in grid on the meta device) against what that gloo rank
    counted in its last step: every collective's bytes and calls by
    axis and kind, its persistent bytes and its optimizer bytes, exactly."""
    name, _, model, data, accum, mode = case
    jcfg = refs[name][0]
    mesh = Mesh.of((data, model), ("data", "model"))
    for o in outs:
        got = o["cases"][name]
        rec = dryrun.estimate(TConfig(**dataclasses.asdict(jcfg)), mesh,
                              InputShape(name, "train", SEQ, B), rank=got["coord"],
                              accum=accum, dp_mode=mode)
        assert rec["collectives"] == dryrun.collectives(got["stats"]), got["coord"]
        assert rec["state_bytes"] == got["state_bytes"] == rec["block_bytes"]
        if mode == "manual":
            assert rec["optimizer_bytes"] == got["opt_bytes"] == rec["optimizer_closed"]


@pytest.mark.parametrize("name", [c[0] for c in GRID_CASES])
def test_standin_counts_the_2x2_ranks_collectives(grid4, name):
    outs, refs, *_ = grid4
    _hold_standin(outs, refs, next(c for c in GRID_CASES if c[0] == name))


@pytest.mark.parametrize("name", [c[0] for c in FAMILY_CASES])
def test_standin_counts_the_data2_ranks_collectives(grid2, name):
    outs, refs = grid2
    _hold_standin(outs, refs, next(c for c in FAMILY_CASES if c[0] == name))


@pytest.mark.parametrize("members", [3, 4])
def test_host_reduce_scatter_sums_in_member_order(grid4, members):
    """``--p2p host``'s reduce-scatter (an all-to-all of each member's
    slices, summed where they arrive) at three and four members: each
    member's slice is the sum of every member's slice taken in member
    order, in fp32 for bf16 tensors and rounded back once, bit for bit,
    and within that order's rounding of the exact sum."""
    outs = grid4[0]
    for dtype in (torch.float32, torch.bfloat16):
        for dim in (0, 1):
            parts = [W.member_tensor(r, members, dim, dtype).chunk(members, dim)
                     for r in range(members)]
            for rank in range(members):
                got = outs[rank]["scatter"][f"{members}/{dtype}/{dim}"]
                acc = parts[0][rank].float() if dtype == torch.bfloat16 \
                    else parts[0][rank].clone()
                for r in range(1, members):
                    acc += parts[r][rank]
                assert torch.equal(got, acc.to(dtype)), (members, dtype, dim, rank)
                exact = sum(p[rank].double() for p in parts)
                size = sum(p[rank].double().abs() for p in parts)
                eps = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -23 * members
                assert bool(((got.double() - exact).abs() <= eps * size).all()), \
                    (members, dtype, dim, rank)
    for o in outs[members:]:
        assert not any(k.startswith(f"{members}/") for k in o["scatter"])


def _slice(t, spec, coord, sizes):
    for dim, entry in enumerate(spec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        n, idx = 1, 0
        for a in axes:
            n, idx = n * sizes[a], idx * sizes[a] + coord[a]
        w = t.shape[dim] // n
        t = t.narrow(dim, idx * w, w)
    return t


@pytest.fixture
def duck_specs(monkeypatch):
    monkeypatch.setattr(jrules, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jmdp, "NamedSharding", lambda mesh, spec: spec)

    @dataclasses.dataclass(frozen=True)
    class Mesh:
        axis_names: tuple
        shape: dict

    return Mesh(("data", "model"), {"data": 2, "model": 2})


def test_seeded_blocks_equal_the_rules_slices(grid4, duck_specs):
    """``spmd.init_state`` on each rank equals the JAX rules' blocks of
    the single-device ``make_train_state`` with the same seed, bit for
    bit, and each rank's bytes the closed form over the JAX specs."""
    outs, _, inits, *_ = grid4
    mesh = duck_specs
    for name, fields, model, data, mode, seed in inits:
        jcfg, tcfg = _init_cfgs(*INITS[name][:2])
        full = TTS.make_train_state(tcfg, torch.Generator().manual_seed(seed), device=CPU)
        if mode == "manual":
            js = jmdp.make_manual_dp_train_step(jcfg, mesh)[1]
        else:
            js = jrules.train_state_shardings(JTS.abstract_train_state(jcfg), mesh,
                                              hybrid=jcfg.family == "hybrid")
        spec = lambda tree: flatten(jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec)))
        pspecs = spec(js.params)
        ospecs = {k: spec(js.opt_state[k]) for k in ("master", "m", "v")}
        for o in outs:
            got = o["init"][name]
            d, k = got["coord"]
            coord = {"data": d, "model": k}
            closed = 0
            for path, t in flatten(full.params).items():
                want = _slice(t, pspecs[path], coord, mesh.shape)
                assert torch.equal(got["params"][path], want), (name, path)
                closed += want.numel() * want.element_size()
            for part in ("master", "m", "v"):
                for path, t in flatten(full.opt_state[part]).items():
                    want = _slice(t, ospecs[part][path], coord, mesh.shape)
                    assert torch.equal(got["opt"][part][path], want), (name, part, path)
                    closed += want.numel() * want.element_size()
            assert got["state_bytes"] == got["block_bytes"] == closed, name


def test_checkpoint_from_the_grid_resumes_anywhere(grid4):
    """A checkpoint written from the 2 x 2 grid (the single-device format)
    resumes on one device and on a (4, 1) grid to the same next loss as
    the grid that wrote it."""
    outs, _, _, ck, _ = grid4
    fields, _, batches, opt, path = ck
    got = outs[0]["ckpt"]
    assert all(o["ckpt"] == got for o in outs)
    cfg = TConfig(**fields)
    target = TTS.abstract_train_state(cfg)
    state = load_checkpoint(path, target, device=CPU)
    assert state.step == got["step"] == 1
    state = TTS.train_state_from(state.params, state.opt_state, state.step)
    _, m = TTS.make_train_step(cfg, tadamw.AdamWConfig(**opt))(
        state, {k: torch.from_numpy(v) for k, v in batches[1].items()})
    single = float(m["loss"])
    for loss in (got["grid"], got["grid41"]):
        assert abs(loss - single) / single < LOSS_RTOL, (got, single)


def test_launcher_trains_the_grid(grid4, tmp_path):
    """``main`` on ``--device cpu --p2p host --model-parallel 2`` in a job
    of four ranks (data 2): the single device's losses from the same seed
    and batches, ``"mode": "gspmd"`` in ``metrics.jsonl``, per-rank state
    bytes equal to their closed form."""
    outs, _, _, _, (argv, tcfg) = grid4
    single_argv = list(argv)
    for flag in ("--model-parallel", "--p2p"):
        i = single_argv.index(flag)
        del single_argv[i:i + 2]
    single_argv[single_argv.index("--run-dir") + 1] = str(tmp_path / "single")
    with mock.patch.object(train, "get_smoke_config", lambda name: tcfg):
        want = train.main(single_argv)["losses"]
    for o in outs:
        got = o["launcher"]
        assert got["mode"] == "gspmd" and got["state_bytes"] == got["block_bytes"]
        assert len(got["losses"]) == 2 and got["stats"][-1]["world_reduce_bytes"] > 0
        for a, b in zip(got["losses"], want):
            assert abs(a - b) / b < LOSS_RTOL, (got["losses"], want)
    assert "metrics.jsonl" in outs[0]["launcher"]["files"]
    run_dir = pathlib.Path(argv[argv.index("--run-dir") + 1])
    meta = (run_dir / "metrics.jsonl").read_text().splitlines()[0]
    assert '"mode": "gspmd"' in meta and (run_dir / "rank3" / "metrics.jsonl").exists()
    assert sorted(tuple(o["launcher"]["grid"]) for o in outs) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("arch,whole", [
    ("qwen3_moe_30b_a3b", {"attention": "num_heads=2", "experts": "num_experts=4"}),
    ("mamba2_780m", {"ssm": "ssm_nheads=16"}),
    ("zamba2_2p7b", {"attention": "num_heads=2", "mlp": "d_ff=512", "ssm": "ssm_nheads=16"}),
    ("whisper_base", {"attention": "num_heads=2", "mlp": "d_ff=512"}),
    ("qwen1p5_0p5b", {"attention": "num_heads=2", "mlp": "d_ff=512"})])
def test_launcher_refuses_model_parallel_without_sharded_blocks(arch, whole, tmp_path):
    """A model axis that does not divide the count its members split
    (experts, mamba2 heads, attention heads, ff width) is no longer
    refused: the launcher trains one step at ``--model-parallel 3``, each
    such part computed whole on every member and named, on the ``arch=``
    line, in the result and in the metadata row of ``metrics.jsonl``."""
    res = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--model-parallel", "3",
                      "--p2p", "host", "--steps", "1", "--batch", "2", "--seq", "32",
                      "--run-dir", str(tmp_path)])
    assert res["mode"] == "gspmd" and res["whole"] == whole
    assert len(res["losses"]) == 1 and np.isfinite(res["losses"][0])
    assert res["state_bytes"] == res["block_bytes"]
    meta = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[0])
    assert meta["whole"] == whole and meta["model_parallel"] == 3


@pytest.mark.parametrize("extra,what", [
    (["--tensor-parallel", "2"], "--tensor-parallel 2 only applies to the pipeline"),
    (["--trace"], "--trace re-drives the pipeline"),
    (["--pipeline-parallel", "2", "--model-parallel", "2"], "the pipeline takes"),
    (["--model-parallel", "2"], "--p2p host"),
    (["--model-parallel", "2", "--data-parallel", "3", "--p2p", "host", "--batch", "8"],
     "does not split")])
def test_launcher_refusals_off_the_pipeline(extra, what):
    with pytest.raises(SystemExit, match=what):
        train.main(["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu"] + extra)


def test_one_by_one_grid_is_the_single_device_path(tmp_path):
    res = train.main(["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu", "--steps",
                      "1", "--batch", "2", "--seq", "16", "--model-parallel", "1",
                      "--run-dir", str(tmp_path)])
    assert "state" in res and "mode" not in res


def test_data_loader_yields_the_jax_batches_and_rows():
    cfg_j, cfg_t = jsmoke("paligemma_3b"), tsmoke("paligemma_3b")
    dj = jpipe.DataConfig(batch_size=4, seq_len=17, seed=11, prefetch=3)
    dt = tpipe.DataConfig(**dataclasses.asdict(dj))
    jl = jpipe.make_loader(cfg_j, dj)
    tl = tpipe.make_loader(cfg_t, dt, device="cpu")
    rl = tpipe.make_loader(cfg_t, dt, device="cpu", rows=np.array([3, 1]))
    try:
        for _ in range(4):
            bj, bt, br = next(jl), next(tl), next(rl)
            assert set(bt) == set(bj) == {"tokens", "image_embeds"}
            for k in bj:
                np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))
                np.testing.assert_array_equal(br[k].numpy(), np.asarray(bj[k])[[3, 1]])
    finally:
        jl.close()
        tl.close()
        rl.close()
    assert not tl._thread.is_alive() and not rl._thread.is_alive()


def test_data_loader_surfaces_a_worker_failure():
    class Broken(tpipe.SyntheticTokens):
        def next_batch(self):
            raise ValueError("no more tokens")

    cfg = tsmoke("qwen1p5_0p5b")
    loader = tpipe.DataLoader(Broken(cfg, tpipe.DataConfig()), device="cpu")
    with pytest.raises(RuntimeError, match="data worker failed") as err:
        next(loader)
    assert isinstance(err.value.__cause__, ValueError)
    loader.close()
    assert not loader._thread.is_alive()
    before = threading.active_count()
    for _ in range(3):
        next(iter(tpipe.make_loader(cfg, tpipe.DataConfig(batch_size=1, seq_len=8),
                                    device="cpu")))
    # a loader nobody closes stops once it is collected
    import gc
    gc.collect()
    for _ in range(40):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before


def test_local_rows_follow_the_batch_rule_and_microbatches():
    from repro_torch.sharding import spmd

    class G:
        D, S, T, d, k, dp, tp = 2, 1, 2, 1, 0, object(), object()

    from repro_torch.launch.mesh import Mesh
    layout = spmd.Layout(Mesh.of((2, 2), ("data", "model")), G)
    assert spmd.local_rows(8, layout).tolist() == [4, 5, 6, 7]
    assert spmd.local_rows(8, layout, 2).tolist() == [2, 3, 6, 7]
    with pytest.raises(NotImplementedError, match="does not split"):
        spmd.local_rows(6, layout, 2)
    assert layout.block_slices(("data", None), (4, 3)) == [(0, 2, 2)]
    assert layout.block_slices((None, ("data", "model")), (3, 8)) == [(1, 4, 2)]
