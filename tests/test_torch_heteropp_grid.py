"""The port's HeteroPP over a (dp, pipe, tp) rank grid held against the
JAX package on the CPU.

gloo CPU ranks started by ``repro_torch.launch.ranks`` (rank functions in
``tests/helpers/torch_pipeline_ranks.py``), fp32 ``conftest.exact_cfg``
smoke configs, weights from ``repro.models.model.init_params``: the
pipeline's loss equals the mean of the JAX package's ``M.loss_fn`` over
every replica's microbatches to 1e-5 rel, and its gradient, with the tp
shards and the ZeRO-1 slices put back together, equals ``jax.grad`` laid
out as stages (``JHP.split_stage_params``) to 1e-4 of each leaf's
largest entry, as ``tests/test_torch_heteropp.py`` holds the pipe axis.
Cases: (pipe 2, tp 2) for granite (and with qk-norm, whose per-head
scales see one member's heads); (dp 2, pipe 2) under per-leaf ``psum``,
bucketed ``psum`` in narrow and in wide buckets (bit for bit equal to
per-leaf) and ZeRO-1 ``reduce_scatter`` (parameters after one step
within 1e-6 rel of ``psum``'s), for granite, mamba2 and qwen1.5; (dp 2, pipe 2, tp 2) for granite
under ZeRO-1 with one train step against the port's single-device step
(first moment, clip norm within 1e-5 of the single device's
``global_norm``, updated parameters).  (dp 2, pipe 2) with the uneven
batch domain (4, 3) for granite and mamba2 in every sync mode, against
the JAX package over the 7 microbatches, each replica on its own tick
program; its tight and padded token layouts, and the padded one with
its pad slots overwritten, bit for bit equal.  And the collectives of a
group that is not the default one.
"""
import dataclasses
import json
import math
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import exact_cfg
from repro.core import heteropp as JHP
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.core import heteropp as THP
from repro_torch.core.tp_rules import tp_body_dim
from repro_torch.launch import ranks
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.training import train_step as TTS
from repro_torch.tree import flatten
from test_torch_heteropp import GRAD_TOL, LOSS_RTOL, OPT, _jax_reference, _np, _pair

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests" / "helpers"))
import torch_pipeline_ranks as W  # noqa: E402

CPU = torch.device("cpu")
PHYS = (1, 1)
B, MB, SEQ = 2, 2, 32          # microbatches a replica, rows, tokens
ZERO_RTOL = 1e-6
NORM_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _two_threads():
    """Keep the parent's torch to two threads beside the other workers
    (ROADMAP: wall-clock tests share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(arch, D, modes, seed=2, domain=None, **changes):
    """A case for ``W.grid_cases``: ``_pair``'s weights (or, with config
    ``changes``, the JAX package's init of the changed config) and D·B
    microbatches of tokens, or with an uneven batch ``domain`` Σ domain
    of them (the tight layout)."""
    if changes:
        jcfg = dataclasses.replace(exact_cfg(arch), **changes)
        tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
        tcfg = TConfig(**dataclasses.asdict(jcfg))
    else:
        jcfg, tcfg, tree = _pair(arch, seed=seed)
    n = sum(domain) if domain else D * B
    tokens = np.random.default_rng(seed + 1).integers(
        0, jcfg.vocab_size, (n, MB, SEQ)).astype(np.int64)
    return jcfg, {"cfg": dataclasses.asdict(tcfg), "tree": tree, "tokens": tokens,
                  "phys": PHYS, "modes": modes, "domain": domain}


def _spawn(jobs, tmp_path):
    """``W.grid_cases`` of ``jobs`` (``(grid_shape, cases, train_opt)``,
    grids of one size) in one spawn; its results a job, rank by rank."""
    D, S, T = jobs[0][0]
    res = ranks.spawn(W.grid_cases, D * S * T, (jobs,), workdir=str(tmp_path), threads=1,
                      timeout=300)
    return [[r[j] for r in res] for j in range(len(jobs))]


def _assemble(results, i, mode, grid_shape, key="grads", part="grads"):
    """Case ``i``'s ``key`` tree from every rank as the stage layout at
    full width: dp slices concatenated on their ZeRO-1 dim (when ``part``
    is a ZeRO-1 slice), tp shards on their Megatron dim, block leaves
    stacked over stages, the replicated leaves once.  Copies that must
    agree (dp replicas of a whole leaf, tp members of a replicated one)
    are held equal bit for bit."""
    D, S, T = grid_shape
    by = {tuple(r["grid"]): r for r in (res[i] for res in results)}

    def tree(d, s, k):
        r = by[(d, s, k)][mode]
        return flatten(r["train"][key] if key != "grads" else r["grads"])

    dims = {c: flatten(by[c][mode]["dims"]) for c in by}

    def whole(s, k, path):
        dim = dims[(0, s, k)][path]
        if dim >= 0 and part == "sliced":
            return torch.cat([tree(d, s, k)[path] for d in range(D)], dim)
        for d in range(1, D):
            torch.testing.assert_close(tree(d, s, k)[path], tree(0, s, k)[path],
                                       rtol=0, atol=0, msg=path)
        return tree(0, s, k)[path]

    out = {}
    for path in tree(0, 0, 0):
        if not path.startswith("blocks/"):
            out[path] = whole(0, 0, path)
            continue
        per_stage = []
        for s in range(S):
            leaf = whole(s, 0, path)
            tdim = tp_body_dim(path, leaf.ndim - 1) if T > 1 else None
            if tdim is None:
                for k in range(1, T):
                    torch.testing.assert_close(whole(s, k, path), leaf, rtol=0, atol=0,
                                               msg=path)
            else:
                leaf = torch.cat([whole(s, k, path) for k in range(T)], 1 + tdim)
            per_stage.append(leaf)
        out[path] = torch.stack(per_stage)
    return out


def _check_against_jax(results, i, jcfg, case, grid_shape):
    """Every mode of case ``i``: the same loss on every rank, the JAX
    package's loss and gradient.  Returns the JAX gradient's global norm."""
    D, S, T = grid_shape
    want_loss, jgrads = _jax_reference(jcfg, case["tree"],
                                       case["tokens"].astype(np.int32))
    want, _ = JHP.split_stage_params(jgrads, jcfg, JHP.PipelineSpec(S, PHYS, B))
    fw = flatten(jax.tree.map(np.asarray, want))
    for mode in case["modes"]:
        losses = {res[i][mode]["loss"] for res in results}
        assert len(losses) == 1, (mode, losses)
        assert abs(losses.pop() - want_loss) / abs(want_loss) < LOSS_RTOL, mode
        part = "sliced" if mode == "reduce_scatter" else "whole"
        fg = _assemble(results, i, mode, grid_shape, part=part)
        assert fw.keys() == fg.keys()
        for k in fw:
            np.testing.assert_allclose(_np(fg[k]), fw[k], rtol=0,
                                       atol=GRAD_TOL * max(np.abs(fw[k]).max(), 1e-6),
                                       err_msg=f"{mode} {k}")
    return math.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                         for g in jax.tree.leaves(jgrads)))


TP_GRID, DP_GRID = (1, 2, 2), (2, 2, 1)
DP_ARCHS = ("granite_8b", "mamba2_780m", "qwen1p5_0p5b")
# the uneven batch domain's cases: replica 0 takes 4 microbatches, 1 takes 3
DOMAIN = (4, 3)
UNEVEN_ARCHS = ("granite_8b", "mamba2_780m")
DP_CASES = [(arch, None) for arch in DP_ARCHS] + [(arch, DOMAIN) for arch in UNEVEN_ARCHS]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One spawn of four ranks for the (pipe 2, tp 2) cases (granite, and
    granite with qk-norm) and the (dp 2, pipe 2) ones (every arch, every
    sync mode, one train step each; the uneven domain's too)."""
    tp = [_case("granite_8b", 1, ["psum"]),
          _case("granite_8b", 1, ["psum"], seed=5, qk_norm=True)]
    dp = [_case(arch, 2, list(W.SYNC_MODES), domain=domain) for arch, domain in DP_CASES]
    res_tp, res_dp = _spawn([(TP_GRID, [c for _, c in tp], None),
                             (DP_GRID, [c for _, c in dp], OPT)],
                            tmp_path_factory.mktemp("grid"))
    return tp, res_tp, dp, res_dp


def test_tensor_parallel_matches_jax(four_ranks):
    """(pipe 2, tp 2): Megatron tp shards put back together equal the JAX
    gradient; with qk-norm too (its scales pass the tp copy)."""
    cases, res, _, _ = four_ranks
    for i, (jcfg, case) in enumerate(cases):
        _check_against_jax(res, i, jcfg, case, TP_GRID)
    assert "blocks/attn/q_norm/scale" in flatten(res[0][1]["psum"]["grads"])


@pytest.mark.parametrize("arch,domain", DP_CASES, ids=[
    arch if domain is None else f"{arch}-domain{domain}" for arch, domain in DP_CASES])
def test_data_parallel_sync_modes_match_jax(arch, domain, four_ranks):
    """(dp 2, pipe 2) under per-leaf psum, bucketed psum and ZeRO-1: each
    equals the JAX gradient; bucketed equals per-leaf bit for bit; one
    step under ZeRO-1 leaves the parameters per-leaf psum leaves.  With
    an uneven batch ``domain`` too, against the JAX package over all its
    microbatches."""
    _, _, cases, res = four_ranks
    i = DP_CASES.index((arch, domain))
    jcfg, case = cases[i]
    _check_against_jax(res, i, jcfg, case, DP_GRID)
    for r in res:
        a = flatten(r[i]["psum"]["grads"])
        for mode in ("psum_bucketed", "psum_bucketed_wide"):
            b = flatten(r[i][mode]["grads"])
            for k in a:
                torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=f"{mode} {k}")
        a, b = (flatten(r[i][m]["train"]["params"]) for m in ("psum", "reduce_scatter"))
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=ZERO_RTOL, atol=0, msg=k)
    assert any(d >= 0 for d in flatten(res[0][i]["reduce_scatter"]["dims"]).values())


@pytest.mark.parametrize("arch", UNEVEN_ARCHS)
def test_uneven_batch_domain_runs_each_replica_and_ignores_pad_slots(arch, four_ranks):
    """Under the batch domain (4, 3), replica d runs its own 1f1b program
    for its allocation (allocation + 1 ticks: the prefix of its row of
    ``domain_tick_tables``; the pad ticks are skipped), and the padded
    token layout, and the padded one with every pad slot overwritten,
    give the tight layout's loss and gradient bit for bit."""
    from repro_torch.core import tickprogram as ttp
    _, _, cases, res = four_ranks
    i = DP_CASES.index((arch, DOMAIN))
    rows = ttp.domain_tick_tables("1f1b", 2, DOMAIN)
    for r in res:
        d = r[i]["grid"][0]
        own = ttp.spmd_tick_tables("1f1b", 2, DOMAIN[d])
        assert r[i]["psum"]["ticks"] == own.ticks == DOMAIN[d] + 1
        for f in ("mb", "chunk", "src", "active", "emit"):
            np.testing.assert_array_equal(getattr(rows, f)[:own.ticks, d], getattr(own, f))
        assert not rows.active[own.ticks:, d].any()
        tight = r[i]["psum"]
        for name in ("padded", "clobbered"):
            assert r[i]["psum"][name]["loss"] == tight["loss"], name
            a, b = flatten(tight["grads"]), flatten(r[i]["psum"][name]["grads"])
            for k in a:
                torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=f"{name} {k}")


def test_full_grid_train_step_matches_single_device(tmp_path):
    """(dp 2, pipe 2, tp 2) under ZeRO-1 for granite: the gradient equals
    the JAX package's, and one train step leaves the port's single-device
    step's first moment, clip norm and parameters (as
    ``test_torch_heteropp.py`` holds the pipe axis)."""
    grid = (2, 2, 2)
    jcfg, case = _case("granite_8b", 2, ["reduce_scatter"])
    res, = _spawn([(grid, [case], OPT)], tmp_path)
    jnorm = _check_against_jax(res, 0, jcfg, case, grid)
    tcfg = TConfig(**case["cfg"])
    tokens = case["tokens"]
    state = TTS.train_state_from(bridge.params_from_numpy(case["tree"], CPU), None, 0)
    state.opt_state = tadamw.init_opt_state(state.params)
    step = TTS.make_train_step(tcfg, tadamw.AdamWConfig(**OPT))
    state, m = step(state, {"tokens": torch.from_numpy(tokens.reshape(-1, SEQ))})
    spec = THP.PipelineSpec(2, PHYS, B)
    staged = lambda tree: flatten(THP.split_stage_params(tree, tcfg, spec)[0])
    p0 = staged(bridge.params_from_numpy(case["tree"], CPU))
    want_m, want = staged(state.opt_state["m"]), staged(state.params)
    got_m = _assemble(res, 0, "reduce_scatter", grid, key="m", part="sliced")
    got_master = _assemble(res, 0, "reduce_scatter", grid, key="master", part="sliced")
    got = _assemble(res, 0, "reduce_scatter", grid, key="params")
    for k, mk in want_m.items():
        torch.testing.assert_close(got_m[k], mk, rtol=0,
                                   atol=GRAD_TOL * max(float(mk.abs().max()), 1e-12), msg=k)
        torch.testing.assert_close(got[k], got_master[k], rtol=0, atol=0, msg=k)
        sure = mk.abs() > 1e-3 * float(mk.abs().max())
        assert sure.any(), k
        torch.testing.assert_close((got[k] - p0[k])[sure], (want[k] - p0[k])[sure],
                                   rtol=1e-3, atol=0, msg=k)
        torch.testing.assert_close(got[k], want[k], rtol=0,
                                   atol=2 * OPT["lr"] + 1e-6, msg=k)
    train = [r[0]["reduce_scatter"]["train"] for r in res]
    assert len({t["grad_norm"] for t in train}) == 1
    assert math.isclose(train[0]["grad_norm"], jnorm, rel_tol=NORM_RTOL)
    assert math.isclose(train[0]["grad_norm"], float(m["grad_norm"]), rel_tol=NORM_RTOL)
    assert abs(train[0]["loss"] - float(m["loss"])) / float(m["loss"]) < LOSS_RTOL


def test_subgroup_collectives_reach_the_right_ranks(tmp_path):
    """A pipe group that is not the default group: its hop goes to the
    peer's global rank (0 <-> 2 and 1 <-> 3 on a (1, 2, 2) grid, 0 <-> 1
    and 2 <-> 3 on (2, 2, 1)), and a reduce-scatter and an all-gather
    (fp32 and bf16) on dim 1 over the tp or dp group give its members'
    sum and slices."""
    res = ranks.spawn(W.subgroup_collectives, 4, workdir=str(tmp_path), threads=1,
                      timeout=120)
    peers = {"(1, 2, 2)": {0: 2, 2: 0, 1: 3, 3: 1}, "(2, 2, 1)": {0: 1, 1: 0, 2: 3, 3: 2}}
    for shape, peer in peers.items():
        for rank, r in enumerate(res):
            o = r[shape]
            torch.testing.assert_close(o["got"], torch.full((3,), float(peer[rank])))
            group = o["group"]
            total = sum(torch.arange(8.0).reshape(2, 4) + 10 * g for g in group)
            me = group.index(rank)
            torch.testing.assert_close(o["part"], total[:, 2 * me:2 * me + 2])
            torch.testing.assert_close(
                o["gathered"], torch.tensor([[0.0, 0, 1, 1]] * 2))
            torch.testing.assert_close(
                o["gathered_bf16"],
                torch.tensor([[0.5, 0.5, 1.5, 1.5]] * 2, dtype=torch.bfloat16))


def test_launcher_runs_a_tp_dp_plan(tmp_path, monkeypatch):
    """``launch.train --plan`` with a uniform tp 2, dp 2 plan (two
    one-stage chip groups, ZeRO-1): eight ranks on the fp32 smoke config
    train what the single device trains, every rank logs its losses, and
    the metrics name the grid."""
    from repro_torch.core import chips as tchips, cost_model as tcm
    from repro_torch.launch import train
    monkeypatch.setattr(train, "get_smoke_config", W.fp32_smoke_config)
    g = lambda name: tchips.ChipGroup(tchips.CHIPS[name], 4)
    plan = tcm.ParallelPlan([tcm.StagePlan(g("A"), 2, 1, 1, True),
                             tcm.StagePlan(g("B"), 2, 1, 1, False)],
                            dp=2, microbatches=2, schedule="1f1b")
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan.to_dict()))
    argv = ["--arch", "granite_8b", "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "8", "--seq", "32", "--log-every", "1"]
    res = train.main(argv + ["--plan", str(path), "--p2p", "host", "--no-verify-plan",
                             "--run-dir", str(tmp_path / "grid")])
    want = train.main(argv + ["--run-dir", str(tmp_path / "single")])["losses"]
    np.testing.assert_allclose(res["losses"], want, rtol=LOSS_RTOL)
    assert res["grid_per_rank"] == [[d, s, k] for d in range(2) for s in range(2)
                                    for k in range(2)]
    assert all(losses == res["losses"] for losses in res["losses_per_rank"])
    meta = json.loads((tmp_path / "grid" / "metrics.jsonl").read_text().splitlines()[0])
    assert (meta["tensor_parallel"], meta["data_parallel"], meta["grad_sync"]) == \
        (2, 2, "reduce_scatter")
    rows = (tmp_path / "grid" / "rank7" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(r)["loss"] for r in rows[1:]] == res["losses"]
    # ZeRO-1: each rank holds half of the 12 bytes a parameter of its stage
    assert [2 * b for b in res["opt_state_bytes_per_rank"]] == \
        [12 * n for n in res["param_count_per_rank"]]
    assert sum(res["tp_s_per_step"]) > 0 and sum(res["dp_scatter_s_per_step"]) > 0


@pytest.mark.parametrize("layout", ["grouped", "grouped-naive", "uneven"])
def test_launcher_runs_a_grouped_and_an_uneven_plan(layout, tmp_path, monkeypatch, capsys):
    """``launch.train --plan`` with a plan whose stages disagree on tp (tp
    2 on chip A, 1 on chip B: three ranks, the boundary's reshard picked
    by ``choose_strategy``, or ``naive`` by ``--reshard``), and with one
    of two replicas of uneven
    batch domain (2, 1) (four ranks, batch 6 = 3 microbatches): two steps
    on the fp32 smoke config train what the single device trains, and the
    layout line names the stage tps or the domain."""
    from repro_torch.core import chips as tchips, cost_model as tcm
    from repro_torch.launch import train
    monkeypatch.setattr(train, "get_smoke_config", W.fp32_smoke_config)
    g = lambda name, n: tchips.ChipGroup(tchips.CHIPS[name], n)
    extra = ["--reshard", "naive"] if layout == "grouped-naive" else []
    if layout.startswith("grouped"):
        plan = tcm.ParallelPlan([tcm.StagePlan(g("A", 2), 2, 1, 1, True),
                                 tcm.StagePlan(g("B", 1), 1, 1, 1, False)],
                                dp=1, microbatches=2, schedule="1f1b")
        batch, world = 4, 3
        line = f"stage_tp=(2, 1) reshard=('{'naive' if extra else 'sr_ag'}',)"
    else:
        plan = tcm.ParallelPlan([tcm.StagePlan(g("A", 2), 1, 1, 1, True),
                                 tcm.StagePlan(g("B", 2), 1, 1, 1, False)],
                                dp=2, microbatches=2, schedule="1f1b", batch_domain=(2, 1))
        batch, line, world = 6, "batch_domain=[2, 1]", 4
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan.to_dict()))
    argv = ["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", str(batch), "--seq", "32", "--log-every", "1"]
    res = train.main(argv + ["--plan", str(path), "--p2p", "host", "--no-verify-plan",
                             "--run-dir", str(tmp_path / layout)] + extra)
    assert line in capsys.readouterr().out
    want = train.main(argv + ["--run-dir", str(tmp_path / "single")])["losses"]
    np.testing.assert_allclose(res["losses"], want, rtol=LOSS_RTOL)
    assert len(res["losses_per_rank"]) == world
    assert all(losses == res["losses"] for losses in res["losses_per_rank"])
    if layout.startswith("grouped"):
        assert res["grid_per_rank"] == [[0, 0, 0], [0, 0, 1], [0, 1, 0]]
        assert all(b > 0 for b in res["boundary_bytes_per_step"])
        assert sum(res["p2p_bytes_per_step"]) == 0
    else:
        # each replica runs its own allocation's 1f1b program: b + 1 ticks
        assert res["ticks_per_rank"] == [3, 3, 2, 2]


def test_launcher_refuses_search_flags_without_search(tmp_path):
    """``--search-dp`` and ``--search-uneven-dp`` without ``--search``: the
    JAX launcher's refusal; ``--reshard`` without a plan, or with a plan
    whose stages share their tp."""
    from repro_torch.core import chips as tchips, cost_model as tcm
    from repro_torch.launch import train
    argv = ["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu"]
    for flag in (["--search-uneven-dp"], ["--search-dp", "1,2"]):
        with pytest.raises(SystemExit, match="only shapes the HeteroAuto search; add --search"):
            train.main(argv + ["--pipeline-parallel", "2", *flag])
    with pytest.raises(SystemExit, match="add --plan or --search"):
        train.main(argv + ["--pipeline-parallel", "2", "--reshard", "naive"])
    g = lambda name: tchips.ChipGroup(tchips.CHIPS[name], 1)
    plan = tcm.ParallelPlan([tcm.StagePlan(g("A"), 1, 1, 1, True),
                             tcm.StagePlan(g("B"), 1, 1, 1, False)], dp=1, microbatches=2)
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan.to_dict()))
    with pytest.raises(SystemExit, match="share one tp degree"):
        train.main(argv + ["--plan", str(path), "--reshard", "naive", "--p2p", "host"])
