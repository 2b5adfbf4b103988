"""The port's planning modules against the JAX package's: the chip
catalog, the schedule simulator, the HeteroPP cost model and plan
replay, the data-parallel and resharding closed forms, the transport
model.  Both packages run the same Python float arithmetic on the same
inputs, so every comparison is exact equality."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.comm import latency as jlat
from repro.configs import get_config as jget_config
from repro.core import chips as jchips, cost_model as jcm, heteroauto as jha
from repro.core import resharding as jrs, schedule as jsched
from repro.core.dataparallel import batch_domain as jbd, grad_sync as jgs
from repro.core.schedules import available_schedules as javailable
from repro.core.schedules import simulate as jsimulate
from repro_torch.comm import latency as tlat
from repro_torch.configs import get_config as tget_config
from repro_torch.core import chips as tchips, cost_model as tcm
from repro_torch.core import resharding as trs, schedule as tsched
from repro_torch.core.dataparallel import batch_domain as tbd, grad_sync as tgs
from repro_torch.core.schedules import available_schedules as tavailable
from repro_torch.core.schedules import get_schedule as tget_schedule
from repro_torch.core.schedules import simulate as tsimulate
from repro_torch.tree import tree_map

MEASURED = {"A": {"t_fwd": 5e-3, "t_bwd": 9e-3, "wgrad_frac": 0.25}}


def test_chip_catalog_equal_jax():
    assert sorted(tchips.CHIPS) == sorted(jchips.CHIPS)
    for name, spec in jchips.CHIPS.items():
        assert dataclasses.asdict(tchips.CHIPS[name]) == dataclasses.asdict(spec)
    assert tchips.TABLE6 == jchips.TABLE6
    assert tchips.EXPERIMENTS == jchips.EXPERIMENTS
    assert tchips.A100_FP16 == jchips.A100_FP16


def test_schedule_registry_equal_jax():
    """The registries agree, and ``Schedule.verify`` (the copied safety
    passes) gives the JAX package's diagnostics."""
    from repro.core.schedules import get_schedule as jget_schedule
    assert tavailable() == javailable()
    for name in javailable():
        for S, b in ((2, 4), (4, 8), (3, 5)):
            got = [d.format() for d in tget_schedule(name).verify(S, b)]
            assert got == [d.format() for d in jget_schedule(name).verify(S, b)], name


@pytest.mark.parametrize("S,b", [(2, 4), (4, 8)])
@pytest.mark.parametrize("name", javailable())
def test_simulate_equal_jax(name, S, b):
    rng = np.random.default_rng(S * 10 + b)
    tf = [float(t) for t in rng.uniform(1.0, 2.0, S)]
    tb = [float(t) for t in rng.uniform(2.0, 4.0, S)]
    p2p = [float(t) for t in rng.uniform(0.0, 0.2, S - 1)]
    upd = [float(t) for t in rng.uniform(0.0, 0.5, S)]
    wf = [float(t) for t in rng.uniform(0.2, 0.6, S)]
    kw = dict(t_update=upd, wgrad_frac=wf, record_spans=True)
    want = jsimulate(name, tf, tb, b, p2p, **kw)
    got = tsimulate(name, tf, tb, b, p2p, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.spans


def _plans(dp, schedule):
    """The A:4 + B:4 plan of ``tests/test_dataparallel.py::_plan``, built
    in the JAX package and carried to the port through its JSON form."""
    g = lambda n, c: jchips.ChipGroup(jchips.CHIPS[n], c)
    jplan = jcm.ParallelPlan([jcm.StagePlan(g("A", 4), 2, 1, 2, False),
                              jcm.StagePlan(g("B", 4), 2, 1, 2, True)],
                             dp=dp, microbatches=4, schedule=schedule)
    tplan = tcm.ParallelPlan.from_dict(jplan.to_dict())
    assert tplan.to_dict() == jplan.to_dict()
    return jplan, tplan


@pytest.mark.parametrize("measured", [False, True])
@pytest.mark.parametrize("schedule", ["1f1b", "zb_h1", "interleaved"])
@pytest.mark.parametrize("dp", [1, 2])
def test_evaluate_and_simulate_plan_equal_jax(dp, schedule, measured):
    jcfg, tcfg = jget_config("granite_8b"), tget_config("granite_8b")
    jplan, tplan = _plans(dp, schedule)
    meas = MEASURED if measured else None
    want = jcm.evaluate(jplan, jcfg, 4096, 16 * 4096, measured=meas)
    got = tcm.evaluate(tplan, tcfg, 4096, 16 * 4096, measured=meas)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for grad_sync in (False, True):
        want = jsched.simulate_plan(jplan, jcfg, 4096, measured=meas,
                                    grad_sync=grad_sync)
        got = tsched.simulate_plan(tplan, tcfg, 4096, measured=meas,
                                   grad_sync=grad_sync)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tsched.plan_to_schedule_inputs(tplan, tcfg, 4096, measured=meas) == \
        jsched.plan_to_schedule_inputs(jplan, jcfg, 4096, measured=meas)


@pytest.mark.parametrize("name", ["A", "B", "C", "D"])
def test_table6_tgs_equal_jax(name):
    """The paper's Table 6 homogeneous baselines, priced as
    ``heteroauto.homogeneous_baseline`` prices its pinned configuration."""
    jcfg, tcfg = jget_config("h2_100b"), tget_config("h2_100b")
    gbs, seq = 2 * 2 ** 20, 4096
    t6 = jchips.TABLE6[name]
    want = jha.homogeneous_baseline(
        jchips.ChipGroup(jchips.CHIPS[name], 256), jcfg, gbs, seq,
        fixed={"dp": t6["dp"], "tp": t6["tp"], "recompute": t6["recompute"]},
        allow_offload=True)
    plan = tcm.ParallelPlan.from_dict(want.plan.to_dict())
    got = tcm.evaluate(plan, tcfg, seq, gbs, alpha=1.0, allow_offload=True,
                       sync_overlap=0.7)
    assert dataclasses.asdict(got) == dataclasses.asdict(want.cost)
    assert abs(got.tgs - t6["tgs"]) / t6["tgs"] < 0.05


def test_bucketize_and_sync_time_equal_jax():
    rng = np.random.default_rng(3)
    leaves = [(f"l{i}", int(n)) for i, n in
              enumerate(rng.integers(1, 40 * 2 ** 20, 50))]
    for bucket_bytes in (2 ** 20, 25 * 2 ** 20, 10 ** 9):
        jb, tb = jgs.bucketize(leaves, bucket_bytes), tgs.bucketize(leaves, bucket_bytes)
        assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
        for dp in (1, 2, 3, 8):
            for mode in jgs.GRAD_SYNC_MODES:
                for transport in jlat.TRANSPORTS:
                    assert tgs.sync_time(tb, dp, transport, mode) == \
                        jgs.sync_time(jb, dp, transport, mode)
    assert tgs.GRAD_SYNC_MODES == jgs.GRAD_SYNC_MODES
    for shape, dp, taken in [((8, 6), 2, ()), ((3, 6), 2, (1,)), ((5, 7), 4, ()),
                             ((16,), 16, ())]:
        assert tgs.zero1_scatter_dim(shape, dp, taken) == \
            jgs.zero1_scatter_dim(shape, dp, taken)


def test_tree_leaf_bytes_equal_jax():
    tree = {"embed": {"tok": torch.zeros(7, 3, dtype=torch.bfloat16)},
            "blocks": {"mlp": {"wo": torch.zeros(2, 5, 4), "wi": torch.zeros(2, 4, 5)},
                       "ln1": {"scale": torch.zeros(2, 4)}},
            "final_norm": {"scale": torch.zeros(4)}}
    # the same shapes and item sizes as numpy leaves (fp16 for bf16)
    as_numpy = tree_map(lambda t: np.zeros(t.shape, np.float16 if t.dtype == torch.bfloat16
                                           else np.float32), tree)
    assert tgs.tree_leaf_bytes(tree) == jgs.tree_leaf_bytes(as_numpy)


def test_resharding_closed_forms_equal_jax():
    for tp_src in (1, 2, 4, 8):
        for tp_dst in (1, 2, 4, 8):
            for nic, intra in ((12.5e9, 160e9), (25e9, 18e9), (12.5e9, 12.5e9)):
                kw = dict(nic_bw=nic, intra_bw=intra)
                assert trs.choose_strategy(tp_src, tp_dst, **kw) == \
                    jrs.choose_strategy(tp_src, tp_dst, **kw)
                for strategy in ("naive", "sr_ag"):
                    assert trs.boundary_time(2 ** 25, tp_src, tp_dst,
                                             strategy=strategy, **kw) == \
                        jrs.boundary_time(2 ** 25, tp_src, tp_dst,
                                          strategy=strategy, **kw)
            for fn in ("naive_cost", "sr_ag_cost"):
                assert dataclasses.asdict(getattr(trs, fn)(3 * 2 ** 20, tp_src, tp_dst)) \
                    == dataclasses.asdict(getattr(jrs, fn)(3 * 2 ** 20, tp_src, tp_dst))


def test_batch_domain_equal_jax():
    for total, rates, kw in [(16, (1.0, 2.5, 0.7), {}), (12, (3.0, 1.0), dict(quantum=2, min_per_replica=2)),
                             (9, (1.0, 1.0, 1.0, 5.0), dict(min_per_replica=2))]:
        jd, td = jbd.partition(total, rates, **kw), tbd.partition(total, rates, **kw)
        assert dataclasses.asdict(td) == dataclasses.asdict(jd)
        times = [1.0 / r for r in rates]
        assert tbd.domain_cost(td, times) == jbd.domain_cost(jd, times)
        assert tbd.pad_index_map(td.allocations) == jbd.pad_index_map(jd.allocations)
    with pytest.raises(ValueError):
        tbd.partition(2, (1.0, 1.0, 1.0))


def test_p2p_latency_equal_jax():
    assert sorted(tlat.TRANSPORTS) == sorted(jlat.TRANSPORTS)
    for name in jlat.TRANSPORTS:
        for nbytes in (0, 1, 64 * 2 ** 10, 2 ** 28, 3.5e9):
            assert tlat.p2p_latency(name, nbytes) == jlat.p2p_latency(name, nbytes)
    assert tlat.fig7_speedups() == jlat.fig7_speedups()
    assert tlat.affinity_throughput() == jlat.affinity_throughput()
    assert tlat.non_affinity_throughput() == jlat.non_affinity_throughput()


# ---------------------------------------------------------------------------
# the plan gate (analysis/*, kernels/constraints.py) and HeteroAuto
# ---------------------------------------------------------------------------

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


def _plan_dicts():
    """Plans as ``ParallelPlan.to_dict`` JSON, good and bad: the fixture
    files, then hand-made ones that trip one pass each."""
    plans = {p.stem: json.loads(p.read_text())
             for p in sorted(FIXTURES.glob("**/*.json"))}
    stage = lambda chip, count, tp, pp, layers, rec=False: dict(
        chip=chip, count=count, label="", tp=tp, pp=pp, layers=layers, recompute=rec)
    base = dict(dp=1, microbatches=4, schedule="1f1b", dp_sync="reduce_scatter",
                dp_transport="device_rdma", bucket_bytes=25 * 2 ** 20)
    plans.update({
        "hetero_1f1b": dict(base, stages=[stage("A", 1, 1, 1, 10, True),
                                          stage("B", 1, 1, 1, 14)]),
        "hetero_zb_v": dict(base, schedule="zb_v",
                            stages=[stage("A", 1, 1, 1, 10, True), stage("B", 1, 1, 1, 14)]),
        "interleaved_b_not_multiple": dict(base, schedule="interleaved", microbatches=3,
                                           stages=[stage("A", 1, 1, 1, 12),
                                                   stage("B", 1, 1, 1, 12)]),
        "grouped_tp_chunked": dict(base, schedule="zb_v",
                                   stages=[stage("A", 2, 2, 1, 12), stage("B", 1, 1, 1, 12)]),
        "grouped_tp": dict(base, stages=[stage("A", 4, 4, 1, 12), stage("B", 2, 2, 1, 12)]),
        "tp_not_dividing": dict(base, stages=[stage("A", 8, 8, 1, 24)]),
        "uneven_domain": dict(base, dp=2, batch_domain=[4, 3],
                              stages=[stage("A", 2, 1, 1, 12), stage("B", 2, 1, 1, 12)]),
        "unknown_schedule": dict(base, schedule="nope",
                                 stages=[stage("A", 1, 1, 1, 24)]),
        "missing_field": {"dp": 1},
    })
    return plans


PLANS = _plan_dicts()


@pytest.mark.parametrize("name", sorted(PLANS))
def test_analyze_and_verify_plan_equal_jax(name):
    from repro.analysis import (PlanVerificationError as JPVE, analyze_plan as janalyze,
                                verify_plan as jverify)
    from repro_torch.analysis import (PlanVerificationError as TPVE,
                                      analyze_plan as tanalyze, verify_plan as tverify)
    plan = PLANS[name]
    fmt = lambda diags: [d.format() for d in diags]
    assert fmt(tanalyze(plan)) == fmt(janalyze(plan))
    for arch, seq in (("qwen1p5_0p5b", 1024), ("granite_8b", 4096)):
        kw = dict(seq_len=seq, gbs_tokens=8 * seq)
        assert fmt(tanalyze(plan, tget_config(arch), **kw)) == \
            fmt(janalyze(plan, jget_config(arch), **kw)), arch
    try:
        jplan = jcm.ParallelPlan.from_dict(plan)
    except (KeyError, ValueError):
        return
    tplan = tcm.ParallelPlan.from_dict(plan)
    try:
        want = fmt(jverify(jplan))
    except JPVE as e:
        with pytest.raises(TPVE) as got:
            tverify(tplan)
        assert str(got.value) == str(e) and isinstance(got.value, ValueError)
    else:
        assert fmt(tverify(tplan)) == want


def test_kernel_constraints_equal_jax():
    from repro.kernels import constraints as jcon
    from repro_torch.kernels import constraints as tcon
    for name in ("LANE", "DEFAULT_PAGE", "MIN_GROUP", "DEFAULT_BLOCK_Q", "DEFAULT_BLOCK_K"):
        assert getattr(tcon, name) == getattr(jcon, name)
    for seq_k in (1, 64, 100, 128, 129, 4096):
        assert tcon.shrink_block_k(seq_k) == jcon.shrink_block_k(seq_k)
    for page in (0, 64, 128, 200, 256):
        assert tcon.check_page_size(page) == jcon.check_page_size(page)
    for args in ((32, 8, 128, 4096), (16, 16, 64, 1000), (12, 5, 80, 512),
                 (8, 1, 256, 300)):
        for page in (128, 96):
            assert tcon.check_attention_shapes(*args, page_size=page) == \
                jcon.check_attention_shapes(*args, page_size=page)
    for args in ((32, 8, 14336, 4), (16, 16, 2816, 3), (12, 4, 100, 8)):
        assert tcon.check_tp_divisibility(*args) == jcon.check_tp_divisibility(*args)


@pytest.mark.parametrize("cluster,arch", [
    ((("A", 2), ("B", 2)), "qwen1p5_0p5b"),
    ((("A", 4), ("C", 4)), "granite_8b"),
    ((("B", 8),), "granite_8b"),
])
def test_heteroauto_search_equal_jax(cluster, arch):
    """The copied search finds the JAX package's plan at the same cost.
    ``runtime`` says how the runtime would run the winner: the same for a
    pipe-only plan or one both refuse; a tp or dp layout the JAX runtime
    runs, the port's ``heteropp`` refuses (ROADMAP A8(d)-(g))."""
    from repro_torch.core import heteroauto as tha
    jgroups = [jchips.ChipGroup(jchips.CHIPS[n], c) for n, c in cluster]
    tgroups = [tchips.ChipGroup(tchips.CHIPS[n], c) for n, c in cluster]
    seq = 2048
    want = jha.search(jgroups, jget_config(arch), 16 * seq, seq, two_stage=False)
    got = tha.search(tgroups, tget_config(arch), 16 * seq, seq, two_stage=False)
    assert want.plan is not None
    assert got.plan.to_dict() == want.plan.to_dict()
    assert dataclasses.asdict(got.cost) == dataclasses.asdict(want.cost)
    assert got.evaluated == want.evaluated and got.stage1_dp == want.stage1_dp
    pipe_only = want.plan.dp == 1 and all(st.tp == 1 for st in want.plan.stages)
    if pipe_only or want.runtime.startswith("refused: "):
        assert got.runtime == want.runtime
    else:
        assert got.runtime.startswith("refused: ") and "A8(d)-(g)" in got.runtime
    pinned = tha.search(tgroups, tget_config(arch), 16 * seq, seq, two_stage=False,
                        schedule="1f1b", dp_candidates=[1])
    assert pinned.plan.to_dict() == jha.search(
        jgroups, jget_config(arch), 16 * seq, seq, two_stage=False, schedule="1f1b",
        dp_candidates=[1]).plan.to_dict()


def test_p2p_device_transport_needs_a_card_a_rank(monkeypatch):
    from repro_torch.comm import p2p
    with pytest.raises(ValueError, match="--p2p host"):
        p2p.check_transport("device", torch.device("cpu"), 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks, 1 card.*--p2p host"):
        p2p.check_transport("device", torch.device("cuda"), 2)
    p2p.check_transport("device", torch.device("cuda"), 1)
    p2p.check_transport("host", torch.device("cuda"), 4)
    p2p.check_transport("host", torch.device("cpu"), 4)
    with pytest.raises(ValueError, match="unknown p2p transport"):
        p2p.check_transport("tcp", torch.device("cpu"), 2)
