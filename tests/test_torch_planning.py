"""The port's planning modules against the JAX package's: the chip
catalog, the schedule simulator, the HeteroPP cost model and plan
replay, the data-parallel and resharding closed forms, the transport
model.  Both packages run the same Python float arithmetic on the same
inputs, so every comparison is exact equality."""
import dataclasses

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
    assert tavailable() == javailable()
    with pytest.raises(NotImplementedError, match="HeteroPP"):
        tget_schedule("1f1b").verify(4, 8)


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
