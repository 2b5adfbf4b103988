"""The port's auto-profiler against the JAX package's: the analytic layer
profile (a copy, so equal exactly), and the measured profile on the CPU
(the same fields, from the port's model at the size it is given, where
the reference cuts the model and the sequence itself), which reprices
plans through the cost model and the schedule replay."""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro.core import chips as jchips, profiler as jprof
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch.core import chips as tchips, cost_model as tcm, profiler as tprof
from repro_torch.core import schedule as tsched
from repro_torch.models import transformer as ttfm
from repro_torch.models.config import reduced


class _Stop(Exception):
    """Raised by a wrapped block_forward once it has seen its input."""


def _measure_cpu(name, seq=64):
    return tprof.measure_layer_profile(reduced(tconfigs.get_config(name)), seq,
                                       iters=1, backend="einsum", device="cpu")


@pytest.mark.parametrize("arch", jconfigs.list_configs())
def test_analytic_profile_equal_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tprof.layer_flops_per_token(tcfg) == jprof.layer_flops_per_token(jcfg)
    assert tprof.layer_param_count(tcfg) == jprof.layer_param_count(jcfg)
    for chip in jchips.CHIPS:
        jspec, tspec = jchips.CHIPS[chip], tchips.CHIPS[chip]
        for tp in (1, 2, 4):
            want = jprof.analytic_layer_profile(jspec, jcfg, tp, 4096)
            got = tprof.analytic_layer_profile(tspec, tcfg, tp, 4096)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert tprof.update_time(tspec, tcfg, tp, 4, 9.0) == \
                jprof.update_time(jspec, jcfg, tp, 4, 9.0)
            assert tprof.offload_time(tspec, tcfg, tp, 9.0, 3e9) == \
                jprof.offload_time(jspec, jcfg, tp, 9.0, 3e9)
        assert tprof.optimizer_step_time(tspec) == jprof.optimizer_step_time(jspec)


def test_apply_measured_equal_jax():
    assert tprof.MEASURED_TIME_FIELDS == jprof.MEASURED_TIME_FIELDS
    cfg = tconfigs.get_config("granite_8b")
    prof = tprof.analytic_layer_profile(tchips.CHIPS["B"], cfg, 2, 2048)
    jp = jprof.analytic_layer_profile(jchips.CHIPS["B"], jconfigs.get_config("granite_8b"),
                                      2, 2048)
    meas = {"t_fwd": 1e-3, "wgrad_frac": 0.3, "t_attn": 5.0, "backend": "kernel"}
    assert dataclasses.asdict(tprof.apply_measured(prof, meas)) == \
        dataclasses.asdict(jprof.apply_measured(jp, meas))
    assert tprof.apply_measured(prof, None) is prof
    assert tprof.apply_measured(prof, {"t_attn": 1.0}) is prof


@pytest.mark.parametrize("arch", ["granite_8b", "mamba2_780m"])
def test_measured_profile_fields_match_jax(arch):
    """The reference reduces the config itself; the port is handed the
    reduced config.  Same keys, positive times, ``t_ssd`` for the ssm
    config only, and the resolved backend recorded."""
    want = jprof.measure_layer_profile(jconfigs.get_config(arch), 64, iters=1)
    got = _measure_cpu(arch)
    assert set(got) == set(want)
    assert ("t_ssd" in got) == (arch == "mamba2_780m")
    assert got["backend"] == "einsum" and want["backend"] == "einsum"
    for key, value in got.items():
        if key not in ("backend", "t_wgrad"):
            assert value > 0, (key, got)
    assert got["t_wgrad"] >= 0.0             # the pairs' median difference, noise-clamped
    assert 0.05 <= got["wgrad_frac"] <= 0.95
    assert got["t_recomp"] == got["t_fwd"]
    auto = tprof.measure_layer_profile(reduced(tconfigs.get_config(arch)), 32, iters=1,
                                       device="cpu")
    assert auto["backend"] == "einsum"       # "auto" on CPU tensors


def test_host_stall_in_a_full_backward_keeps_dgrad_positive(monkeypatch):
    """A host stall planted in one timed full backward of the wgrad pairs
    (0.3 s, far past the block's backward at this size) leaves every
    field finite: ``t_dgrad`` the input-only backward of the same pairs,
    above 0, and ``t_wgrad`` within [0, ``t_bwd``]."""
    import math
    import time

    import torch
    grad, seen = torch.autograd.grad, []

    def stalled(outputs, inputs, *a, **kw):
        if kw.get("retain_graph") and len(inputs) > 1:
            seen.append(1)
            if len(seen) == 2:                # the first timed one, after the warm call
                time.sleep(0.3)
        return grad(outputs, inputs, *a, **kw)

    monkeypatch.setattr(torch.autograd, "grad", stalled)
    got = _measure_cpu("granite_8b")
    assert len(seen) == 2
    assert all(math.isfinite(v) for k, v in got.items() if k != "backend"), got
    assert got["t_dgrad"] > 0, got
    assert 0.0 <= got["t_wgrad"] <= got["t_bwd"], got
    assert 0.05 <= got["wgrad_frac"] <= 0.95


def test_reference_times_a_cut_block_the_port_times_what_it_is_given(monkeypatch):
    """The reference replaces the model with ``reduced(cfg)`` and caps
    the sequence at 256 before timing (``profiler.py:225,229``): for
    granite-8b at seq 4096 its block input is (1, 256, 256), though its
    result is laid over the analytic profile of the full layer at 4096.
    The port's block input is the config and length it was given."""
    seen = {}

    def recorder(tag):
        def block_forward(p, cfg, x, *args, **kw):
            seen[tag] = tuple(x.shape)
            raise _Stop
        return block_forward

    monkeypatch.setattr(jtfm, "block_forward", recorder("jax"))
    with pytest.raises(_Stop):
        jprof.measure_layer_profile(jconfigs.get_config("granite_8b"), 4096)
    monkeypatch.setattr(ttfm, "block_forward", recorder("port"))
    cfg = reduced(tconfigs.get_config("granite_8b"), d_model=384)
    with pytest.raises(_Stop):
        tprof.measure_layer_profile(cfg, 320, backend="einsum", device="cpu")
    assert seen == {"jax": (1, 256, 256), "port": (1, 320, 384)}


def test_moe_config_raises(monkeypatch):
    """A MoE config does not raise: as in the reference
    (``profiler.py:227``) the timed block is a ``moe`` one, and the
    profile has the dense profile's fields."""
    kinds = []
    block_forward = ttfm.block_forward

    def recorder(p, cfg, x, kind, **kw):
        kinds.append(kind)
        return block_forward(p, cfg, x, kind, **kw)

    monkeypatch.setattr(ttfm, "block_forward", recorder)
    got = _measure_cpu("qwen3_moe_30b_a3b")
    assert set(kinds) == {"moe"}
    assert set(got) == set(_measure_cpu("granite_8b")) and "t_ssd" not in got
    for key, value in got.items():
        if key not in ("backend", "t_wgrad"):
            assert value > 0, (key, got)


def test_kernel_backend_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        tprof.measure_layer_profile(reduced(tconfigs.get_config("granite_8b")), 64,
                                    backend="kernel", device="cpu")


def test_measured_profile_reprices_evaluate_and_replay():
    """The port's measured dict reaches both rankers, as in
    ``tests/test_dataparallel.py::test_evaluate_and_replay_consume_measured_times``:
    ``evaluate`` reprices the plan and the replay gets chip A's measured
    per-stage times while chip B keeps its analytic ones."""
    cfg = tconfigs.get_smoke_config("granite_8b")
    g = lambda n: tchips.ChipGroup(tchips.CHIPS[n], 4)
    plan = tcm.ParallelPlan([tcm.StagePlan(g("A"), 2, 1, 1, False),
                             tcm.StagePlan(g("B"), 2, 1, 1, False)],
                            dp=2, microbatches=4)
    meas = {"A": _measure_cpu("granite_8b")}

    base = tcm.evaluate(plan, cfg, 128, 1e6)
    mod = tcm.evaluate(plan, cfg, 128, 1e6, measured=meas)
    assert mod.iter_time > base.iter_time    # a CPU block dwarfs chip A's roofline

    tf0, *_ = tsched.plan_to_schedule_inputs(plan, cfg, 128)
    tf1, tb1, _, _, _, wf1 = tsched.plan_to_schedule_inputs(plan, cfg, 128,
                                                            measured=meas)
    lps = plan.stages[0].layers_per_stage
    assert tf1[0] == pytest.approx(lps * meas["A"]["t_fwd"])
    assert tb1[0] == pytest.approx(lps * meas["A"]["t_bwd"])
    assert wf1[0] == meas["A"]["wgrad_frac"]
    assert tf1[-1] == tf0[-1]
    r = tsched.simulate_plan(plan, cfg, 128, measured=meas)
    r0 = tsched.simulate_plan(plan, cfg, 128)
    assert r.makespan > r0.makespan
