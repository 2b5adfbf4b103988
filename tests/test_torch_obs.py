"""The port's observability package (``repro_torch.obs``) held against the
JAX package's (``repro.obs``) on the CPU.

(a) The copies: each case of ``tests/test_obs.py`` runs through both
packages and must give equal outputs — the simulator's traces for every
library schedule, the validator's negatives, the metrics-row and
run-directory checks (the plan verifier folded in), the straggler
detector, the alignment report, and the predicted traces of specs and of
a searched plan.  Both packages run the same Python float arithmetic on
the same inputs, so every comparison is exact equality.

(b) The executed trace's structure: ``obs.runtime.trace_pipeline`` on
gloo CPU ranks (1f1b and zb_v at two stages, one spawn of two ranks;
and the launcher's uneven batch domain (3, 2) on a (dp 2, pipe 2) grid)
gives one ``F`` span per active cell of the JAX package's
``spmd_tick_tables`` / ``domain_tick_tables`` (the cells the JAX tracer
emits, ``src/repro/obs/runtime.py:129-145``), a ``B`` span for each,
the reference's predicted tick count, and a trace its validator takes.

(c) A traced loss and its gradients equal the untraced ones bit for bit
(fp32 ``conftest.exact_cfg``).

(d) ``repro_torch.launch.train --trace`` writes a run directory that
``repro_torch.obs.validate --require-trace`` accepts, with
``ticks_match`` in ``align.json``, ``plan.json`` and both straggler
sections when a plan has dp replicas.
"""
import dataclasses
import importlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import heteropp as JHP
from repro_torch.launch import ranks
from test_torch_heteropp import _pair

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests" / "helpers"))
import torch_pipeline_ranks as W  # noqa: E402

FIXTURES = ROOT / "tests" / "fixtures"
PACKAGES = ("repro", "repro_torch")
GRID = [(2, 4), (3, 6), (4, 8), (4, 12)]
MB, SEQ = 2, 32


def _obs(pkg, mod):
    return importlib.import_module(f"{pkg}.obs.{mod}")


def _core(pkg, mod):
    return importlib.import_module(f"{pkg}.core.{mod}")


def _both(fn):
    """``fn(pkg)`` for the JAX package and the port; they must agree."""
    want, got = (fn(pkg) for pkg in PACKAGES)
    assert got == want
    return got


@pytest.fixture(autouse=True)
def _two_threads():
    """Keep the parent's torch to two threads beside the other workers
    (ROADMAP: wall-clock tests share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the copies against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", importlib.import_module(
    "repro.core.schedules").available_schedules())
def test_sim_trace_equal_jax(name):
    """Every op of every library schedule becomes one span, the trace
    passes the validator, its spans replay the simulator's stage busy
    time, and both packages build the same trace."""
    def build(pkg):
        S_ = importlib.import_module(f"{pkg}.core.schedules")
        T = _obs(pkg, "trace")
        sched = S_.get_schedule(name)
        out = []
        for S, b in [(S, b) for S, b in GRID if sched.supports(S, b)]:
            t_fwd = [1.0 + 0.1 * s for s in range(S)]
            sim = S_.simulate(sched, t_fwd, [2.0 * t for t in t_fwd], b,
                              [0.05] * (S - 1), record_spans=True)
            assert len(sim.spans) == sum(len(row) for row in sched.ops(S, b))
            trace = T.build_trace(T.sim_spans(sim), source="predicted", schedule=name,
                                  num_stages=S, n_chunks=sched.n_chunks)
            assert T.validate_trace(trace) == []
            busy = _obs(pkg, "align").per_stage_seconds(trace, kinds=("F", "B", "D", "W"))
            assert [busy[s] for s in range(S)] == pytest.approx(sim.stage_busy)
            out.append(trace)
        assert out
        return out
    _both(build)


def test_sim_trace_records_sync_and_update_equal_jax():
    """A dp-2 plan's grad-sync drains and update tails get their own
    per-stage tracks, in both packages alike."""
    plan_d = json.loads((FIXTURES / "plan_exp_c1_8dev.json").read_text())

    def build(pkg):
        cfg = importlib.import_module(f"{pkg}.configs").get_smoke_config("granite_8b")
        plan = _core(pkg, "cost_model").ParallelPlan.from_dict(plan_d)
        sim = _core(pkg, "schedule").simulate_plan(plan, cfg, 32, grad_sync=True,
                                                   record_spans=True)
        T = _obs(pkg, "trace")
        trace = T.build_trace(T.sim_spans(sim), source="predicted",
                              schedule=plan.schedule, num_stages=plan.total_pp)
        assert {"sync", "U"} <= {sp.kind for sp in sim.spans}
        assert T.validate_trace(trace) == []
        return trace
    tracks = {e["args"]["name"] for e in _both(build)["traceEvents"]
              if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert any("sync" in n for n in tracks) and any("update" in n for n in tracks)


def _span(**kw):
    return dict({"replica": 0, "stage": 0, "chunk": 0, "kind": "F", "mb": 0, "g": 0,
                 "start_s": 0.0, "end_s": 1.0}, **kw)


def _bad_version(T):
    tr = T.build_trace([_span()], source="predicted", num_stages=1)
    tr["metadata"]["schema_version"] = 999
    return tr


TRACE_CASES = {
    "bad_version": (_bad_version, "schema_version"),
    "overlap": (lambda T: T.build_trace([_span(), _span(mb=1, start_s=0.5, end_s=1.5)],
                                        source="predicted", num_stages=1), "overlap"),
    "executed_without_ticks": (lambda T: T.build_trace([_span()], source="executed"),
                               "tick"),
    "executed_ticks_disagree": (lambda T: T.build_trace([_span(tick=0)], source="executed",
                                                        ticks=2), "spans cover"),
    "executed_valid": (lambda T: T.build_trace([_span(tick=0)], source="executed",
                                               ticks=1), None),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_validate_trace_equal_jax(case):
    make, word = TRACE_CASES[case]
    errs = _both(lambda pkg: _obs(pkg, "trace").validate_trace(make(_obs(pkg, "trace"))))
    assert any(word in e for e in errs) if word else errs == []


METRICS_CASES = {
    "empty": [],
    "no_meta": ['{"kind": "metrics", "ts": 1.0}'],
    "unknown_kind": ['{"kind": "meta", "schema_version": 1, "ts": 1.0}',
                     '{"kind": "bogus", "ts": 1.0}'],
    "meta_only": ['{"kind": "meta", "schema_version": 1, "ts": 1.0}'],
    "good": ['{"kind": "meta", "schema_version": 1, "ts": 1.0}', "not json",
             '{"kind": "histogram", "ts": 2.0}', '{"kind": "metrics", "step": 1}'],
}


@pytest.mark.parametrize("case", sorted(METRICS_CASES))
def test_validate_metrics_lines_equal_jax(case):
    _both(lambda pkg: _obs(pkg, "validate").validate_metrics_lines(METRICS_CASES[case]))


def test_metrics_logger_rows_validate_in_both(tmp_path):
    """The port's sink writes rows the JAX package's validator takes, the
    registry's counter included."""
    from repro.obs.validate import validate_metrics_lines as jvalidate
    from repro_torch.obs import MetricsLogger
    with MetricsLogger(str(tmp_path), meta={"arch": "x"}) as log:
        log.registry.counter("steps").inc(3)
        log.registry.gauge("loss").set(1.5)
        log.log(step=1, tokens_per_s=10.0)
        log.registry.histogram("lat").observe(0.1)
        log.log_histogram("lat")
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert jvalidate(lines) == []
    rows = [json.loads(line) for line in lines]
    assert rows[1]["steps"] == 3 and rows[1]["loss"] == 1.5 and rows[2]["count"] == 1


def test_validate_run_dir_equal_jax(tmp_path):
    """A run directory checked at each stage of its making, and with a
    plan folded in through each package's plan verifier: the same errors,
    warnings and CLI exit codes."""
    run = tmp_path / "run"

    def check(**kw):
        def one(pkg):
            V = _obs(pkg, "validate")
            warns = []
            errs = V.validate_run_dir(str(run), warnings=warns, **kw)
            return errs, warns, V.main([str(run)] + (["--require-trace"] if kw else []))
        return _both(one)

    assert any("not a directory" in e for e in check()[0])
    from repro_torch.obs import MetricsLogger, align_traces, build_trace, write_trace
    with MetricsLogger(str(run), meta={}) as log:
        log.log(step=1, loss=2.0)
    assert check() == ([], [], 0)
    assert any("trace_executed" in e for e in check(require_trace=True)[0])
    predicted = build_trace([_span()], source="predicted", num_stages=1, ticks=1)
    executed = build_trace([_span(tick=0)], source="executed", ticks=1)
    write_trace(str(run / "trace_predicted.json"), predicted)
    write_trace(str(run / "trace_executed.json"), executed)
    report = align_traces(predicted, executed)
    (run / "align.json").write_text(json.dumps(report))
    errs, warns, rc = check(require_trace=True)
    assert errs == [] and rc == 0 and any("stragglers" in w for w in warns)
    report["stragglers"] = {}
    report["ticks_match"] = False
    (run / "align.json").write_text(json.dumps(report))
    assert any("ticks_match" in e for e in check()[0])
    report["ticks_match"] = True
    (run / "align.json").write_text(json.dumps(report))
    for plan in (FIXTURES / "plan_exp_c1_8dev.json", FIXTURES / "bad" / "plan_divergent.json"):
        (run / "plan.json").write_text(plan.read_text())
        check(require_trace=True)
    assert check(require_trace=True)[2] == 1


STRAGGLER_CASES = {
    "injected_delay": ([1.0, 1.2, 2.7, 1.1], [1.0, 1.2, 0.9, 1.1], {}),
    "balanced": ([1.0, 1.2, 0.9, 1.1], [1.0, 1.2, 0.9, 1.1], {}),
    "uniform_slowdown": ([2.0, 2.4, 1.8, 2.2], [1.0, 1.2, 0.9, 1.1], {}),
    "single_entry": ([5.0], [1.0], {}),
    "unpriced_entry": ([1.0, 5.0], [0.0, 1.0], {}),
    "factor_3": ([1.0, 1.2, 2.7, 1.1], [1.0, 1.2, 0.9, 1.1], {"factor": 3.5}),
}


@pytest.mark.parametrize("case", sorted(STRAGGLER_CASES))
def test_detect_stragglers_equal_jax(case):
    measured, expected, kw = STRAGGLER_CASES[case]
    rep = _both(lambda pkg: _obs(pkg, "straggler").detect_stragglers(measured, expected,
                                                                     **kw))
    assert rep["flagged"] == ([2] if case == "injected_delay" else [])


def test_straggler_errors_and_replicas_equal_jax():
    for pkg in PACKAGES:
        D = _obs(pkg, "straggler")
        with pytest.raises(ValueError):
            D.detect_stragglers([1.0], [1.0, 2.0])
        with pytest.raises(ValueError):
            D.detect_stragglers([1.0], [1.0], factor=1.0)
    fair = _both(lambda pkg: _obs(pkg, "straggler").replica_stragglers((5, 3), 1.0,
                                                                       [5.0, 3.0]))
    assert fair["flagged"] == [] and fair["pacing_replica"] == 0
    slow = _both(lambda pkg: _obs(pkg, "straggler").replica_stragglers((5, 3), [1.0, 2.0],
                                                                       [5.0, 24.0]))
    assert slow["flagged"] == [1]


def test_stage_stragglers_equal_jax():
    plan_d = json.loads((FIXTURES / "plan_exp_c1_8dev.json").read_text())

    def flagged(pkg):
        cfg = importlib.import_module(f"{pkg}.configs").get_smoke_config("granite_8b")
        CM = _core(pkg, "cost_model")
        plan = CM.ParallelPlan.from_dict(plan_d)
        cost = CM.evaluate(plan, cfg, 32, 8 * 32)
        expected = []
        for st, tc, tr in zip(plan.stages, cost.t_comp,
                              list(cost.t_reshard) or [0.0] * len(plan.stages)):
            expected.extend([plan.microbatches * (tc + tr)] * st.pp)
        slow = list(expected)
        slow[1] *= 5.0
        D = _obs(pkg, "straggler")
        return [D.stage_stragglers(plan, cost, m) for m in (expected, slow)]
    fair, slow = _both(flagged)
    assert fair["flagged"] == [] and slow["flagged"] == [1]


def test_align_synthetic_equal_jax():
    def report(pkg):
        S_ = importlib.import_module(f"{pkg}.core.schedules")
        T, A = _obs(pkg, "trace"), _obs(pkg, "align")
        sim = S_.simulate(S_.get_schedule("1f1b"), [1.0, 1.0], [2.0, 2.0], 2, [0.0],
                          record_spans=True)
        predicted = T.build_trace(
            T.sim_spans(sim), source="predicted", schedule="1f1b", num_stages=2, ticks=3,
            extra_meta={"makespan_s": sim.makespan, "stage_busy_s": list(sim.stage_busy),
                        "exposed_sync_s": list(sim.exposed_sync),
                        "bubble_frac": sim.bubble_frac})
        spans = [_span(stage=s, mb=t, g=s, start_s=t * 0.1, end_s=(t + 1) * 0.1, tick=t)
                 for t in range(3) for s in range(2)]
        out = []
        for ticks in (3, 4):
            executed = T.build_trace(spans, source="executed", schedule="1f1b",
                                     num_stages=2, ticks=ticks, extra_meta={"wall_s": 0.3})
            out.append((A.align_traces(predicted, executed),
                        A.per_replica_seconds(executed)))
        return out
    (good, per_rep), (bad, _) = _both(report)
    assert good["ticks_match"] and good["max_abs_rel_err"] == pytest.approx(0.0)
    assert per_rep[0] == pytest.approx(0.6) and not bad["ticks_match"]


def _spec(pkg, schedule, phys=(1, 1), b=4, **kw):
    HP = _core(pkg, "heteropp")
    sched = importlib.import_module(f"{pkg}.core.schedules").get_schedule(schedule)
    return HP.PipelineSpec(len(phys), HP.chunk_layer_counts(phys, sched), b,
                           schedule=sched.name, n_chunks=sched.n_chunks, **kw)


def _searched_plan(pkg):
    """The winner of an uneven-dp search (A:3, B:3, dp 3, qwen1.5-0.5b)."""
    C, HA = _core(pkg, "chips"), _core(pkg, "heteroauto")
    cfg = importlib.import_module(f"{pkg}.configs").get_config("qwen1p5_0p5b")
    r = HA.search([C.ChipGroup(C.CHIPS["A"], 3), C.ChipGroup(C.CHIPS["B"], 3)], cfg,
                  16 * 2048, 2048, two_stage=False, schedule="1f1b", dp_candidates=[3],
                  uneven_dp=True)
    return r.plan, cfg


PREDICTED_CASES = {
    "1f1b_spec": lambda pkg: _obs(pkg, "trace").predicted_trace_for_spec(
        _spec(pkg, "1f1b", (10, 14))),
    "zb_v_spec": lambda pkg: _obs(pkg, "trace").predicted_trace_for_spec(
        _spec(pkg, "zb_v", (10, 14), data_parallel=2)),
    "searched_plan": lambda pkg: (lambda plan, cfg: _obs(pkg, "trace").predicted_trace_for_plan(
        plan, cfg, 2048, grad_sync=plan.dp > 1))(*_searched_plan(pkg)),
}


@pytest.mark.parametrize("case", sorted(PREDICTED_CASES))
def test_predicted_traces_equal_jax(case):
    trace = _both(lambda pkg: PREDICTED_CASES[case](pkg)[0])
    assert trace["metadata"]["source"] == "predicted" and trace["metadata"]["ticks"] >= 1
    if case == "searched_plan":
        assert trace["metadata"]["dp"] == 3 and any(
            e["args"]["kind"] == "sync" for e in trace["traceEvents"] if e["ph"] == "X")


def test_obs_importable_without_torch():
    """``repro_torch.obs`` and its validator CLI load where torch does not
    exist, as ``repro.obs`` loads without jax."""
    code = ("import sys; sys.modules['torch'] = None\n"
            "from repro_torch.obs import build_trace, validate_trace, percentile\n"
            "from repro_torch.obs.validate import main\n"
            "tr = build_trace([{'replica': 0, 'stage': 0, 'chunk': 0, 'kind': 'F',\n"
            "                   'mb': 0, 'g': 0, 'start_s': 0.0, 'end_s': 1.0}],\n"
            "                 source='predicted')\n"
            "assert validate_trace(tr) == [] and percentile([1.0], 0.95) == 1.0\n"
            "print('NOTORCH_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0 and "NOTORCH_OK" in r.stdout, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# (b), (c): the executed trace on gloo ranks
# ---------------------------------------------------------------------------

def _trace_case(schedule, b, seed, clock_parity=False):
    _, tcfg, tree = _pair("qwen1p5_0p5b", seed=seed)
    tokens = np.random.default_rng(seed + 1).integers(
        0, tcfg.vocab_size, (b, MB, SEQ)).astype(np.int64)
    return {"cfg": dataclasses.asdict(tcfg), "tree": tree, "tokens": tokens,
            "phys": (1, 1), "schedule": schedule, "clock_parity": clock_parity}


TWO_RANK_CASES = {"1f1b": ("1f1b", 4), "zb_v": ("zb_v", 4)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """1f1b (with the clock parity) and zb_v at two stages: one spawn of
    two ranks."""
    cases = [_trace_case(name, b, seed=3, clock_parity=name == "1f1b")
             for name, b in TWO_RANK_CASES.values()]
    res = ranks.spawn(W.trace_cases, 2, ((1, 2, 1), cases),
                      workdir=str(tmp_path_factory.mktemp("trace")), threads=1,
                      timeout=300)
    return {key: [r[i] for r in res] for i, key in enumerate(TWO_RANK_CASES)}


# the launcher's uneven batch domain: a plan of two one-layer stages, two
# dp replicas taking 3 and 2 microbatches of 2 x 32
DOMAIN = (3, 2)
DOMAIN_PLAN = {"dp": 2, "microbatches": 3, "schedule": "1f1b", "dp_sync": "reduce_scatter",
               "dp_transport": "device_rdma", "bucket_bytes": 25 * 2 ** 20,
               "batch_domain": list(DOMAIN),
               "stages": [{"chip": c, "count": 2, "label": "", "tp": 1, "pp": 1,
                           "layers": 1, "recompute": c == "A"} for c in ("A", "B")]}
TRAIN = ["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu", "--steps", "2",
         "--seq", "32", "--log-every", "1", "--p2p", "host", "--trace"]


@pytest.fixture(scope="module")
def domain_run(tmp_path_factory):
    """``launch.train --plan`` of DOMAIN_PLAN with ``--trace``: four ranks."""
    from repro_torch.launch import train
    d = tmp_path_factory.mktemp("domain")
    (d / "plan.in.json").write_text(json.dumps(DOMAIN_PLAN))
    res = train.main(TRAIN + ["--plan", str(d / "plan.in.json"), "--batch",
                              str(MB * sum(DOMAIN)), "--run-dir", str(d / "run")])
    return res, d / "run"


def _reference_cells(schedule, b, domain=()):
    """The (replica, stage, chunk, mb, tick) cells the JAX tracer emits an
    ``F`` span for, and its g of each."""
    from repro.core.schedules import get_schedule
    sched = get_schedule(schedule)
    if domain:
        t = JHP.domain_tick_tables(schedule, 2, domain)
        cells = [(r, s, k) for k in range(t.ticks) for r in range(len(domain))
                 for s in range(2) if t.active[k, r, s]]
        at = lambda r, s, k: (k, r, s)
    else:
        t = JHP.spmd_tick_tables(schedule, 2, b)
        cells = [(0, s, k) for k in range(t.ticks) for s in range(2) if t.active[k, s]]
        at = lambda r, s, k: (k, s)
    return {(r, s, int(t.chunk[at(r, s, k)]), int(t.mb[at(r, s, k)]), k):
            sched.global_stage(s, int(t.chunk[at(r, s, k)]), 2) for r, s, k in cells}


@pytest.mark.parametrize("case", ["1f1b", "zb_v", "domain"])
def test_executed_trace_cells_equal_the_jax_tick_tables(case, request):
    from repro.obs.trace import predicted_trace_for_spec as jpredicted
    from repro_torch.obs.trace import validate_trace
    if case == "domain":
        _, run = request.getfixturevalue("domain_run")
        trace = json.loads((run / "trace_executed.json").read_text())
        schedule, b, domain = "1f1b", max(DOMAIN), DOMAIN
        jspec = JHP.PipelineSpec(2, (1, 1), b, data_parallel=2, batch_domain=domain)
    else:
        res = request.getfixturevalue("two_ranks")[case]
        assert [r["trace"] is None for r in res] == [False, True]
        trace, (schedule, b), domain = res[0]["trace"], TWO_RANK_CASES[case], ()
        jspec = _spec("repro", schedule, b=b)
    want = _reference_cells(schedule, b, domain)
    spans = {kind: {(a["replica"], a["stage"], a["chunk"], a["mb"], a["tick"]): a["g"]
                    for e in trace["traceEvents"] if e["ph"] == "X"
                    for a in [e["args"]] if a["kind"] == kind} for kind in ("F", "B")}
    assert spans["F"] == want and spans["B"] == want
    meta = trace["metadata"]
    assert meta["ticks"] == jpredicted(jspec)[0]["metadata"]["ticks"]
    assert validate_trace(trace) == []
    denom = meta["denom_check"]
    assert denom["measured"] == denom["loss_denom"] == denom["expected"] == \
        sum(domain or [b]) * MB * (SEQ - 1)
    assert len(meta["tick_times_s"]) == len(meta["exchange_s"]) == len(meta["grid"])


def test_traced_loss_and_grads_equal_untraced_bit_for_bit(two_ranks):
    from repro_torch.tree import flatten
    for r in two_ranks["1f1b"]:
        plain, traced = r["untraced"], r["traced"]
        assert torch.equal(plain["loss"], traced["loss"])
        a, b = flatten(plain["grads"]), flatten(traced["grads"])
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# (d) the launcher
# ---------------------------------------------------------------------------

def test_launcher_trace_writes_a_valid_run_dir(tmp_path):
    """``--pipeline-parallel 2 --trace``: the five files but ``plan.json``,
    accepted by the validator CLI, ``ticks_match``, and the rank results
    keep the timed steps' launches apart from the traced pass's."""
    from repro_torch.launch import train
    from repro_torch.obs import validate
    run = tmp_path / "run"
    res = train.main(TRAIN + ["--pipeline-parallel", "2", "--batch", "4", "--run-dir",
                              str(run)])
    assert validate.main(["--require-trace", str(run)]) == 0
    align = json.loads((run / "align.json").read_text())
    assert align["ticks_match"] and align["stragglers"] == {}
    assert not (run / "plan.json").exists()
    assert res["trace"]["ticks_match"] and len(res["trace"]["stage_f_s"]) == 2
    assert all(v > 0 for v in res["trace"]["stage_f_s"] + res["trace"]["stage_b_s"])
    assert res["trace_launches"] == {k: 0 for k in res["launches"]}


def test_launcher_trace_with_an_uneven_domain_plan(domain_run):
    """``--plan`` with dp 2 and the domain (3, 2): ``plan.json`` (folded
    through the plan verifier), both straggler sections, the priced
    expectations in the meta row, and the pacing replica's tick count."""
    from repro_torch.obs import validate
    res, run = domain_run
    assert validate.main(["--require-trace", str(run)]) == 0
    align = json.loads((run / "align.json").read_text())
    assert align["ticks_match"] and align["executed_ticks"] == max(DOMAIN) + 1
    assert set(align["stragglers"]) == {"stage", "replica"}
    assert [e["expected_s"] for e in align["stragglers"]["replica"]["entries"]] == \
        [float(a) for a in DOMAIN]
    assert json.loads((run / "plan.json").read_text())["batch_domain"] == list(DOMAIN)
    meta = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    assert {"priced_iter_time_s", "priced_tgs", "priced_exposed_sync_s",
            "priced_reshard_s"} <= meta.keys()
    assert sorted(set(res["ticks_per_rank"])) == [a + 1 for a in sorted(DOMAIN)]


def test_launcher_trains_and_traces_a_plan_the_cost_model_cannot_price(tmp_path):
    """A per-leaf psum plan (bucket_bytes 0), which the plan verifier
    refuses and the cost model cannot price, run past ``--no-verify-plan``:
    it trains and traces, its meta row says why it has no price, the
    stage stragglers (which need the price) are left out, and the run
    directory fails validation on ``plan.json`` alone."""
    from repro_torch.launch import train
    from repro_torch.obs.validate import validate_run_dir
    plan = dict(DOMAIN_PLAN, dp_sync="psum", bucket_bytes=0)
    (tmp_path / "plan.in.json").write_text(json.dumps(plan))
    run = tmp_path / "run"
    res = train.main(TRAIN + ["--plan", str(tmp_path / "plan.in.json"), "--no-verify-plan",
                              "--batch", str(MB * sum(DOMAIN)), "--run-dir", str(run)])
    assert len(res["losses"]) == 2 and res["trace"]["ticks_match"]
    meta = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    assert "bucket_bytes" in meta["priced_error"] and "priced_tgs" not in meta
    assert set(json.loads((run / "align.json").read_text())["stragglers"]) == {"replica"}
    errs = validate_run_dir(str(run), require_trace=True)
    assert errs and all(e.startswith("plan.json: ") for e in errs)


@pytest.mark.parametrize("dp_sync, bucket_bytes, refused", [
    ("psum", 0, False), ("psum", 25 * 2 ** 20, True), ("reduce_scatter", 0, True)])
def test_launcher_prices_a_plan_or_raises(monkeypatch, dp_sync, bucket_bytes, refused):
    """Only a per-leaf psum plan (``bucket_bytes`` 0) trains unpriced when
    the cost model raises; on any other plan its fault is raised, as the
    JAX launcher raises it."""
    from types import SimpleNamespace

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import cost_model
    from repro_torch.launch import train

    def fault(*_, **__):
        raise ValueError("cannot price")

    monkeypatch.setattr(cost_model, "evaluate", fault)
    cfg, args = get_smoke_config("qwen1p5_0p5b"), SimpleNamespace(seq=32, batch=8)
    plan = dict(DOMAIN_PLAN, dp_sync=dp_sync, bucket_bytes=bucket_bytes)
    if refused:
        with pytest.raises(ValueError, match="cannot price"):
            train._price_plan(plan, cfg, args)
    else:
        got, cost, priced = train._price_plan(plan, cfg, args)
        assert got.dp_sync == "psum" and cost is None
        assert priced == {"priced_error": "cannot price"}


@pytest.mark.parametrize("ce_tokens, denom, holds", [
    (31.0, 31.0, True), (0.0, 31.0, False), (31.0, 62.0, False)])
def test_executed_trace_denominator_check(ce_tokens, denom, holds):
    """The executed trace holds the tokens the CE consumed and the loss's
    denominator, each, to Σ allocations × mb_size × (seq − 1), and raises
    when either differs: one stage, one microbatch of 1 × 32 tokens."""
    from types import SimpleNamespace

    from repro_torch.core.schedules import get_schedule
    from repro_torch.obs import runtime

    spec = SimpleNamespace(num_stages=1, n_chunks=1, data_parallel=1, batch_allocations=(1,))
    rank = {"grid": [0, 0, 0], "ce_tokens": ce_tokens, "denom": denom, "launches": {},
            "peak_bytes_in_use": None,
            "stamps": {"forward": [(0, True, 0, 0, True, 0.0, 1.0, 1.5)],
                       "backward": [(0, True, 1.5, 3.0, 3.5)]}}
    if not holds:
        with pytest.raises(RuntimeError, match="traced denominator"):
            runtime._executed_trace(spec, get_schedule("1f1b"), [rank], 1.0, (1, 1, 32))
        return
    trace = runtime._executed_trace(spec, get_schedule("1f1b"), [rank], 1.0, (1, 1, 32))
    assert trace["metadata"]["denom_check"] == {"measured": 31.0, "loss_denom": 31.0,
                                                "expected": 31.0}
    assert [e["args"]["kind"] for e in trace["traceEvents"] if e["ph"] == "X"] == ["F", "B"]
