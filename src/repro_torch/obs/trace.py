"""Chrome/Perfetto ``trace_events`` export of pipeline timelines
(DESIGN.md §14).

One schema for BOTH timelines so they overlay in one Perfetto window:

* *predicted* — the event simulator's per-op spans
  (``schedules.simulate(record_spans=True)``: F/B/D/W ops, sync
  drains, update tails);
* *executed* — the pipeline runtime's fenced tick stamps
  (``obs.runtime.trace_pipeline``: one ``F`` span per active forward
  tick and one ``B`` span per active backward tick of each (replica,
  stage), each stamp after a device synchronize).

Layout: one *process* per dp replica, one *thread* (track) per
(stage, chunk) — sync drains and the optimizer update get their own
per-stage tracks so the compute tracks stay overlap-free by
construction.  Timestamps are microseconds (the trace_events unit);
span ``args`` carry the structured fields (kind/stage/chunk/mb/g/tick)
so the alignment report and the validator never re-parse display
names.  The top-level ``metadata`` object is versioned.  A copy of
``repro/obs/trace.py`` (the same schema, held equal to it by
``tests/test_torch_obs.py``); the two ``predicted_trace_for_*`` functions
import the port's planning core lazily, so the validator path never
loads it.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

TRACE_SCHEMA_VERSION = 1
SOURCE_PREDICTED = "predicted"
SOURCE_EXECUTED = "executed"
# per-track overlap slack, in µs (float round-off, not real overlap)
_EPS_US = 1e-3

_OP_KINDS = ("F", "B", "D", "W")


def sim_spans(sim) -> List[dict]:
    """Normalize a ``SimResult``'s recorded ``OpSpan``s (seconds) to the
    span dicts ``build_trace`` consumes (the simulator models one
    replica; dp replicas run the same predicted program)."""
    out = []
    for sp in sim.spans:
        out.append({"replica": 0, "stage": sp.stage, "chunk": sp.chunk,
                    "kind": sp.kind, "mb": sp.mb, "g": sp.g,
                    "start_s": sp.start, "end_s": sp.end})
    return out


def _track_key(span: dict) -> Tuple[int, tuple]:
    kind = span["kind"]
    if kind in _OP_KINDS:
        return span["stage"], (0, span["chunk"])
    if kind == "sync":
        return span["stage"], (1, 0)
    return span["stage"], (2, 0)          # update tail


def _track_name(stage: int, key: tuple, n_chunks: int) -> str:
    group, chunk = key
    if group == 1:
        return f"stage {stage} sync"
    if group == 2:
        return f"stage {stage} update"
    if n_chunks > 1:
        return f"stage {stage} chunk {chunk}"
    return f"stage {stage}"


def build_trace(spans: List[dict], *, source: str, schedule: str = "",
                num_stages: int = 0, n_chunks: int = 1, dp: int = 1,
                ticks: Optional[int] = None,
                extra_meta: Optional[dict] = None) -> dict:
    """Spans (``start_s``/``end_s`` seconds) → a Perfetto-loadable
    trace dict: ``X`` duration events in µs on (pid=replica,
    tid=(stage, chunk)) tracks, ``M`` metadata naming every track, and
    a versioned top-level ``metadata`` object."""
    if source not in (SOURCE_PREDICTED, SOURCE_EXECUTED):
        raise ValueError(f"source must be predicted|executed: {source!r}")
    events: List[dict] = []
    # deterministic tid assignment: per replica, tracks sorted by
    # (stage, group, chunk)
    tracks: Dict[int, List[Tuple[int, tuple]]] = {}
    for sp in spans:
        key = _track_key(sp)
        tracks.setdefault(sp["replica"], [])
        if key not in tracks[sp["replica"]]:
            tracks[sp["replica"]].append(key)
    tid_of: Dict[Tuple[int, int, tuple], int] = {}
    for r, keys in sorted(tracks.items()):
        events.append({"ph": "M", "name": "process_name", "pid": r,
                       "args": {"name": f"replica {r}"}})
        for tid, (stage, key) in enumerate(sorted(keys)):
            tid_of[(r, stage, key)] = tid
            events.append({"ph": "M", "name": "thread_name", "pid": r,
                           "tid": tid,
                           "args": {"name": _track_name(stage, key,
                                                        n_chunks)}})
    for sp in sorted(spans, key=lambda s: (s["replica"], _track_key(s),
                                           s["start_s"])):
        stage, key = _track_key(sp)
        kind = sp["kind"]
        if kind in _OP_KINDS:
            name = f"{kind} mb{sp['mb']}"
            if n_chunks > 1:
                name += f" c{sp['chunk']}"
        elif kind == "sync":
            name = f"sync b{sp['mb']}"
        else:
            name = "update"
        args = {"kind": kind, "stage": stage, "chunk": sp["chunk"],
                "mb": sp["mb"], "g": sp.get("g", -1),
                "replica": sp["replica"]}
        if "tick" in sp:
            args["tick"] = sp["tick"]
        events.append({
            "ph": "X", "name": name, "cat": kind,
            "pid": sp["replica"], "tid": tid_of[(sp["replica"], stage, key)],
            "ts": sp["start_s"] * 1e6,
            "dur": (sp["end_s"] - sp["start_s"]) * 1e6,
            "args": args,
        })
    meta = {"schema_version": TRACE_SCHEMA_VERSION, "source": source,
            "schedule": schedule, "num_stages": num_stages,
            "n_chunks": n_chunks, "dp": dp}
    if ticks is not None:
        meta["ticks"] = int(ticks)
    if extra_meta:
        meta.update(extra_meta)
    return {"displayTimeUnit": "ms", "metadata": meta,
            "traceEvents": events}


def write_trace(path: str, trace: dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)


def trace_op_events(trace: dict) -> List[dict]:
    """The compute-op ``X`` events (F/B/D/W) of a trace."""
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X"
            and e.get("args", {}).get("kind") in _OP_KINDS]


def validate_trace(trace: dict) -> List[str]:
    """Schema + conformance check (the CI gate).  Returns a
    list of error strings — empty means valid: versioned metadata, every
    duration event well-formed, per-track timestamps monotone in file
    order with no intra-track overlap, and (executed traces) the tick
    count advertised in metadata matching the spans."""
    errs: List[str] = []
    if not isinstance(trace, dict) or \
            not isinstance(trace.get("traceEvents"), list):
        return ["trace is not a dict with a traceEvents list"]
    meta = trace.get("metadata")
    if not isinstance(meta, dict):
        return ["missing top-level metadata object"]
    if meta.get("schema_version") != TRACE_SCHEMA_VERSION:
        errs.append(f"schema_version {meta.get('schema_version')!r} != "
                    f"{TRACE_SCHEMA_VERSION}")
    source = meta.get("source")
    if source not in (SOURCE_PREDICTED, SOURCE_EXECUTED):
        errs.append(f"metadata.source {source!r} not in "
                    f"(predicted, executed)")
    by_track: Dict[Tuple[int, int], List[dict]] = {}
    max_tick = -1
    for i, e in enumerate(trace["traceEvents"]):
        ph = e.get("ph")
        if ph == "M":
            continue
        if ph != "X":
            errs.append(f"event {i}: unsupported phase {ph!r}")
            continue
        ts, dur = e.get("ts"), e.get("dur")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"event {i}: bad ts {ts!r}")
            continue
        if not isinstance(dur, (int, float)) or dur < 0:
            errs.append(f"event {i}: bad dur {dur!r}")
            continue
        args = e.get("args")
        if not isinstance(args, dict) or "kind" not in args \
                or "stage" not in args:
            errs.append(f"event {i}: args must carry kind and stage")
            continue
        if source == SOURCE_EXECUTED:
            if not isinstance(args.get("tick"), int):
                errs.append(f"event {i}: executed span missing args.tick")
            else:
                max_tick = max(max_tick, args["tick"])
        by_track.setdefault((e.get("pid", 0), e.get("tid", 0)),
                            []).append(e)
    for (pid, tid), evs in by_track.items():
        end = -1.0
        prev_ts = -1.0
        for e in evs:
            if e["ts"] < prev_ts:
                errs.append(f"track (pid={pid}, tid={tid}): timestamps "
                            f"not monotone at ts={e['ts']}")
            if e["ts"] < end - _EPS_US:
                errs.append(f"track (pid={pid}, tid={tid}): span at "
                            f"ts={e['ts']} overlaps previous "
                            f"(ends {end})")
            prev_ts = e["ts"]
            end = max(end, e["ts"] + e["dur"])
    if source == SOURCE_EXECUTED:
        ticks = meta.get("ticks")
        if not isinstance(ticks, int) or ticks < 1:
            errs.append(f"executed trace missing metadata.ticks: {ticks!r}")
        elif max_tick >= 0 and max_tick + 1 != ticks:
            errs.append(f"metadata.ticks={ticks} but spans cover "
                        f"{max_tick + 1} ticks")
    return errs


# ---------------------------------------------------------------------------
# predicted traces (lazy core imports)
# ---------------------------------------------------------------------------

def predicted_trace_for_plan(plan, cfg, seq_len: int, *,
                             grad_sync: bool = False, **simulate_kw):
    """Replay a HeteroAuto plan through the event simulator with span
    recording and export the predicted timeline.  Returns
    ``(trace, sim)``; the trace's metadata carries the priced tick
    count (``tickprogram.spmd_tick_tables`` on the plan's schedule and
    pacing microbatch count) plus the simulator's makespan /
    exposed-sync / stage-busy vectors for the alignment report."""
    from ..core.tickprogram import spmd_tick_tables
    from ..core.schedule import simulate_plan
    from ..core.schedules import get_schedule
    sched = get_schedule(plan.schedule)
    sim = simulate_plan(plan, cfg, seq_len, grad_sync=grad_sync,
                        record_spans=True, **simulate_kw)
    tables = spmd_tick_tables(sched, plan.total_pp, plan.microbatches)
    trace = build_trace(
        sim_spans(sim), source=SOURCE_PREDICTED, schedule=sched.name,
        num_stages=plan.total_pp, n_chunks=sched.n_chunks, dp=plan.dp,
        ticks=tables.ticks,
        extra_meta={"makespan_s": sim.makespan,
                    "stage_busy_s": list(sim.stage_busy),
                    "exposed_sync_s": list(sim.exposed_sync),
                    "bubble_frac": sim.bubble_frac})
    return trace, sim


def predicted_trace_for_spec(spec, *, schedule: Optional[str] = None):
    """Predicted timeline for a CLI-built ``PipelineSpec`` (no chip
    profiles): layer counts stand in for stage times (backward charged
    2×), which preserves the op structure, tick count, and relative
    shares — enough for structural alignment.  Returns
    ``(trace, sim)``."""
    from ..core.tickprogram import spmd_tick_tables
    from ..core.schedules import get_schedule, simulate
    sched = get_schedule(schedule or spec.schedule)
    S, v = spec.num_stages, spec.n_chunks
    lps = spec.layers_per_stage
    t_fwd = [float(sum(lps[s * v + k] for k in range(v)))
             for s in range(S)] if len(lps) == S * v \
        else [float(lps[s]) for s in range(S)]
    sim = simulate(sched, t_fwd, [2.0 * t for t in t_fwd],
                   spec.microbatches, [0.0] * (S - 1), record_spans=True)
    tables = spmd_tick_tables(sched, S, spec.microbatches)
    trace = build_trace(
        sim_spans(sim), source=SOURCE_PREDICTED, schedule=sched.name,
        num_stages=S, n_chunks=v, dp=spec.data_parallel,
        ticks=tables.ticks,
        extra_meta={"makespan_s": sim.makespan,
                    "stage_busy_s": list(sim.stage_busy),
                    "exposed_sync_s": list(sim.exposed_sync),
                    "bubble_frac": sim.bubble_frac, "unit_times": True})
    return trace, sim
