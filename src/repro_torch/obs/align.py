"""Predicted-vs-executed alignment report (DESIGN.md §14) — the runtime
analogue of the cost-model-vs-simulator regression tests.

Both inputs are ``obs.trace`` dicts.  The executed timeline is the
runtime's fenced tick stamps, the predicted one is event-driven — so
the report compares what is actually comparable:

* **tick count** — the executed program must run exactly the ticks the
  planner priced (``metadata.ticks`` on both sides; the pacing
  contract of DESIGN.md §13);
* **per-stage forward share** — each stage's fraction of total
  forward seconds, predicted (F spans) vs executed (the active forward
  ticks' F spans).  ``rel_err`` is the executed share against the
  predicted share; large values mean the plan's layer split does not
  match where the runtime actually spends its ticks;
* **pacing-stage idle and exposed-sync tail** — carried from the
  predicted side's metadata: how much of the predicted makespan is
  bubble on the pacing stage, and the non-overlapped grad-sync tail
  per stage.  Together with the share drift these are the actionable
  numbers: share drift → re-split layers (re-search), exposed tail →
  re-bucket/overlap, tick mismatch → a runtime bug, full stop.

Operates on trace dicts only.  A copy of ``repro/obs/align.py``, held
equal to it by ``tests/test_torch_obs.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .trace import trace_op_events

ALIGN_SCHEMA_VERSION = 1


def per_stage_seconds(trace: dict, *, kinds=("F",)) -> Dict[int, float]:
    """Total span seconds per stage (compute-op events of ``kinds``)."""
    out: Dict[int, float] = {}
    for e in trace_op_events(trace):
        if e["args"]["kind"] in kinds:
            s = int(e["args"]["stage"])
            out[s] = out.get(s, 0.0) + e["dur"] / 1e6
    return out


def per_replica_seconds(trace: dict) -> Dict[int, float]:
    """Total compute-op span seconds per dp replica — the measured side
    of the replica straggler detector."""
    out: Dict[int, float] = {}
    for e in trace_op_events(trace):
        r = int(e["args"].get("replica", e.get("pid", 0)))
        out[r] = out.get(r, 0.0) + e["dur"] / 1e6
    return out


def align_traces(predicted: dict, executed: dict) -> dict:
    """Overlay a predicted and an executed trace; returns the JSON-ready
    alignment report described in the module docstring."""
    pm = predicted.get("metadata", {})
    em = executed.get("metadata", {})
    S = int(pm.get("num_stages") or em.get("num_stages") or 0)
    priced_ticks = pm.get("ticks")
    executed_ticks = em.get("ticks")
    pred = per_stage_seconds(predicted, kinds=("F",))
    exe = per_stage_seconds(executed, kinds=("F",))
    stages = sorted(set(pred) | set(exe) | set(range(S)))
    pred_tot = sum(pred.values())
    exe_tot = sum(exe.values())
    per_stage: List[dict] = []
    max_err: Optional[float] = None
    for s in stages:
        p_share = pred.get(s, 0.0) / pred_tot if pred_tot else 0.0
        e_share = exe.get(s, 0.0) / exe_tot if exe_tot else 0.0
        rel = (e_share / p_share - 1.0) if p_share > 0 else None
        if rel is not None:
            max_err = rel if max_err is None else \
                max(max_err, rel, key=abs)
        per_stage.append({
            "stage": s,
            "predicted_fwd_s": pred.get(s, 0.0),
            "executed_s": exe.get(s, 0.0),
            "predicted_share": p_share,
            "executed_share": e_share,
            "rel_err": rel,
        })
    busy = pm.get("stage_busy_s") or []
    makespan = pm.get("makespan_s")
    pacing = max(range(len(busy)), key=lambda i: busy[i]) if busy else None
    pacing_idle = (makespan - busy[pacing]) \
        if busy and makespan is not None else None
    return {
        "schema_version": ALIGN_SCHEMA_VERSION,
        "priced_ticks": priced_ticks,
        "executed_ticks": executed_ticks,
        "ticks_match": (priced_ticks is not None
                        and priced_ticks == executed_ticks),
        "per_stage": per_stage,
        "max_abs_rel_err": abs(max_err) if max_err is not None else None,
        "predicted_makespan_s": makespan,
        "executed_wall_s": em.get("wall_s"),
        "pacing_stage": pacing,
        "pacing_stage_idle_s": pacing_idle,
        "exposed_sync_s": pm.get("exposed_sync_s"),
        "predicted_bubble_frac": pm.get("bubble_frac"),
        "schedule": pm.get("schedule") or em.get("schedule"),
    }
