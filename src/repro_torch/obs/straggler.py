"""Straggler / imbalance detector (DESIGN.md §14): the signal a
heterogeneous cluster needs before an elastic re-search.

A straggler is an entry whose measured-over-expected ratio exceeds the
cohort's MEDIAN ratio by a configurable factor.  Normalizing by the
median is the load-bearing choice: a uniformly slow run (every chip 2×
the analytic profile — wrong calibration, not a straggler) flags
nothing, while one replica or stage falling behind its *priced share*
flags exactly that entry.  The expected shares come from the artifacts
the planner already prices: ``dataparallel.domain_cost`` per-replica
times for the dp axis (the §4.3 pacing argmax) and the ``PlanCost``
per-stage compute terms for the pipe axis.

Pure arithmetic on measured/expected sequences.  A copy of
``repro/obs/straggler.py``, held equal to it by ``tests/test_torch_obs.py``.
"""
from __future__ import annotations

from typing import List, Sequence

STRAGGLER_SCHEMA_VERSION = 1


def _median(xs: Sequence[float]) -> float:
    srt = sorted(xs)
    n = len(srt)
    mid = n // 2
    return srt[mid] if n % 2 else 0.5 * (srt[mid - 1] + srt[mid])


def detect_stragglers(measured: Sequence[float],
                      expected: Sequence[float], *,
                      factor: float = 1.5, kind: str = "stage") -> dict:
    """Flag indices whose measured/expected ratio exceeds
    ``factor × median(ratios)``.  A single-entry cohort never flags
    (no peer to be slower than); non-positive expected entries are
    skipped (nothing was priced there)."""
    if len(measured) != len(expected):
        raise ValueError(f"measured has {len(measured)} entries but "
                         f"expected has {len(expected)}")
    if factor <= 1.0:
        raise ValueError(f"factor must exceed 1.0: {factor}")
    ratios = {i: m / e for i, (m, e) in enumerate(zip(measured, expected))
              if e > 0.0}
    med = _median(list(ratios.values())) if ratios else 0.0
    entries: List[dict] = []
    flagged: List[int] = []
    for i, (m, e) in enumerate(zip(measured, expected)):
        r = ratios.get(i)
        flag = (r is not None and len(ratios) > 1 and med > 0.0
                and r > factor * med)
        if flag:
            flagged.append(i)
        entries.append({"index": i, "measured_s": float(m),
                        "expected_s": float(e), "ratio": r,
                        "flagged": flag})
    return {"schema_version": STRAGGLER_SCHEMA_VERSION, "kind": kind,
            "factor": factor, "median_ratio": med or None,
            "entries": entries, "flagged": flagged}


def replica_stragglers(allocations: Sequence[int], t_microbatch,
                       measured: Sequence[float], *,
                       factor: float = 1.5) -> dict:
    """dp-axis detector: expected per-replica times are the plan's
    priced pacing allocation (``domain_cost`` — replica r carries
    ``allocations[r]`` microbatches at ``t_microbatch`` each, the
    §4.3.2 pacing-argmax accounting).  ``t_microbatch`` is one float
    (identical pipelines per replica) or a per-replica sequence."""
    from ..core.dataparallel import BatchDomain, domain_cost
    alloc = tuple(int(a) for a in allocations)
    t = list(t_microbatch) if isinstance(t_microbatch, (list, tuple)) \
        else [float(t_microbatch)] * len(alloc)
    domain = BatchDomain(alloc, tuple(1.0 / ti for ti in t))
    cost = domain_cost(domain, t)
    rep = detect_stragglers(measured, cost["replica_times"],
                            factor=factor, kind="replica")
    rep["pacing_replica"] = cost["pacing_replica"]
    rep["priced_imbalance"] = cost["imbalance"]
    return rep


def stage_stragglers(plan, cost, measured: Sequence[float], *,
                     factor: float = 1.5) -> dict:
    """pipe-axis detector: expected per-PHYSICAL-stage time expands the
    ``PlanCost`` per-stage-TYPE terms (b·(t_comp + t_reshard), the
    compute leg of the §4.3.2 iteration time) over each type's pp
    stages."""
    b = plan.microbatches
    resh = list(cost.t_reshard) or [0.0] * len(plan.stages)
    expected: List[float] = []
    for st, tc, tr in zip(plan.stages, cost.t_comp, resh):
        expected.extend([b * (tc + tr)] * st.pp)
    return detect_stragglers(measured, expected, factor=factor,
                             kind="stage")
