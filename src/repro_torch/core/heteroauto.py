"""HeteroAuto — automatic parallelism-strategy search (paper §4.3.3).

Procedure (faithful to the paper):
  1. DFS over the parallelism space: candidate data-parallel degrees s_dp
     (divisors of the global batch), and per chip type a tensor-parallel
     degree s_tp,i ∈ powers of two ≤ TP_MAX_i with
     N_i = s_pp,i × s_tp,i × s_dp  ⇒  s_pp,i implied; chip types are
     visited in descending memory order (Observation #4).
  2. Optimal layer sharding per configuration (equalize compute, repair
     for memory/minimums) — ``cost_model.assign_layers``.
  3. Cost estimation via the §4.3.2 model; keep the argmin.

Two-stage refinement: stage 1 fixes s_dp at coarse (whole-island)
granularity; stage 2 re-splits each island into pseudo-heterogeneous
subgroups (default 128 chips) under the fixed s_dp with the paper's
monotone-TP pruning (within one chip type, an earlier subgroup's s_tp must
be ≥ a later one's).

The pipeline SCHEDULE is a search dimension (DESIGN.md §5): every layer
assignment is scored under the candidate schedules, pruned by the cost
model's α monotonicity — compute terms are schedule-independent, so among
memory-feasible schedules the lowest-α one always wins and the rest need
no evaluation.

A copy of the JAX package's ``core/heteroauto.py``,
held equal to it by ``tests/test_torch_planning.py``.
One difference: ``runtime_path`` also reports the layouts the
port's ``heteropp`` refuses with ``NotImplementedError`` (tp, dp,
batch domains and grouped tp: ROADMAP A8(d)-(g)) as ``refused``.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import List, Optional, Sequence, Tuple

from .chips import ChipGroup
from .cost_model import (DEFAULT_BUCKET_BYTES, ParallelPlan, PlanCost,
                         StagePlan, assign_layers, evaluate)
from .schedules import ScheduleLike, get_schedule
from ..models.config import ModelConfig

# default schedule candidates, visited in ascending-α order: wave
# (α=1/12, flat min(b,S) memory) > ZB-V (α=1/6) > interleaved (α=1/2,
# warmup-heavy memory, needs b % S == 0) > ZB-H1 (α=2/3 at 1F1B
# memory) > 1F1B (the fallback for exotic (S, b) shapes).  All five
# execute for real on the SPMD runtime (heteropp.spmd_tick_tables),
# and every candidate has closed-form α, inflight AND wgrad-tail
# windows, so each evaluate stays O(1).  NOTE: α does NOT order the
# §10 grad-sync exposure — interleaved's k·S·(d+w)/v drain windows can
# beat the zig-zags' sub-op windows on slow dp transports — so the
# first-feasible break below only applies where the schedule enters
# iter_time through α alone (dp == 1 / legacy heuristic); with the
# exposure term active every supported candidate is evaluated.
DEFAULT_SCHEDULES: Tuple[str, ...] = ("wave", "zb_v", "interleaved",
                                      "zb_h1", "1f1b")

# dp grad-sync search dimensions (DESIGN.md §10): sync mode trades
# optimizer-state memory (ZeRO-1 ×1/dp) against fused-message latency,
# bucket size trades per-message latency against drain granularity in
# the reduce_scatter accounting, and the transport prices the cluster's
# wire.  Kept deliberately small — the sweep multiplies every dp > 1
# candidate evaluation, and the ring model makes reduce_scatter cost
# weakly monotone in bucket size (fewer per-message latencies at equal
# bytes), so extra default sizes would mostly buy redundant evaluates;
# pass more ``bucket_sizes`` when the leaf structure makes it matter.
DEFAULT_SYNC_MODES: Tuple[str, ...] = ("reduce_scatter", "psum")
DEFAULT_DP_TRANSPORTS: Tuple[str, ...] = ("device_rdma",)
DEFAULT_BUCKET_SIZES: Tuple[int, ...] = (DEFAULT_BUCKET_BYTES,)


@dataclasses.dataclass
class SearchResult:
    plan: Optional[ParallelPlan]
    cost: Optional[PlanCost]
    evaluated: int
    search_time_s: float
    stage1_dp: Optional[int] = None
    # how the SPMD runtime would execute the winning plan: "uniform-tp"
    # or "grouped-tp" (non-uniform per-stage tp via the DESIGN.md §12
    # stage-group runtime), each with a "+uneven-dp" suffix when the
    # plan carries a non-uniform batch domain (per-replica tick
    # programs — DESIGN.md §13), or "refused: <reason>" for the layouts
    # the runtime genuinely cannot express (chunked schedule ×
    # non-uniform tp, grouped tp × dp > 1, ...)
    runtime: str = ""

    @property
    def tgs(self) -> float:
        return self.cost.tgs if self.cost else 0.0


def runtime_path(plan: Optional[ParallelPlan]) -> str:
    """Classify how ``heteropp`` would execute ``plan`` (see
    :attr:`SearchResult.runtime`).  Asymmetric-tp plans are executable
    since the grouped stage runtime landed — only genuinely
    inexpressible layouts report ``refused``."""
    if plan is None:
        return ""
    from . import heteropp as HP
    try:
        spec = HP.from_plan(plan, execute_tp=True, execute_dp=True)
    except (ValueError, NotImplementedError) as e:
        return f"refused: {e}"
    path = "grouped-tp" if spec.grouped else "uniform-tp"
    return path + "+uneven-dp" if spec.batch_domain else path


def _pow2s_upto(n: int) -> List[int]:
    out, v = [], 1
    while v <= n:
        out.append(v)
        v *= 2
    return out


def _tp_candidates(group: ChipGroup, dp: int) -> List[int]:
    return [tp for tp in _pow2s_upto(group.spec.tp_max)
            if group.count % (tp * dp) == 0 and group.count // (tp * dp) >= 1]


def _dp_candidates(groups: Sequence[ChipGroup], batch_seqs: int,
                   max_dp: int = 64, *, uneven_dp: bool = False
                   ) -> List[int]:
    cands = []
    for dp in range(1, min(batch_seqs, max_dp) + 1):
        # with uneven_dp the batch-domain partitioner rounds a
        # non-dividing batch into per-replica allocations (the cost
        # model charges the pacing max); chips must still divide
        if batch_seqs % dp and not uneven_dp:
            continue
        # feasibility probe per group over its OWN power-of-two TP range
        # (a fixed (1..16) list silently dropped dp values for chips with
        # larger tp_max)
        if all(any(g.count % (tp * dp) == 0
                   for tp in _pow2s_upto(g.spec.tp_max)) for g in groups):
            cands.append(dp)
    return cands


def _ordered(groups: Sequence[ChipGroup]) -> List[ChipGroup]:
    # Observation #4: larger memory -> earlier pipeline stages
    return sorted(groups, key=lambda g: -g.spec.memory_bytes)


def search(groups: Sequence[ChipGroup], cfg: ModelConfig, gbs_tokens: int,
           seq_len: int, *, alpha: Optional[float] = None,
           schedule: Optional[ScheduleLike] = None,
           schedules: Optional[Sequence[ScheduleLike]] = None,
           two_stage: bool = True,
           subgroup: int = 128, allow_offload: bool = False,
           monotone_tp: bool = True, dp_candidates: Optional[List[int]] = None,
           uneven_dp: bool = False,
           sync_modes: Optional[Sequence[str]] = None,
           dp_transports: Optional[Sequence[str]] = None,
           bucket_sizes: Optional[Sequence[int]] = None,
           sync_overlap: Optional[float] = None) -> SearchResult:
    """DFS over (dp, tp_i, recompute_i) × schedule × sync config.

    ``alpha``    — legacy: override the bubble coefficient directly
                   (plans annotated 1F1B; schedule search disabled).
    ``schedule`` — pin one schedule.
    ``schedules``— candidate set; default DEFAULT_SCHEDULES.  Pruning:
                   the first memory-feasible candidate in ascending-α
                   order is optimal for a given layer assignment (compute
                   terms don't depend on the schedule), so later ones are
                   skipped; offload is only considered if NO schedule fits
                   without it.
    ``uneven_dp``— also consider dp degrees that do NOT divide the
                   global batch: the ``dataparallel.batch_domain``
                   partitioner rounds the batch into per-replica
                   allocations and the plan carries the resulting
                   ``batch_domain``; the §4.3.2 max charges the pacing
                   replica's allocation, so the domain's imbalance is
                   priced exactly.  Winning plans EXECUTE:
                   ``from_plan(execute_dp=True)`` threads the domain
                   into per-replica tick programs (DESIGN.md §13).
    ``sync_modes`` / ``dp_transports`` / ``bucket_sizes`` — the dp
                   grad-sync sweep (DESIGN.md §10): every dp > 1
                   candidate is priced under each (mode, transport,
                   bucket size) combination through the derived
                   exposed-sync term, and the winning plan carries its
                   config (``plan.dp_sync`` etc.).  ``psum`` is one
                   fused message per chunk, so bucket sizes only
                   multiply the ``reduce_scatter`` candidates.
    ``sync_overlap`` — legacy: price grad sync with the old
                   constant-overlap ``update_time`` heuristic instead
                   of the derived exposed-sync term (the pre-§10
                   baseline, kept for A/B tests).
    """
    t0 = time.perf_counter()
    batch_seqs = gbs_tokens // seq_len
    groups = _ordered(groups)
    dps = dp_candidates or _dp_candidates(groups, batch_seqs,
                                          uneven_dp=uneven_dp)

    if schedule is not None:
        scheds = [get_schedule(schedule)]
    elif alpha is not None:
        scheds = [get_schedule("1f1b")]
    else:
        scheds = sorted((get_schedule(s) for s in
                         (schedules or DEFAULT_SCHEDULES)),
                        key=lambda s: s.alpha())
    sync_modes = tuple(sync_modes or DEFAULT_SYNC_MODES)
    dp_transports = tuple(dp_transports or DEFAULT_DP_TRANSPORTS)
    bucket_sizes = tuple(bucket_sizes or DEFAULT_BUCKET_SIZES)

    best_plan, best_cost, evaluated = None, None, 0
    pinned_sync = None       # stage 2 reuses the stage-1 winner's config

    def sync_configs(dp: int):
        """(dp_sync, dp_transport, bucket_bytes) sweep for one dp."""
        if dp == 1 or sync_overlap is not None:
            # nothing to sync / the legacy heuristic prices it flat —
            # keep the plan defaults (one evaluation, old behaviour)
            return [("reduce_scatter", "device_rdma",
                     DEFAULT_BUCKET_BYTES)]
        if pinned_sync is not None:
            return [pinned_sync]
        out = []
        for mode in sync_modes:
            for tr in dp_transports:
                if mode == "psum":
                    # psum is the mode whose RUNTIME consumes the bucket
                    # size (heteropp._bucketed_dp_psum) — sweep it,
                    # largest first: the fused pricing ties across
                    # sizes, and the executed per-bucket surcharge the
                    # model idealizes away shrinks with bucket size, so
                    # ties must resolve to the largest candidate
                    out.extend((mode, tr, bb)
                               for bb in sorted(bucket_sizes,
                                                reverse=True))
                else:
                    # ZeRO-1 executes one message per LEAF regardless —
                    # the bucket list is its fixed accounting
                    # granularity (from_plan drops the budget), so
                    # sweeping sizes would rank plans by message
                    # structures the runtime never runs
                    out.append((mode, tr, DEFAULT_BUCKET_BYTES))
        return out

    def consider(stages: List[StagePlan], dp: int):
        nonlocal best_plan, best_cost, evaluated
        sharded = assign_layers(stages, cfg, seq_len, cfg.num_layers)
        if sharded is None:
            return
        if batch_seqs % dp == 0:
            b, domain = batch_seqs // dp, None
        else:
            # identical replicas -> uniform throughputs; the partitioner
            # spreads the remainder and the pacing max prices it
            from .dataparallel.batch_domain import partition
            dom = partition(batch_seqs, [1.0] * dp)
            b, domain = dom.max_allocation, dom.allocations
        base = ParallelPlan(sharded, dp, b, batch_domain=domain)
        usable = [s for s in scheds if s.supports(base.total_pp, b)]
        cfgs = sync_configs(dp)

        def best_under(sched, offload):
            nonlocal evaluated
            picked = None
            for mode, tr, bb in cfgs:
                plan = dataclasses.replace(
                    base, schedule=sched.name, dp_sync=mode,
                    dp_transport=tr, bucket_bytes=bb)
                cost = evaluate(plan, cfg, seq_len, gbs_tokens, alpha=alpha,
                                allow_offload=offload,
                                sync_overlap=sync_overlap)
                evaluated += 1
                if cost.feasible and (picked is None
                                      or cost.iter_time < picked[1].iter_time):
                    picked = (plan, cost)
            return picked

        # ascending-α visit order.  Without the exposure term (dp == 1,
        # or the legacy flat heuristic) the schedule enters iter_time
        # through α alone, so the FIRST memory-feasible candidate is
        # exactly optimal and the rest are skipped.  With the §10
        # exposed-sync term a higher-α schedule can still win through
        # larger wgrad-tail windows, so every supported schedule is
        # evaluated and the best feasible kept.
        exact_alpha_order = dp == 1 or sync_overlap is not None
        picked = None
        for sched in usable:
            got = best_under(sched, offload=False)
            if got and (picked is None
                        or got[1].iter_time < picked[1].iter_time):
                picked = got
            if picked is not None and exact_alpha_order:
                break                              # feasible wins (pruning)
        if picked is None and allow_offload:
            for sched in usable:
                got = best_under(sched, offload=True)
                if got and (picked is None
                            or got[1].iter_time < picked[1].iter_time):
                    picked = got
        if picked is None:
            return
        plan, cost = picked
        if best_cost is None or cost.iter_time < best_cost.iter_time:
            best_plan, best_cost = plan, cost

    def dfs(idx: int, dp: int, stages: List[StagePlan],
            prev_tp_by_type: dict, rec_by_type: dict):
        if idx == len(groups):
            consider(stages, dp)
            return
        g = groups[idx]
        for tp in _tp_candidates(g, dp):
            if monotone_tp and g.spec.name in prev_tp_by_type \
                    and tp > prev_tp_by_type[g.spec.name]:
                continue  # paper's pruning: s_tp,a >= s_tp,b for a before b
            pp = g.count // (tp * dp)
            prev = dict(prev_tp_by_type)
            prev[g.spec.name] = tp
            # recompute r_i is searched per chip TYPE (paper §4.3.1)
            recs = ((rec_by_type[g.spec.name],) if g.spec.name in rec_by_type
                    else (False, True))
            for rec in recs:
                st = StagePlan(g, tp, pp, layers=0, recompute=rec)
                rbt = dict(rec_by_type)
                rbt[g.spec.name] = rec
                dfs(idx + 1, dp, stages + [st], prev, rbt)

    # ---------------- stage 1: find s_dp at island granularity -------------
    for dp in dps:
        dfs(0, dp, [], {}, {})
    stage1_dp = best_plan.dp if best_plan else None

    # ---------------- stage 2: subgroup refinement under fixed dp ----------
    if two_stage and best_plan is not None:
        dp = best_plan.dp
        # like dp, the sync config is frozen at the stage-1 winner's:
        # subgrouping refines the pipeline composition, and re-sweeping
        # sync per subgroup candidate would multiply the refinement cost
        # for a dimension that interacts with it only weakly
        pinned_sync = (best_plan.dp_sync, best_plan.dp_transport,
                       best_plan.bucket_bytes)
        split: List[ChipGroup] = []
        for g in groups:
            n, i = g.count, 0
            while n > 0:
                take = min(subgroup, n)
                if take % dp:   # keep subgroups dp-divisible
                    take = n
                split.append(ChipGroup(g.spec, take, f"{g.spec.name}{i}"))
                n -= take
                i += 1
        if len(split) > len(groups):
            saved_groups = groups
            groups = _ordered(split)
            dfs(0, dp, [], {}, {})
            groups = saved_groups

    return SearchResult(best_plan, best_cost, evaluated,
                        time.perf_counter() - t0, stage1_dp,
                        runtime=runtime_path(best_plan))


# ---------------------------------------------------------------------------
# homogeneous baseline (Table 6 reproduction + HeteroSpeedupRatio input)
# ---------------------------------------------------------------------------

def homogeneous_baseline(group: ChipGroup, cfg: ModelConfig, gbs_tokens: int,
                         seq_len: int, *, alpha: Optional[float] = 1.0,
                         schedule: ScheduleLike = "1f1b",
                         allow_offload: bool = True,
                         fixed: Optional[dict] = None,
                         sync_overlap: Optional[float] = 0.7) -> SearchResult:
    """Best homogeneous 3D-parallel config for one chip type (or evaluate a
    pinned configuration, e.g. the paper's Table 6 entries).  The default
    alpha=1.0 / 1F1B pairing is what the paper's Table 6 frameworks run;
    pass ``alpha=None`` with a schedule to re-baseline under another.

    ``sync_overlap`` stays at the calibrated 0.7 constant here: the
    Table 6 numbers are wall-clock measurements of frameworks whose DDP
    overlaps grad sync per bucket INSIDE the last microbatch's backward
    — finer than the stage-level bucket-readiness rule of the §10
    derived term — so the measured overlap fraction is the honest model
    for them.  Pass ``sync_overlap=None`` to re-baseline under the
    derived exposed-sync term."""
    t0 = time.perf_counter()
    batch_seqs = gbs_tokens // seq_len
    sched = get_schedule(schedule)
    best_plan, best_cost, evaluated = None, None, 0
    if fixed is not None:
        combos = [(fixed["dp"], fixed["tp"], fixed["recompute"])]
    else:
        combos = []
        for dp in _dp_candidates([group], batch_seqs):
            for tp in _tp_candidates(group, dp):
                for rec in (False, True):
                    combos.append((dp, tp, rec))
    for dp, tp, rec in combos:
        if group.count % (tp * dp):
            continue
        pp = group.count // (tp * dp)
        if pp < 1 or cfg.num_layers < pp:
            continue
        if not sched.supports(pp, batch_seqs // dp):
            continue
        st = StagePlan(group, tp, pp, layers=cfg.num_layers, recompute=rec)
        plan = ParallelPlan([st], dp, batch_seqs // dp, schedule=sched.name)
        cost = evaluate(plan, cfg, seq_len, gbs_tokens, alpha=alpha,
                        allow_offload=allow_offload,
                        sync_overlap=sync_overlap)
        evaluated += 1
        if not cost.feasible:
            continue
        if best_cost is None or cost.iter_time < best_cost.iter_time:
            best_plan, best_cost = plan, cost
    return SearchResult(best_plan, best_cost, evaluated,
                        time.perf_counter() - t0,
                        runtime=runtime_path(best_plan))


def hetero_speedup_ratio(hetero: SearchResult,
                         baselines: Sequence[Tuple[ChipGroup, SearchResult]]
                         ) -> float:
    """Fig. 11 metric: N·TGS_hetero / Σ_i N_i·TGS_i."""
    num = sum(g.count for g, _ in baselines) * hetero.tgs
    den = sum(g.count * r.tgs for g, r in baselines)
    return num / den if den else 0.0
