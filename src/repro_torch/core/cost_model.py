"""HeteroPP cost model (paper §4.3.2, extended per DESIGN.md §10).

    T = max_i ( b·T_i^comp + T_i^update + T_i^exposed-sync
                + α·Σ_{j≠i} T_j^comp )

with T_i^comp = ceil(l_i / s_pp,i) · (t^fwd + t^bwd + r_i·t^recomp) and α the
pipeline-schedule bubble coefficient (1 for the paper's 1F1B, 0 for ZB-V).

α, the memory-feasibility rule AND the dp grad-sync exposure are all
derived from the plan's :class:`~repro_torch.core.schedules.Schedule`
(DESIGN.md §4, §10): α comes from the schedule's closed form (validated
against the op-list derivation — the shipped ``zb_v`` lands at
f/(v(f+d+w)) = 1/6, the honest single-iteration residual of the paper's
"0 for ZB-V"), stage k's in-flight microbatch count comes from the
schedule's memory profile — Observation #4's min(b, s_pp − k) is exactly
the 1F1B/ZB-H1 profile; GPipe stashes b, interleaved its warmup/v, zb_v
a flat min(b, S) — and the exposed (non-overlapped) part of the dp
gradient sync comes from :func:`exposed_sync_time`: per-chunk buckets
(``dataparallel.grad_sync``) drain serially over the dp transport inside
the schedule's closed-form ``wgrad_tails`` windows, and only the tail
that outlives the wgrad wave is charged (validated against the
overlap-aware event simulator).  Passing an explicit ``alpha=``
overrides the schedule, and ``sync_overlap=`` (a float) restores the
legacy constant-overlap grad-sync heuristic (both are legacy sweep /
calibration paths).

A copy of the JAX package's ``core/cost_model.py``,
held equal to it by ``tests/test_torch_planning.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .chips import ChipGroup, ChipSpec
from .profiler import (analytic_layer_profile, apply_measured,
                       layer_param_count, offload_time, optimizer_step_time,
                       update_time, LayerProfile)
from .schedules import ScheduleLike, get_schedule
from ..models.config import ModelConfig

MEM_SAFETY = 0.92
DEFAULT_BUCKET_BYTES = 25 * 2 ** 20


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """All pipeline stages owned by ONE chip type (identical by paper
    requirement #1: same tp, same layers per stage)."""
    group: ChipGroup
    tp: int
    pp: int                  # number of pipeline stages of this chip type
    layers: int              # total layers assigned to this chip type
    recompute: bool

    @property
    def layers_per_stage(self) -> int:
        return math.ceil(self.layers / self.pp)


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    stages: List[StagePlan]  # ordered: largest-memory chip type first
    dp: int
    microbatches: int        # per-replica b (= max allocation, see below)
    schedule: str = "1f1b"   # pipeline schedule (repro_torch.core.schedules name)
    # Per-replica microbatch allocations when the global batch does NOT
    # split evenly over dp (``repro.core.dataparallel.batch_domain``):
    # len == dp, sum == global batch microbatches, and ``microbatches``
    # is max(batch_domain) — the PACING replica the §4.3.2 max-based
    # cost model charges.  None means the uniform domain (b each).
    # Non-uniform domains EXECUTE: ``heteropp.from_plan(execute_dp=True)``
    # threads them into per-replica tick programs padded to the pacing
    # replica's length (DESIGN.md §13), so the priced pacing term equals
    # the executed tick count.
    batch_domain: Optional[Tuple[int, ...]] = None
    # dp grad-sync configuration (DESIGN.md §10) — searched by
    # ``heteroauto.search`` (sync mode × transport × bucket size) and
    # consumed by both the cost model's exposed-sync term and the
    # runtime (``heteropp.from_plan`` threads bucket_bytes into the
    # bucketed dp sync).  Irrelevant when dp == 1.
    dp_sync: str = "reduce_scatter"
    dp_transport: str = "device_rdma"
    bucket_bytes: int = DEFAULT_BUCKET_BYTES

    def __post_init__(self):
        # real raises, not asserts: plans arrive from hand-editable JSON
        # (launch/train.py --plan), and -O would strip asserts
        if self.batch_domain is not None:
            if len(self.batch_domain) != self.dp:
                raise ValueError(
                    f"batch_domain has {len(self.batch_domain)} "
                    f"allocations but dp={self.dp}: {self.batch_domain}")
            if max(self.batch_domain) != self.microbatches:
                raise ValueError(
                    f"microbatches must be the pacing allocation "
                    f"max(batch_domain)={max(self.batch_domain)}, got "
                    f"{self.microbatches} (domain {self.batch_domain})")

    @property
    def total_pp(self) -> int:
        return sum(s.pp for s in self.stages)

    @property
    def total_chips(self) -> int:
        return sum(s.pp * s.tp * self.dp for s in self.stages)

    @property
    def batch_seqs(self) -> int:
        """Global batch in microbatches (sequences) per iteration."""
        return sum(self.batch_domain) if self.batch_domain is not None \
            else self.dp * self.microbatches

    def describe(self) -> str:
        parts = [f"dp={self.dp} b={self.microbatches} pp={self.total_pp} "
                 f"sched={self.schedule}"]
        if self.batch_domain is not None:
            parts.append(f"domain={list(self.batch_domain)}")
        if self.dp > 1:
            parts.append(f"sync={self.dp_sync}@{self.dp_transport}"
                         f"/{self.bucket_bytes // 2 ** 20}MiB")
        for s in self.stages:
            parts.append(
                f"{s.group.name}[pp={s.pp} tp={s.tp} l={s.layers} "
                f"r={int(s.recompute)}]")
        return " ".join(parts)

    def to_dict(self) -> dict:
        """JSON-serializable form (``launch/train.py --plan`` /
        ``examples/hetero_search.py --save-plan``).  Chip specs are stored
        by catalog name and resolved through ``chips.CHIPS`` on load."""
        d = {
            "dp": self.dp,
            "microbatches": self.microbatches,
            "schedule": self.schedule,
            "stages": [{"chip": s.group.spec.name, "count": s.group.count,
                        "label": s.group.label, "tp": s.tp, "pp": s.pp,
                        "layers": s.layers, "recompute": s.recompute}
                       for s in self.stages],
            "dp_sync": self.dp_sync,
            "dp_transport": self.dp_transport,
            "bucket_bytes": self.bucket_bytes,
        }
        if self.batch_domain is not None:
            d["batch_domain"] = list(self.batch_domain)
        return d

    @staticmethod
    def from_dict(d: dict) -> "ParallelPlan":
        from .chips import CHIPS, ChipGroup
        stages = [StagePlan(ChipGroup(CHIPS[sd["chip"]], sd["count"],
                                      sd.get("label", "")),
                            sd["tp"], sd["pp"], sd["layers"],
                            sd["recompute"])
                  for sd in d["stages"]]
        domain = d.get("batch_domain")
        return ParallelPlan(stages, d["dp"], d["microbatches"],
                            d.get("schedule", "1f1b"),
                            tuple(domain) if domain is not None else None,
                            d.get("dp_sync", "reduce_scatter"),
                            d.get("dp_transport", "device_rdma"),
                            d.get("bucket_bytes", DEFAULT_BUCKET_BYTES))


@dataclasses.dataclass
class PlanCost:
    iter_time: float
    tgs: float
    feasible: bool
    stage_mem_gb: List[float]
    stage_cap_gb: List[float]
    t_comp: List[float]
    t_update: List[float]
    bubble_frac: float
    offload: List[bool]
    alpha: float = 1.0
    schedule: str = "1f1b"
    dp_sync: str = "reduce_scatter"
    # per stage TYPE: the non-overlapped dp grad-sync tail charged to
    # the iteration (0.0 with the legacy sync_overlap heuristic, whose
    # constant lives inside t_update instead — DESIGN.md §10)
    exposed_sync: List[float] = dataclasses.field(default_factory=list)
    dp_transport: str = "device_rdma"
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    # per tp-differing stage-TYPE boundary: the reshard strategy the
    # grouped runtime will execute there ("none" for equal-tp
    # boundaries) and, per stage TYPE, the per-microbatch boundary
    # reshard time charged to the DOWNSTREAM stage (the stage whose
    # devices wait on the incoming all-gather) — DESIGN.md §12
    reshard: List[str] = dataclasses.field(default_factory=list)
    t_reshard: List[float] = dataclasses.field(default_factory=list)


def stage_profiles(plan: ParallelPlan, cfg: ModelConfig, seq_len: int
                   ) -> List[LayerProfile]:
    return [analytic_layer_profile(s.group.spec, cfg, s.tp, seq_len)
            for s in plan.stages]


def exposed_sync_time(schedule: ScheduleLike, num_stages: int,
                      microbatches: int, t_stage_mb: float,
                      layers_per_stage: int, layer_grad_bytes: float,
                      dp: int, *, transport: str = "device_rdma",
                      mode: str = "reduce_scatter",
                      bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> float:
    """Closed-form exposed dp grad-sync tail for ONE pipeline stage
    (DESIGN.md §10).

    The stage's ``layers_per_stage`` layers are split over the
    schedule's v chunk slots (earlier slots take the remainder, the
    ``heteropp.chunk_layer_counts`` layout); each chunk's per-layer
    bf16 gradient leaves are bucketized and priced by the
    ``dataparallel.grad_sync`` ring closed forms over the dp transport.
    Chunk slot k's buckets become ready ``wgrad_tails[k]`` canonical
    units before the stage's final compute op (scaled by the stage's
    real per-microbatch time ``t_stage_mb``), drain serially in
    readiness order, and only the tail that outlives the wgrad wave is
    exposed:

        exposed = max(0, max_k( Σ_{j : τ_j ≤ τ_k} d_j  −  τ_k ))

    — the serial-drain recurrence collapsed over ready times
    r_k = T_end − τ_k.  Single-chunk schedules have all-zero τ, so the
    whole sync is exposed; the zig-zag placements (zb_v, wave) and
    interleaving genuinely hide the earlier chunks' buckets.  Validated
    against the overlap-aware event simulator in
    ``tests/test_costmodel_vs_simulator.py``.  Memoized — the search
    prices every candidate plan through here, and the argument tuple is
    drawn from a small set per search."""
    if dp <= 1 or layers_per_stage <= 0:
        return 0.0
    sched = get_schedule(schedule)
    return _exposed_sync_cached(sched.name, num_stages, microbatches,
                                t_stage_mb, layers_per_stage,
                                int(layer_grad_bytes), dp, transport, mode,
                                bucket_bytes)


def chunk_sync_drains(n_chunks: int, layers_per_stage: int,
                      layer_grad_bytes: float, dp: int, transport: str,
                      mode: str, bucket_bytes: int) -> List[List[float]]:
    """Per chunk slot: per-bucket drain seconds for ONE stage's dp sync
    — the single source of the §10 chunk-split / bucketize / ring
    accounting, consumed by both the closed-form
    :func:`exposed_sync_time` and the event builder
    ``schedule.plan_sync_events`` so the two can never drift apart.
    The stage's layers split over the chunk slots exactly like
    ``heteropp.chunk_layer_counts`` (earlier slots take the remainder);
    each chunk's per-layer bf16 leaves are coalesced by ``bucketize``
    and priced by the ``sync_time`` ring closed forms.

    Scope: the LAYER-STACK gradients only, matching every other term of
    the analytic cost model (``layer_param_count`` excludes embeddings
    from memory, update and FLOP accounting alike).  The SPMD runtime
    additionally syncs its pipe-replicated embed/final-norm grads —
    an artifact of this runtime's every-stage-embeds design
    (DESIGN.md §2), deliberately outside the paper-shaped analytic
    model (§10)."""
    from .dataparallel.grad_sync import bucketize, sync_time
    base, extra = divmod(layers_per_stage, n_chunks)
    out: List[List[float]] = []
    for k in range(n_chunks):
        n = base + (1 if k < extra else 0)
        if n == 0:
            out.append([])
            continue
        gb = bucketize([(f"c{k}/l{i}", int(layer_grad_bytes))
                        for i in range(n)], bucket_bytes)
        out.append(list(sync_time(gb, dp, transport, mode)["per_bucket"]))
    return out


@functools.lru_cache(maxsize=1 << 16)
def _exposed_sync_cached(sched_name: str, num_stages: int, microbatches: int,
                         t_stage_mb: float, layers_per_stage: int,
                         layer_grad_bytes: int, dp: int, transport: str,
                         mode: str, bucket_bytes: int) -> float:
    sched = get_schedule(sched_name)
    v = sched.n_chunks
    tails = sched.wgrad_tails(num_stages, microbatches)
    scale = t_stage_mb / (sched.UNIT_F + sched.UNIT_D + sched.UNIT_W)
    drains = [sum(per) for per in chunk_sync_drains(
        v, layers_per_stage, layer_grad_bytes, dp, transport, mode,
        bucket_bytes)]
    exposed = 0.0
    for k in range(v):
        backlog = sum(d for j, d in enumerate(drains)
                      if tails[j] <= tails[k])
        exposed = max(exposed, backlog - tails[k] * scale)
    return max(0.0, exposed)


def evaluate(plan: ParallelPlan, cfg: ModelConfig, seq_len: int,
             gbs_tokens: float, *, alpha: Optional[float] = None,
             schedule: Optional[ScheduleLike] = None,
             allow_offload: bool = False,
             profiles: Optional[Sequence[LayerProfile]] = None,
             dp_sync: Optional[str] = None,
             dp_transport: Optional[str] = None,
             bucket_bytes: Optional[int] = None,
             sync_overlap: Optional[float] = None,
             measured: Optional[Dict[str, dict]] = None,
             resharding: Optional[str] = None) -> PlanCost:
    """§4.3.2 closed-form cost of a plan (+ the §10 exposed-sync term).

    ``plan.microbatches`` is the PACING replica's allocation: for plans
    carrying a non-uniform ``batch_domain`` it is max(domain), so the
    max-based iteration time prices the domain's imbalance exactly —
    and equals the tick count the runtime's pacing replica executes
    (``heteropp.domain_tick_tables`` — DESIGN.md §13).

    ``dp_sync`` / ``dp_transport`` / ``bucket_bytes`` override the
    plan's grad-sync configuration: the sync mode drives both the
    optimizer-state memory model (``"reduce_scatter"`` = ZeRO-1 shards
    it ×1/dp, ``"psum"`` replicates it) and the per-bucket message
    structure of the exposed-sync term (:func:`exposed_sync_time`),
    which replaces the old ``update_time`` overlap constant.  Passing
    ``sync_overlap=`` (e.g. 0.7) restores that legacy heuristic — the
    calibration path for the Table 6 homogeneous baselines, whose
    measured frameworks overlap sync inside the last backward at finer
    granularity than the stage-level bucket-readiness rule models.

    ``measured`` maps chip-spec name -> a ``measure_layer_profile``
    result dict; matching stages get their analytic time fields
    (:data:`~.profiler.MEASURED_TIME_FIELDS`) replaced by the measured
    ones via :func:`~.profiler.apply_measured`, so search ranks plans
    by what the chosen kernel backend actually executes.  Memory
    fields stay analytic.

    Every tp-differing stage-TYPE boundary additionally pays the §5
    reshard collective the grouped runtime executes there
    (``resharding.boundary_time`` × microbatches, charged to the
    downstream stage whose devices wait on the incoming gather).
    ``resharding=`` forces one strategy for every boundary; the default
    ``None`` prices each boundary at the strategy
    :func:`resharding.choose_strategy` picks — the same per-boundary
    argmin ``heteropp.from_plan`` bakes into the executed spec, so the
    priced and executed collectives cannot drift apart (DESIGN.md §12).
    """
    from .dataparallel.grad_sync import GRAD_SYNC_MODES
    dp_sync = dp_sync if dp_sync is not None else plan.dp_sync
    dp_transport = dp_transport if dp_transport is not None \
        else plan.dp_transport
    bucket_bytes = bucket_bytes if bucket_bytes is not None \
        else plan.bucket_bytes
    if dp_sync not in GRAD_SYNC_MODES:
        raise ValueError(f"dp_sync {dp_sync!r} not in {GRAD_SYNC_MODES}")
    b = plan.microbatches
    sched = get_schedule(schedule if schedule is not None else plan.schedule)
    total_pp = plan.total_pp
    if not sched.supports(total_pp, b):
        raise ValueError(f"schedule {sched.name!r} does not support "
                         f"S={total_pp}, b={b} (e.g. interleaved needs "
                         f"b % S == 0)")
    a = alpha if alpha is not None else sched.alpha(total_pp, b)
    profs = list(profiles) if profiles is not None else \
        stage_profiles(plan, cfg, seq_len)
    if measured:
        profs = [apply_measured(p, measured.get(s.group.spec.name, {}))
                 for s, p in zip(plan.stages, profs)]

    t_comp, t_upd, exposed, mems, caps, off = [], [], [], [], [], []
    stage_offset = 0
    feasible = True
    for s, prof in zip(plan.stages, profs):
        lps = s.layers_per_stage
        per_mb = prof.t_fwd + prof.t_bwd + (prof.t_recomp if s.recompute else 0.0)
        tc = lps * per_mb
        if sync_overlap is not None:
            # legacy: fixed-fraction overlap hidden inside t_update
            tu = update_time(s.group.spec, cfg, s.tp, plan.dp, lps,
                             overlap=sync_overlap)
            exp_i = 0.0
        else:
            tu = optimizer_step_time(s.group.spec)
            exp_i = exposed_sync_time(
                sched, total_pp, b, tc, lps, prof.layer_param_bytes,
                plan.dp, transport=dp_transport, mode=dp_sync,
                bucket_bytes=bucket_bytes)

        # ---- memory (worst stage of this type = its FIRST global stage) ----
        w_bytes = lps * prof.layer_param_bytes
        grad_bytes = w_bytes                       # bf16 grads
        # fp32 master+m+v: dp-sharded under ZeRO-1 (reduce_scatter),
        # replicated under the flat-psum sync
        opt_bytes = 6 * w_bytes / \
            (plan.dp if dp_sync == "reduce_scatter" else 1)
        inflight = sched.inflight(total_pp, b, stage_offset)
        act_per_mb = lps * (prof.act_boundary_bytes if s.recompute
                            else prof.act_bytes)
        mem = w_bytes + grad_bytes + opt_bytes + inflight * act_per_mb
        cap = s.group.spec.memory_bytes * MEM_SAFETY
        is_off = False
        if mem > cap:
            if allow_offload:
                deficit = mem - cap
                # offloading trades the deficit for PCIe transfers on the
                # critical path, amortized over the b microbatches
                tc += offload_time(s.group.spec, cfg, s.tp, lps,
                                   deficit / max(b, 1))
                is_off = True
            else:
                feasible = False
        t_comp.append(tc)
        t_upd.append(tu)
        exposed.append(exp_i)
        mems.append(mem / 2 ** 30)
        caps.append(s.group.spec.memory_bytes / 2 ** 30)
        off.append(is_off)
        stage_offset += s.pp

    # ---- §5 boundary resharding between tp-differing stage TYPES ----
    # Stages inside one type share a tp, so only type boundaries can
    # differ.  Each microbatch pays the boundary once; the downstream
    # stage's devices block on the incoming gather, so the term joins
    # that stage's pacing candidate.
    from . import resharding as RS
    act_bytes = seq_len * cfg.d_model * 2          # bf16 boundary tensor
    reshard_strats: List[str] = []
    t_resh = [0.0] * len(plan.stages)
    for i in range(len(plan.stages) - 1):
        src, dst = plan.stages[i], plan.stages[i + 1]
        if src.tp == dst.tp:
            reshard_strats.append("none")
            continue
        strat = resharding if resharding is not None else \
            RS.choose_strategy(src.tp, dst.tp,
                               nic_bw=src.group.spec.nic_bw,
                               intra_bw=dst.group.spec.intra_node_bw)
        reshard_strats.append(strat)
        t_resh[i + 1] += RS.boundary_time(
            act_bytes, src.tp, dst.tp, strategy=strat,
            nic_bw=src.group.spec.nic_bw,
            intra_bw=dst.group.spec.intra_node_bw)

    sum_comp = sum(tc * s.pp for tc, s in zip(t_comp, plan.stages))
    iter_time, pacing = 0.0, 0
    for i, s in enumerate(plan.stages):
        t = b * (t_comp[i] + t_resh[i]) + t_upd[i] + exposed[i] + \
            a * (sum_comp - t_comp[i])
        if t > iter_time:
            iter_time, pacing = t, i
    # the bubble of the stage that PACES the iteration (the argmax above)
    # — reporting min(t_comp)'s bubble described a stage that does not
    # set the iteration time at all
    bubble = a * (sum_comp - t_comp[pacing]) / max(iter_time, 1e-9)
    tgs = gbs_tokens / (iter_time * plan.total_chips) if iter_time > 0 else 0.0
    return PlanCost(iter_time, tgs, feasible, mems, caps, t_comp, t_upd,
                    bubble, off, a, sched.name, dp_sync, exposed,
                    dp_transport, bucket_bytes, reshard_strats, t_resh)


# ---------------------------------------------------------------------------
# layer sharding (paper §4.3.3 step 2)
# ---------------------------------------------------------------------------

def assign_layers(stages: List[StagePlan], cfg: ModelConfig, seq_len: int,
                  total_layers: int) -> Optional[List[StagePlan]]:
    """Heuristic optimal layer sharding: equalize per-stage compute time,
    round to integers, then repair against per-type minimums."""
    profs = [analytic_layer_profile(s.group.spec, cfg, s.tp, seq_len)
             for s in stages]
    t_layer = [p.t_fwd + p.t_bwd + (p.t_recomp if s.recompute else 0.0)
               for s, p in zip(stages, profs)]
    w = [s.pp / t for s, t in zip(stages, t_layer)]
    raw = [total_layers * wi / sum(w) for wi in w]
    l = [max(s.pp, int(round(r))) for s, r in zip(stages, raw)]
    # fix rounding so sum == total_layers
    def slack(i):  # how much adding a layer to type i hurts
        return t_layer[i] / stages[i].pp
    for _ in range(10 * len(stages) + 64):
        diff = sum(l) - total_layers
        if diff == 0:
            break
        if diff > 0:
            cands = [i for i in range(len(l)) if l[i] > stages[i].pp]
            if not cands:
                return None
            i = max(cands, key=lambda i: l[i] * slack(i) / stages[i].pp)
            l[i] -= 1
        else:
            i = min(range(len(l)), key=lambda i: (l[i] + 1) * slack(i))
            l[i] += 1
    if sum(l) != total_layers:
        return None
    return [dataclasses.replace(s, layers=li) for s, li in zip(stages, l)]
