"""Pipeline-schedule replay with per-stage heterogeneous times, P2P
transfer costs, and optional fine-grained compute/comm overlap.

The actual schedule semantics live in ``repro_torch.core.schedules``: a
:class:`~repro_torch.core.schedules.Schedule` generates per-stage F/B/D/W op
lists, and ONE generic event-driven simulator replays them (this module's
old ``simulate_1f1b``/``simulate_gpipe`` loops are now thin wrappers over
it).  This is the tick-level counterpart of the cost model's α
coefficient: it replays a searched HeteroPP plan with per-chip profiles
and produces the iteration makespan, driving the Table 9 ablations
(uniform-vs-HeteroPP layer split, DDR-vs-TCP transport, SR&AG-vs-naive
resharding, overlap on/off, schedule choice, and — via
:func:`plan_sync_events` / ``simulate_plan(grad_sync=True)`` — the
schedule-aware dp grad-sync overlap of DESIGN.md §10).

A copy of the JAX package's ``core/schedule.py``,
held equal to it by ``tests/test_torch_planning.py``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .schedules import (ScheduleLike, SimResult, SyncEvent, get_schedule,
                        simulate)

__all__ = ["SimResult", "SyncEvent", "simulate", "simulate_1f1b",
           "simulate_gpipe", "plan_to_schedule_inputs", "plan_sync_events",
           "simulate_plan"]


def simulate_1f1b(t_fwd: Sequence[float], t_bwd: Sequence[float],
                  microbatches: int, t_p2p: Sequence[float],
                  *, overlap: bool = True,
                  t_update: Optional[Sequence[float]] = None) -> SimResult:
    """Event-driven 1F1B (compat wrapper over the generic simulator)."""
    return simulate("1f1b", t_fwd, t_bwd, microbatches, t_p2p,
                    overlap=overlap, t_update=t_update)


def simulate_gpipe(t_fwd, t_bwd, microbatches, t_p2p, *, overlap=True,
                   t_update=None) -> SimResult:
    """All forwards, then all backwards (compat wrapper)."""
    return simulate("gpipe", t_fwd, t_bwd, microbatches, t_p2p,
                    overlap=overlap, t_update=t_update)


# ---------------------------------------------------------------------------
# plan replay: HeteroAuto plan -> schedule inputs
# ---------------------------------------------------------------------------

def plan_to_schedule_inputs(plan, cfg, seq_len: int, *,
                            transport="device_rdma", resharding="sr_ag",
                            measured=None, update_includes_sync=True):
    """Expand a ParallelPlan into per-STAGE fwd/bwd/p2p times plus the
    per-stage dgrad/wgrad decomposition.

    ``t_bwd`` is the FULL backward time per stage; the last returned
    element is the per-stage ``wgrad_frac`` — the profiler splits each
    stage's backward analytically by its op mix (parameter matmuls split
    1:1 dgrad/wgrad, weight-free attention score ops are pure dgrad, TP
    collectives ride the dgrad path), so stages with different tp degrees
    get different fractions.  Backward-split schedules (``zb_h1``,
    ``zb_v``) consume it inside the simulator; single-``B`` schedules
    ignore it.

    ``measured`` maps chip names to wall-clock profiles from
    :func:`~repro_torch.core.profiler.measure_layer_profile` — any time
    field a chip's entry carries (``t_fwd``/``t_bwd``/``t_recomp``/
    ``tp_comm``/``wgrad_frac``, see
    :data:`~repro_torch.core.profiler.MEASURED_TIME_FIELDS`) replaces the
    analytic value for that chip's stages via
    :func:`~repro_torch.core.profiler.apply_measured`, so the replay runs on
    what the chosen kernel backend actually executes (the real-
    hardware path of the auto-profiler API).

    ``update_includes_sync=False`` returns PURE optimizer-step update
    times — required whenever the replay also carries explicit
    grad-sync events (:func:`plan_sync_events`), which would otherwise
    double-count the sync the legacy ``update_time`` constant hides.
    """
    from .cost_model import stage_profiles
    from .resharding import boundary_time
    from ..comm.latency import p2p_latency

    profs = stage_profiles(plan, cfg, seq_len)
    measured = measured or {}
    t_fwd, t_bwd, t_upd, wfrac, tps, specs = [], [], [], [], [], []
    from .profiler import apply_measured, optimizer_step_time, update_time
    for s, prof in zip(plan.stages, profs):
        lps = s.layers_per_stage
        prof = apply_measured(prof, measured.get(s.group.spec.name, {}))
        wf = prof.wgrad_frac
        for _ in range(s.pp):
            f = lps * (prof.t_fwd + (prof.t_recomp if s.recompute else 0.0))
            bwd = lps * prof.t_bwd
            t_fwd.append(f)
            t_bwd.append(bwd)
            t_upd.append(
                update_time(s.group.spec, cfg, s.tp, plan.dp, lps)
                if update_includes_sync
                else optimizer_step_time(s.group.spec))
            wfrac.append(wf)
            tps.append(s.tp)
            specs.append(s.group.spec)
    act_bytes = seq_len * cfg.d_model * 2       # one microbatch boundary act
    t_p2p = []
    for i in range(len(t_fwd) - 1):
        base = p2p_latency(transport, act_bytes)
        extra = boundary_time(act_bytes, tps[i], tps[i + 1],
                              nic_bw=specs[i].nic_bw,
                              intra_bw=specs[i + 1].intra_node_bw,
                              strategy=resharding) \
            - boundary_time(act_bytes, tps[i], tps[i + 1],
                            nic_bw=specs[i].nic_bw,
                            intra_bw=specs[i + 1].intra_node_bw,
                            strategy="sr_ag")
        t_p2p.append(base + max(extra, 0.0))
    return t_fwd, t_bwd, plan.microbatches, t_p2p, t_upd, wfrac


def plan_sync_events(plan, cfg, seq_len: int, *,
                     schedule: Optional[ScheduleLike] = None,
                     mode: Optional[str] = None,
                     dp_transport: Optional[str] = None,
                     bucket_bytes: Optional[int] = None
                     ) -> List[List[SyncEvent]]:
    """Per-physical-stage dp grad-sync bucket events for the overlap-
    aware replay (DESIGN.md §10).

    Each physical stage's layer allotment is split over the schedule's
    v chunk slots, each chunk's per-layer bf16 gradient leaves — the
    plan's real leaf bytes, ``profiler.layer_param_bytes`` per layer at
    the stage's tp — are coalesced and priced by
    ``cost_model.chunk_sync_drains`` (the SAME accounting the
    closed-form exposed-sync term uses, so the replay and the closed
    form cannot drift apart), and every bucket becomes one
    :class:`SyncEvent` gated on its chunk's global stage.  dp == 1
    yields empty event lists (nothing to sync)."""
    from .cost_model import chunk_sync_drains, stage_profiles
    sched = get_schedule(schedule if schedule is not None else plan.schedule)
    v = sched.n_chunks
    mode = mode if mode is not None else plan.dp_sync
    dp_transport = dp_transport if dp_transport is not None \
        else plan.dp_transport
    bucket_bytes = bucket_bytes if bucket_bytes is not None \
        else plan.bucket_bytes
    profs = stage_profiles(plan, cfg, seq_len)
    S = plan.total_pp
    events: List[List[SyncEvent]] = []
    sidx = 0
    for s, prof in zip(plan.stages, profs):
        drains = chunk_sync_drains(
            v, s.layers_per_stage, prof.layer_param_bytes, plan.dp,
            dp_transport, mode, bucket_bytes) if plan.dp > 1 else None
        for _ in range(s.pp):
            evs: List[SyncEvent] = []
            if drains is not None:
                for k, per in enumerate(drains):
                    g = sched.global_stage(sidx, k, S)
                    evs.extend(SyncEvent(t, (g,)) for t in per)
            events.append(evs)
            sidx += 1
    return events


def simulate_plan(plan, cfg, seq_len: int, *,
                  schedule: Optional[ScheduleLike] = None,
                  transport="device_rdma", resharding="sr_ag",
                  overlap: bool = True,
                  wgrad_frac: Optional[float] = None,
                  measured=None, grad_sync: bool = False,
                  sync_mode: Optional[str] = None,
                  dp_transport: Optional[str] = None,
                  bucket_bytes: Optional[int] = None,
                  record_spans: bool = False) -> SimResult:
    """Replay a HeteroAuto plan through its (or the given) schedule.
    ``wgrad_frac=None`` (default) uses the profiler's analytic per-stage
    dgrad/wgrad split — or, per chip, a wall-clock measured fraction
    when ``measured`` (chip name → ``measure_layer_profile`` dict)
    provides one; pass a float to override globally.

    ``grad_sync=True`` runs the overlap-aware replay (DESIGN.md §10):
    per-bucket dp sync events from :func:`plan_sync_events` drain
    against the wgrad wave, update times are the PURE optimizer step
    (the legacy ``update_time`` sync constant would double-count), and
    the result's ``exposed_sync`` reports each stage's non-overlapped
    tail."""
    sched = get_schedule(schedule if schedule is not None else plan.schedule)
    tf, tb, b, tp2p, tu, wf = plan_to_schedule_inputs(
        plan, cfg, seq_len, transport=transport, resharding=resharding,
        measured=measured, update_includes_sync=not grad_sync)
    events = plan_sync_events(
        plan, cfg, seq_len, schedule=sched, mode=sync_mode,
        dp_transport=dp_transport, bucket_bytes=bucket_bytes) \
        if grad_sync else None
    return simulate(sched, tf, tb, b, tp2p, overlap=overlap, t_update=tu,
                    wgrad_frac=wf if wgrad_frac is None else wgrad_frac,
                    sync_events=events, record_spans=record_spans)
