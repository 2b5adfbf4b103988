"""ONE generic event-driven pipeline simulator (DESIGN.md §3, §10).

Replaces the per-schedule simulation loops: any :class:`Schedule`'s op
lists are replayed against per-stage heterogeneous compute times and P2P
transfer costs.  Per-stage ops execute strictly in list order (a stage is
one device); an op waits for its cross-stage dependencies:

  F(m, g)   ← F(m, g−1) done (+ transfer), g the global chunk-stage index
  B/D(m, g) ← own F(m, g) and D-or-B(m, g+1) done (+ transfer)
  W(m, g)   ← own D(m, g) done (in-order execution already guarantees it)

The (stage, chunk) → g mapping comes from the schedule's placement
(:meth:`Schedule.global_stage`): chunk-major for Megatron interleaving,
V-shaped for ZB-V, W-shaped for ``wave`` — where the leg turns land on
the SAME device and are therefore transfer-free, the property that lets
the zig-zag schedules drain at dgrad speed without paying wrap hops.

``overlap=False`` models un-overlapped P2P (paper §5): the transfer also
occupies the *sender* stage.  For chunked (interleaved) schedules each op
carries 1/v of the stage's layer time, and a non-adjacent hop (the
chunk-major wrap from stage S−1 back to stage 0) is charged the worst
boundary cost.  ``wgrad_frac`` may be per-stage (see
``repro_torch.core.schedule.plan_to_schedule_inputs``, which derives it from
each stage's analytic op mix) or one global float.

Data-parallel gradient sync (DESIGN.md §10): ``sync_events`` attaches
per-stage bucket drains to the replay.  A bucket becomes *ready* when
the last W (or, for single-``B`` schedules, the last B) touching its
leaves completes on its stage — per-chunk granularity: chunk g's grads
are final only after its last microbatch's wgrad.  Ready buckets drain
serially over the stage's dp transport in readiness order (the runtime
issues per-bucket collectives in wgrad-completion order —
``heteropp._make_dp_train_step``), and the makespan charges only the
tail that outlives the wgrad wave: ``exposed_sync[s] = max(0,
sync_done[s] − stage_end[s])``.  Chunked schedules genuinely overlap
more — a v-chunk stage has (v−1)/v of its buckets ready before its
final wgrad, which is the whole point of the wave placement.

A copy of the JAX package's ``core/schedules/simulator.py``,
held equal to it by ``tests/test_torch_planning.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

from .base import ScheduleLike, get_schedule


@dataclasses.dataclass(frozen=True)
class SyncEvent:
    """One gradient bucket to drain over the dp transport.

    ``seconds`` is the bucket's closed-form sync time
    (``dataparallel.grad_sync.sync_time``); ``gstages`` are the global
    chunk-stages whose wgrad feeds it — the bucket is ready when the
    LAST W (or B) op of every named chunk has completed."""
    seconds: float
    gstages: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class OpSpan:
    """One timed interval on one stage's timeline, recorded by
    ``simulate(record_spans=True)`` for the trace export
    (``repro.obs.trace`` — DESIGN.md §14).  ``kind`` is F/B/D/W for
    compute ops (``mb``/``chunk``/``g`` from the op), ``"sync"`` for a
    dp grad-sync bucket drain (``mb`` is the drain order index, ``g``
    the bucket's first gated chunk-stage), ``"U"`` for the optimizer
    update tail (``mb``/``chunk``/``g`` are -1)."""
    stage: int
    kind: str
    mb: int
    chunk: int
    g: int
    start: float
    end: float


@dataclasses.dataclass
class SimResult:
    makespan: float
    stage_busy: List[float]      # compute + update time per stage
    bubble_frac: float
    # compute-only end per physical stage (before sync tail and update)
    stage_end: List[float] = dataclasses.field(default_factory=list)
    # non-overlapped grad-sync tail per physical stage (0 without
    # sync_events): the part of the bucket drain that outlives the
    # stage's wgrad wave
    exposed_sync: List[float] = dataclasses.field(default_factory=list)
    # per GLOBAL chunk-stage g: completion time of the last op that
    # finalizes g's weight gradients (W, or B for single-B schedules)
    grad_last: List[float] = dataclasses.field(default_factory=list)
    # per-op timeline (empty unless simulate(record_spans=True)):
    # every F/B/D/W op plus sync drains and update tails
    spans: List[OpSpan] = dataclasses.field(default_factory=list)


def simulate(schedule: ScheduleLike, t_fwd: Sequence[float],
             t_bwd: Sequence[float], microbatches: int,
             t_p2p: Sequence[float], *, overlap: bool = True,
             t_update: Optional[Sequence[float]] = None,
             wgrad_frac: Union[float, Sequence[float]] = 0.5,
             sync_events: Optional[Sequence[Sequence[SyncEvent]]] = None,
             record_spans: bool = False) -> SimResult:
    """t_fwd/t_bwd: per-stage per-microbatch compute times (len S; t_bwd is
    the FULL backward — for backward-split schedules it is divided into
    dgrad = (1−wgrad_frac)·t_bwd and wgrad = wgrad_frac·t_bwd;
    ``wgrad_frac`` is one float or a per-stage sequence of len S).
    t_p2p[i]: activation transfer across boundary i → i+1 (len S−1); the
    same cost is charged to gradient transfers on the way back.
    ``sync_events``: optional per-physical-stage bucket lists (len S) —
    see the module docstring for the readiness/drain/exposure rules.
    ``t_update`` runs after the stage's sync tail (the optimizer needs
    the synced grads) and counts as busy time.  ``record_spans=True``
    additionally records every op's (start, end) interval — plus sync
    drains and update tails — in ``SimResult.spans`` for the trace
    export (``repro.obs.trace``); off by default so the search's hot
    replay loop allocates nothing extra."""
    sched = get_schedule(schedule)
    S, b, v = len(t_fwd), microbatches, sched.n_chunks
    assert sched.supports(S, b), (sched.name, S, b)
    G = S * v
    t_update = list(t_update) if t_update is not None else [0.0] * S
    t_p2p = list(t_p2p)
    wf = list(wgrad_frac) if isinstance(wgrad_frac, (list, tuple)) \
        else [float(wgrad_frac)] * S
    assert len(wf) == S, (len(wf), S)
    if sync_events is not None:
        assert len(sync_events) == S, (len(sync_events), S)

    fdur = [t / v for t in t_fwd]
    bdur = [t / v for t in t_bwd]
    ddur = [t * (1.0 - f) / v for t, f in zip(t_bwd, wf)]
    wdur = [t * f / v for t, f in zip(t_bwd, wf)]
    # schedules that plan at profiled times (zb_v, wave) specialize their
    # op lists to the actual durations; the rest return the canonical
    # order
    ops = sched.ops_timed(S, b, fdur, ddur, wdur)

    def xfer(a: int, c: int) -> float:
        if a == c:
            return 0.0                        # same device (zig-zag turn)
        if abs(a - c) == 1:
            return t_p2p[min(a, c)]
        return max(t_p2p) if t_p2p else 0.0   # interleaved wrap-around hop

    dev = sched.device_of                     # global chunk-stage -> device

    spans: List[OpSpan] = []
    fwd_done = [[None] * b for _ in range(G)]
    dgrad_done = [[None] * b for _ in range(G)]   # B sets this too
    grad_last = [0.0] * G                      # last W (or B) end per g
    free = [0.0] * S
    busy = [0.0] * S
    idx = [0] * S
    progress = True
    while progress:
        progress = False
        for s in range(S):
            while idx[s] < len(ops[s]):
                op = ops[s][idx[s]]
                g = sched.global_stage(s, op.chunk, S)
                if op.kind == "F":
                    dep = 0.0 if g == 0 else fwd_done[g - 1][op.mb]
                    if dep is None:
                        break
                    ready = dep + (xfer(dev(g - 1, S), s) if g > 0 else 0.0)
                    dur = fdur[s] + (0.0 if overlap or g == G - 1
                                     else xfer(s, dev(g + 1, S)))
                    start = max(free[s], ready)
                    fwd_done[g][op.mb] = start + dur
                elif op.kind in ("B", "D"):
                    dep_self = fwd_done[g][op.mb]
                    dep_next = 0.0 if g == G - 1 else dgrad_done[g + 1][op.mb]
                    if dep_self is None or dep_next is None:
                        break
                    ready = max(dep_self,
                                dep_next + (xfer(dev(g + 1, S), s)
                                            if g < G - 1 else 0.0))
                    dur = (bdur[s] if op.kind == "B" else ddur[s]) + \
                        (0.0 if overlap or g == 0 else xfer(s, dev(g - 1, S)))
                    start = max(free[s], ready)
                    dgrad_done[g][op.mb] = start + dur
                    if op.kind == "B":        # B finalizes wgrad too
                        grad_last[g] = max(grad_last[g], start + dur)
                else:                                   # W
                    dep = dgrad_done[g][op.mb]
                    if dep is None:
                        break
                    start = max(free[s], dep)
                    dur = wdur[s]
                    grad_last[g] = max(grad_last[g], start + dur)
                if record_spans:
                    spans.append(OpSpan(s, op.kind, op.mb, op.chunk, g,
                                        start, start + dur))
                free[s] = start + dur
                busy[s] += dur
                idx[s] += 1
                progress = True

    assert all(i == len(o) for i, o in zip(idx, ops)), \
        f"deadlocked schedule {sched.name} (S={S}, b={b})"

    # ---- dp grad-sync drain: per-stage serial channel (its own NIC) ----
    exposed = [0.0] * S
    sync_done = [0.0] * S
    if sync_events is not None:
        for s in range(S):
            evs = sorted(sync_events[s],
                         key=lambda e: max((grad_last[g] for g in e.gstages),
                                           default=0.0))
            t = 0.0
            for k, e in enumerate(evs):
                ready = max((grad_last[g] for g in e.gstages), default=0.0)
                start = max(t, ready)
                t = start + e.seconds
                if record_spans and e.seconds > 0.0:
                    spans.append(OpSpan(
                        s, "sync", k, -1,
                        e.gstages[0] if e.gstages else -1, start, t))
            sync_done[s] = t
            exposed[s] = max(0.0, t - free[s])

    # update runs after the stage's sync tail (the optimizer consumes the
    # synced grads) and is real work: it counts as busy, not bubble
    end = max(max(free[s], sync_done[s]) + t_update[s] for s in range(S))
    if record_spans:
        for s in range(S):
            if t_update[s] > 0.0:
                u0 = max(free[s], sync_done[s])
                spans.append(OpSpan(s, "U", -1, -1, -1, u0,
                                    u0 + t_update[s]))
    total_busy = [busy[s] + t_update[s] for s in range(S)]
    bubble = 1.0 - sum(total_busy) / (S * end) if end else 0.0
    return SimResult(end, total_busy, bubble, list(free), exposed,
                     grad_last, spans)
