"""Static tick programs and group layouts for the SPMD pipeline —
jax-free.

This module is the pure (numpy-only) half of ``heteropp``: everything
needed to DERIVE the scan's static program from a Schedule's op lists —
the tick→(microbatch, chunk, route) tables (DESIGN.md §7), the stacked
per-replica programs of a non-uniform batch domain (§13), and the
grouped stage layout + boundary mixing tables of the non-uniform
per-stage tp runtime (§12) — without touching the jax runtime that
executes them.

Split out of ``heteropp`` so the static plan verifier
(``repro_torch.analysis``, DESIGN.md §15) can symbolically walk the exact
programs the runtime would execute — same code, no jax import.
``heteropp`` re-exports every public name, so runtime callers are
unchanged.

A copy of the JAX package's ``core/tickprogram.py``,
held equal to it by ``tests/test_torch_heteropp.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

# routing codes for TickTables.src: where a stage's input comes from
SRC_INJECT, SRC_PREV, SRC_NEXT, SRC_LOCAL = 0, 1, 2, 3


def chunk_layer_counts(phys: Sequence[int], schedule) -> Tuple[int, ...]:
    """Split per-physical-stage layer counts across a schedule's chunk
    slots (earlier slots take the remainder), returning per-global-stage
    counts in ascending-g order — the ``PipelineSpec.layers_per_stage``
    layout."""
    from .schedules import get_schedule
    sched = get_schedule(schedule)
    v, S = sched.n_chunks, len(phys)
    if v == 1:
        return tuple(phys)
    counts = [0] * (S * v)
    for s, l in enumerate(phys):
        base, extra = divmod(l, v)
        for k in range(v):
            counts[sched.global_stage(s, k, S)] = \
                base + (1 if k < extra else 0)
    return tuple(counts)


# ---------------------------------------------------------------------------
# grouped stage layout (non-uniform per-stage tp — DESIGN.md §12)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """Static device → (stage, rank) tables for the grouped runtime.

    The flat pipe mesh enumerates stage groups contiguously: device i of
    N = Σ stage_tp belongs to stage ``stage_of[i]`` as tp member
    ``rank_of[i]`` of a ``tp_of[i]``-wide group starting at mesh index
    ``offset[stage_of[i]]``.  ``member[i, j]`` is True iff devices i and
    j share a stage — the mixing matrix behind the group psum (JAX's
    ``axis_index_groups`` requires equal-size groups, which non-uniform
    tp is precisely not, so the grouped collectives are one all-gather
    over the flat axis followed by a per-device masked contraction)."""
    stage_tp: Tuple[int, ...]
    stage_of: np.ndarray      # (N,) int32
    rank_of: np.ndarray       # (N,) int32
    tp_of: np.ndarray         # (N,) int32
    offset: np.ndarray        # (S,) int32  first device of stage s
    member: np.ndarray        # (N, N) bool

    @property
    def num_devices(self) -> int:
        return int(self.stage_of.shape[0])

    @property
    def tp_min(self) -> int:
        """The smallest group width — each device's padded local shard is
        sized as a tp_min-way shard (the WIDEST local view)."""
        return int(min(self.stage_tp))


def group_layout(stage_tp: Sequence[int]) -> GroupLayout:
    stage_tp = tuple(int(t) for t in stage_tp)
    stage_of = np.repeat(np.arange(len(stage_tp)), stage_tp)
    rank_of = np.concatenate([np.arange(t) for t in stage_tp])
    tp_of = np.asarray(stage_tp)[stage_of]
    offset = np.cumsum([0] + list(stage_tp))[:-1]
    member = stage_of[:, None] == stage_of[None, :]
    return GroupLayout(stage_tp, stage_of.astype(np.int32),
                       rank_of.astype(np.int32), tp_of.astype(np.int32),
                       offset.astype(np.int32), member)


def boundary_tables(layout: GroupLayout, reshard: Sequence[str],
                    d_model: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-device send feature mask (N, d_model) and receive mixing rows
    (N, N) realizing the per-boundary reshard strategies at the value
    level (DESIGN.md §12).

    Every tick the grouped runtime moves activations with ONE fused
    ``all_gather(y * send[i])`` over the flat axis followed by
    ``recv[i] @ gathered`` per device:

    * ``sr_ag`` outgoing — tp member r of a t-wide group keeps only its
      feature slice (the t-way partition of d_model), so the boundary
      carries exactly one copy of the activation split into t shards;
      the matching recv row sums the WHOLE source group (disjoint shards
      of a group-replicated value reconstruct it exactly — the
      destination-side all-gather of the paper's send/recv + all-gather);
    * ``naive`` / ``none`` outgoing — the full activation per member;
      the recv row is one-hot at the matched source rank
      (``rank mod tp_src``), the point-to-point full-copy schedule.

    Stage 0 never receives (single-chunk schedules inject microbatches
    there), and the last stage's output is only consumed locally (loss).
    """
    N, S = layout.num_devices, len(layout.stage_tp)
    send = np.ones((N, d_model), np.float32)
    recv = np.zeros((N, N), np.float32)
    for i in range(N):
        s = int(layout.stage_of[i])
        r = int(layout.rank_of[i])
        t = int(layout.tp_of[i])
        if s < S - 1 and reshard[s] == "sr_ag":
            lo, hi = (d_model * r) // t, (d_model * (r + 1)) // t
            send[i] = 0.0
            send[i, lo:hi] = 1.0
        if s == 0:
            continue
        t_prev = int(layout.stage_tp[s - 1])
        off_prev = int(layout.offset[s - 1])
        if reshard[s - 1] == "sr_ag":
            recv[i, off_prev:off_prev + t_prev] = 1.0
        else:
            recv[i, off_prev + (r % t_prev)] = 1.0
    return send, recv


# ---------------------------------------------------------------------------
# tick programs (SPMD scan — DESIGN.md §7, §13)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TickTables:
    """Static tick→(microbatch, chunk, route) program for the SPMD scan
    (DESIGN.md §7): entry [t, s] says what physical stage s computes at
    tick t — which microbatch, which local chunk slot, and whether its
    input is a fresh injection (embed), the previous/next pipe member's
    tick-(t−1) output, or the stage's own."""
    ticks: int
    mb: np.ndarray       # (ticks, S) int32  microbatch index
    chunk: np.ndarray    # (ticks, S) int32  local chunk slot
    src: np.ndarray      # (ticks, S) int32  SRC_* routing code
    active: np.ndarray   # (ticks, S) bool
    emit: np.ndarray     # (ticks, S) bool   op is the last global stage


def spmd_tick_tables(schedule, num_stages: int, microbatches: int
                     ) -> TickTables:
    """Derive the SPMD scan's static program from a Schedule's op lists.

    The scan is tick-synchronous: one chunk-forward per pipe member per
    tick, then activations shift one hop each way via ``ppermute``.  A
    schedule is executable iff (DESIGN.md §7):

    * replaying each stage's forward op order greedily assigns every
      F(m, g) the tick EXACTLY one after F(m, g−1) — a *tight stream*.
      There is no buffering: a value not consumed the tick after it
      arrives is overwritten by the next permute;
    * every hop g−1 → g lands on the same device or a (circular) ±1
      neighbor, so one forward and one backward permute cover all routes.

    gpipe/1f1b/zb_h1 are the single-chunk diagonal special case (stage
    s's i-th forward at tick s+i); ``interleaved`` streams chunk-major
    with the circular wrap S−1 → 0; ``zb_v`` zig-zags down and back up
    the V with a device-local turn at g = S−1 → S.

    Because the stream is tight, microbatch m's whole forward chain is
    rigid — T(m, g) = t0(m) + g — so the per-stage op orders reduce to a
    system of difference constraints on the injection ticks t0:
    consecutive ops (m, g) then (m', g') on one stage need
    t0(m') ≥ t0(m) + g − g' + 1.  The least solution (relaxation to a
    fixed point) is the earliest executable tick program; an unsatisfiable
    system (positive cycle — e.g. per-stage forward orders that disagree
    with any single stream) is rejected.
    """
    from .schedules import get_schedule
    sched = get_schedule(schedule)
    S, b, v = num_stages, microbatches, sched.n_chunks
    G = S * v
    if not sched.supports(S, b):
        raise ValueError(f"schedule {sched.name!r} does not support "
                         f"S={S}, b={b}")
    f_rows = [[op for op in row if op.kind == "F"]
              for row in sched.ops(S, b)]
    for s in range(S):
        want = sorted((m, k) for k in range(v) for m in range(b))
        got = sorted((op.mb, op.chunk) for op in f_rows[s])
        if got != want:
            raise NotImplementedError(
                f"schedule {sched.name!r}: stage {s} forward ops do not "
                f"cover every (microbatch, chunk) exactly once "
                f"(DESIGN.md §7 invariant 1)")

    # difference constraints t0[m'] >= t0[m] + w from per-stage op order
    cons = []
    for s in range(S):
        row = f_rows[s]
        for a, c in zip(row, row[1:]):
            w = sched.global_stage(s, a.chunk, S) \
                - sched.global_stage(s, c.chunk, S) + 1
            if a.mb == c.mb:
                if w > 0:
                    raise NotImplementedError(
                        f"schedule {sched.name!r}: stage {s} orders "
                        f"F(mb={a.mb}) chunks against the forward chain")
                continue
            cons.append((a.mb, c.mb, w))
    t0 = [0] * b
    for _ in range(b + 2):
        changed = False
        for m, m2, w in cons:
            if t0[m2] < t0[m] + w:
                t0[m2] = t0[m] + w
                changed = True
        if not changed:
            break
    else:
        raise NotImplementedError(
            f"schedule {sched.name!r}: per-stage forward orders admit no "
            f"tight tick-synchronous stream (cyclic ordering constraints)")

    tick_of: Dict[Tuple[int, int], int] = {
        (m, g): t0[m] + g for m in range(b) for g in range(G)}
    ticks = max(tick_of.values()) + 1
    slot_of = {sched.global_stage(s, k, S): k
               for s in range(S) for k in range(v)}
    mb = np.zeros((ticks, S), np.int32)
    chunk = np.zeros((ticks, S), np.int32)
    src = np.full((ticks, S), SRC_PREV, np.int32)
    active = np.zeros((ticks, S), np.bool_)
    emit = np.zeros((ticks, S), np.bool_)
    for (m, g), t in tick_of.items():
        s = sched.device_of(g, S)
        assert not active[t, s], \
            (sched.name, "two ops on one stage in one tick", t, s)
        mb[t, s] = m
        chunk[t, s] = slot_of[g]
        active[t, s] = True
        emit[t, s] = g == G - 1
        if g == 0:
            src[t, s] = SRC_INJECT
        else:
            d_prev = sched.device_of(g - 1, S)
            if d_prev == s:
                src[t, s] = SRC_LOCAL
            elif d_prev == (s - 1) % S:
                src[t, s] = SRC_PREV
            elif d_prev == (s + 1) % S:
                src[t, s] = SRC_NEXT
            else:
                raise NotImplementedError(
                    f"schedule {sched.name!r}: hop g={g - 1}->{g} spans "
                    f"non-adjacent stages {d_prev}->{s}")
    return TickTables(ticks, mb, chunk, src, active, emit)


def domain_tick_tables(schedule, num_stages: int,
                       allocations: Sequence[int]) -> TickTables:
    """Per-dp-replica tick programs for a NON-UNIFORM batch domain,
    stacked on a middle dp dim (DESIGN.md §13).

    Replica r gets :func:`spmd_tick_tables` for ``b = allocations[r]``
    — the schedule's own program for that microbatch count — padded at
    the tail to the pacing replica's tick count with inert no-op ticks
    (``active = emit = False``; mb/chunk 0 and src ``SRC_PREV`` are
    never consulted).  Padded ticks are bit-inert: the tight-stream
    property (invariant above) means every ACTIVE op's producer ran on
    an active tick of the same replica's un-padded prefix, so no active
    op ever consumes a padded tick's output, and the loss/denominator/
    aux accumulations are all gated on ``active``/``emit``.  Tables come
    back shaped ``(ticks, dp, S)``; the runtime selects its replica's
    row by ``jax.lax.axis_index(dp_axis)``.

    Raises NotImplementedError if some replica's program is LONGER than
    the pacing (max-allocation) replica's — tick count is expected to be
    monotone in b for every registered schedule, but the contract that
    ``microbatches == max(allocations)`` prices the pacing term depends
    on it, so it is checked rather than assumed."""
    allocations = [int(a) for a in allocations]
    if not allocations or any(a < 1 for a in allocations):
        raise ValueError(f"allocations must be positive: {allocations}")
    per = [spmd_tick_tables(schedule, num_stages, a) for a in allocations]
    ticks = per[_np_argmax([t.ticks for t in per])].ticks
    pacing = spmd_tick_tables(schedule, num_stages, max(allocations))
    if ticks != pacing.ticks:
        raise NotImplementedError(
            f"schedule {schedule!r}: a replica with allocation "
            f"{allocations[_np_argmax([t.ticks for t in per])]} needs "
            f"{ticks} ticks but the pacing allocation "
            f"{max(allocations)} needs {pacing.ticks} — tick count is "
            f"not monotone in b, so the priced pacing term would not "
            f"equal the executed tick count (DESIGN.md §13)")

    def _pad(t: TickTables) -> TickTables:
        n = ticks - t.ticks
        if n == 0:
            return t
        pad_i = np.zeros((n, num_stages), np.int32)
        pad_b = np.zeros((n, num_stages), np.bool_)
        return TickTables(
            ticks,
            np.concatenate([t.mb, pad_i]),
            np.concatenate([t.chunk, pad_i]),
            np.concatenate([t.src, np.full((n, num_stages), SRC_PREV,
                                           np.int32)]),
            np.concatenate([t.active, pad_b]),
            np.concatenate([t.emit, pad_b]))

    padded = [_pad(t) for t in per]
    return TickTables(
        ticks,
        np.stack([t.mb for t in padded], axis=1),
        np.stack([t.chunk for t in padded], axis=1),
        np.stack([t.src for t in padded], axis=1),
        np.stack([t.active for t in padded], axis=1),
        np.stack([t.emit for t in padded], axis=1))


def _np_argmax(values: Sequence[int]) -> int:
    """Lowest-index argmax over a python list (no float equality)."""
    best = 0
    for i in range(1, len(values)):
        if values[i] > values[best]:
            best = i
    return best


def schedule_injection_order(schedule, num_stages: int, microbatches: int
                             ) -> List[int]:
    """Stage-0 injection order for SINGLE-chunk schedules — the diagonal-
    stream special case of :func:`spmd_tick_tables` (stage s's i-th
    forward at tick s+i, so the only degree of freedom is the order
    microbatches enter stage 0).  Kept as the compact view for tests and
    diagnostics; the runtime itself consumes the full tick tables, which
    also cover multi-chunk (interleaved / zb_v) schedules."""
    from .schedules import get_schedule
    sched = get_schedule(schedule)
    if sched.n_chunks != 1:
        raise NotImplementedError(
            f"schedule {sched.name!r} is chunked (v={sched.n_chunks}); "
            f"there is no single injection order — use spmd_tick_tables")
    tables = spmd_tick_tables(sched, num_stages, microbatches)
    inj = [int(tables.mb[t, 0]) for t in range(tables.ticks)
           if tables.active[t, 0]]
    assert sorted(inj) == list(range(microbatches)), (sched.name, inj)
    return inj
