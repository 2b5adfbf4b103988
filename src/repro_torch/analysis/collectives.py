"""SPMD collective-divergence detector (H2E3xx).

Symbolically walks the exact static programs the runtime executes — the
stacked per-replica tick tables of a non-uniform batch domain
(``tickprogram.domain_tick_tables``, DESIGN.md §13) and the grouped
stage layout + boundary tables of non-uniform per-stage tp
(``tickprogram.group_layout`` / ``boundary_tables``, §12) — and proves
that every participant of every collective issues the same
(op, axis, group, order) sequence.  A mismatch on a real mesh is a
deadlock, not an error message; this pass turns it into a load-time
refusal.

The trace model mirrors ``heteropp`` exactly:

* uniform path, per tick: ``Lmax × 2`` psums over the tp axis (attn +
  mlp reductions inside ``_stage_forward``; padded layers run them too,
  which is WHY the program is SPMD-uniform), then the forward/backward
  ``ppermute`` over the pipe axis — present iff the UNION of the
  stacked tables uses that route, with the wrap edge iff any replica
  wraps; after the scan, loss/denominator/aux psums over pipe;
* grouped path, per tick: ``Lmax × 2`` group psums (one ``all_gather``
  over the flat axis + membership-row contraction, iff max tp > 1) and
  ONE fused boundary ``all_gather``; after the scan, three psums over
  the flat axis;
* after either: the bucketed dp grad psum (one psum per bucket drain,
  same order on every replica).

A copy of the JAX package's ``analysis/collectives.py``,
held equal to it by ``tests/test_torch_planning.py``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.tickprogram import (SRC_INJECT, SRC_NEXT, SRC_PREV,
                                    GroupLayout, TickTables,
                                    boundary_tables, domain_tick_tables,
                                    spmd_tick_tables)

from .diagnostics import Diagnostic, error

#: one collective issued by a participant: (op, axis, group, tag).
#: ``group`` pins the permutation / membership (a frozen tuple), ``tag``
#: the program point — two participants converge iff their full
#: sequences are equal element-wise.
Collective = Tuple[str, str, tuple, str]


def _routing(tables: TickTables) -> Tuple[bool, bool, bool, bool]:
    """(needs_prev, needs_next, wraps_prev, wraps_next) — the static
    routing facts heteropp derives from a table stack (2-D or 3-D)."""
    used = set(np.unique(tables.src[tables.active])) \
        if tables.active.any() else set()
    wraps_prev = bool(np.any(tables.active[..., 0]
                             & (tables.src[..., 0] == SRC_PREV)))
    wraps_next = bool(np.any(tables.active[..., -1]
                             & (tables.src[..., -1] == SRC_NEXT)))
    return (SRC_PREV in used, SRC_NEXT in used, wraps_prev, wraps_next)


def replica_collective_trace(tables: TickTables, *, num_stages: int,
                             tp: int = 1, max_layers: int = 1,
                             routing: Optional[Tuple[bool, bool, bool,
                                                     bool]] = None
                             ) -> Tuple[Collective, ...]:
    """The collective sequence ONE replica's program issues on the
    uniform path.  ``routing`` defaults to the replica's own tables;
    the plan driver passes the union-routing of the whole stack — what
    the stacked runtime actually compiles (DESIGN.md §13)."""
    needs_prev, needs_next, wraps_prev, wraps_next = \
        routing if routing is not None else _routing(tables)
    S = num_stages
    perm_f = tuple((i, (i + 1) % S)
                   for i in range(S if wraps_prev else S - 1))
    perm_b = tuple((i, i - 1) for i in range(1, S)) + \
        ((0, S - 1) if wraps_next else ())
    out: List[Collective] = []
    for t in range(tables.ticks):
        if tp > 1:
            for layer in range(max_layers):
                out.append(("psum", "tp", ("all",), f"t{t}.l{layer}.attn"))
                out.append(("psum", "tp", ("all",), f"t{t}.l{layer}.mlp"))
        if needs_prev:
            out.append(("ppermute", "pipe", perm_f, f"t{t}.fwd"))
        if needs_next:
            out.append(("ppermute", "pipe", perm_b, f"t{t}.bwd"))
    out.append(("psum", "pipe", ("all",), "loss"))
    out.append(("psum", "pipe", ("all",), "denom"))
    out.append(("psum", "pipe", ("all",), "aux"))
    return tuple(out)


def grouped_collective_trace(layout: GroupLayout, *, ticks: int,
                             max_layers: int = 1) -> Tuple[Collective, ...]:
    """The per-device collective sequence of the grouped runtime — one
    all_gather per group psum plus the fused boundary all_gather every
    tick, all over the flat pipe axis (so every device participates in
    every collective; divergence is structurally impossible once the
    tables are consistent, which is exactly what this certifies)."""
    tmax = max(layout.stage_tp)
    out: List[Collective] = []
    for t in range(ticks):
        if tmax > 1:
            for layer in range(max_layers):
                out.append(("all_gather", "pipe", ("all",),
                            f"t{t}.l{layer}.attn"))
                out.append(("all_gather", "pipe", ("all",),
                            f"t{t}.l{layer}.mlp"))
        out.append(("all_gather", "pipe", ("all",), f"t{t}.boundary"))
    out.append(("psum", "pipe", ("all",), "loss"))
    out.append(("psum", "pipe", ("all",), "denom"))
    out.append(("psum", "pipe", ("all",), "aux"))
    return tuple(out)


def check_convergence(traces: Sequence[Tuple[Collective, ...]], *,
                      participants: Optional[Sequence[str]] = None,
                      where: str = "") -> List[Diagnostic]:
    """H2E301/H2E302: all participants issue identical sequences."""
    if len(traces) < 2:
        return []
    names = list(participants) if participants is not None else \
        [f"participant {i}" for i in range(len(traces))]
    ref = traces[0]
    for i, tr in enumerate(traces[1:], start=1):
        if len(tr) != len(ref):
            return [error(
                "H2E301", f"{names[i]} issues {len(tr)} collectives but "
                f"{names[0]} issues {len(ref)} — the shorter participant "
                "exits the scan while the others still wait",
                where=where or None)]
        for j, (a, c) in enumerate(zip(ref, tr)):
            if a != c:
                return [error(
                    "H2E302", f"collective #{j} diverges: {names[0]} "
                    f"issues {a}, {names[i]} issues {c}",
                    where=where or None)]
    return []


def check_domain_divergence(schedule, num_stages: int,
                            allocations: Sequence[int], *,
                            tp: int = 1, max_layers: int = 1,
                            dp_sync: Optional[str] = None,
                            where: str = "") -> List[Diagnostic]:
    """Derive each dp replica's tick program and prove the stacked
    runtime's collective sequences converge (H2E301/302/303)."""
    diags: List[Diagnostic] = []
    per: List[TickTables] = []
    for r, a in enumerate(allocations):
        try:
            per.append(spmd_tick_tables(schedule, num_stages, a))
        except (ValueError, NotImplementedError) as e:
            diags.append(error(
                "H2E303", f"replica {r} (allocation {a}): {e}",
                where=where or None))
    if diags:
        return diags
    try:
        stacked = domain_tick_tables(schedule, num_stages, allocations)
    except NotImplementedError as e:
        return [error("H2E301", str(e), where=where or None)]
    routing = _routing(stacked)
    # every replica is padded to the pacing length and compiled against
    # the union routing — trace each padded program under that routing
    padded = [TickTables(stacked.ticks, stacked.mb[:, r], stacked.chunk[:, r],
                         stacked.src[:, r], stacked.active[:, r],
                         stacked.emit[:, r])
              for r in range(len(allocations))] if stacked.mb.ndim == 3 \
        else [stacked]
    traces = [replica_collective_trace(t, num_stages=num_stages, tp=tp,
                                       max_layers=max_layers,
                                       routing=routing) for t in padded]
    if dp_sync:
        # the bucketed dp grad sync drains the SAME bucket partition on
        # every replica (it is derived from the shared spec, never from
        # the replica's allocation) — one trailing dp collective per
        # replica records it in the compared sequence
        traces = [tr + (("psum", "dp", ("all",), f"grad_sync:{dp_sync}"),)
                  for tr in traces]
    diags += check_convergence(
        traces, participants=[f"replica {r} (allocation {a})"
                              for r, a in enumerate(allocations)],
        where=where)
    return diags


def check_group_tables(layout: GroupLayout, reshard: Sequence[str],
                       d_model: int, *, where: str = ""
                       ) -> List[Diagnostic]:
    """H2E305: the membership matrix partitions devices into contiguous
    stage groups and the boundary send/recv rows realize the declared
    reshard strategies — one activation copy crosses each ``sr_ag``
    boundary (the send masks tile d_model exactly), full copies with a
    one-hot matched-rank receive otherwise, and stage 0 never receives."""
    diags: List[Diagnostic] = []
    w = where or None
    N, S = layout.num_devices, len(layout.stage_tp)
    if N != int(sum(layout.stage_tp)):
        diags.append(error(
            "H2E305", f"layout has {N} devices but stage_tp sums to "
            f"{sum(layout.stage_tp)}", where=w))
        return diags
    for i in range(N):
        s = int(layout.stage_of[i])
        span = set(range(int(layout.offset[s]),
                         int(layout.offset[s]) + int(layout.stage_tp[s])))
        members = set(np.nonzero(layout.member[i])[0].tolist())
        if members != span:
            diags.append(error(
                "H2E305", f"device {i} membership row {sorted(members)} "
                f"is not stage {s}'s contiguous span {sorted(span)}",
                where=w))
    if len(reshard) != S - 1:
        diags.append(error(
            "H2E305", f"{len(reshard)} reshard strategies for the "
            f"{S - 1} stage boundaries", where=w))
        return diags
    if diags:
        return diags
    send, recv = boundary_tables(layout, reshard, d_model)
    for s in range(S - 1):
        lo, hi = int(layout.offset[s]), int(layout.offset[s + 1])
        cover = send[lo:hi].sum(axis=0)
        if reshard[s] == "sr_ag":
            if not np.all(cover == 1.0):
                diags.append(error(
                    "H2E305", f"boundary {s}->{s + 1} (sr_ag): send "
                    "masks do not tile d_model exactly once — the recv "
                    "group-sum would not reconstruct the activation",
                    where=w))
        else:
            if not np.all(send[lo:hi] == 1.0):
                diags.append(error(
                    "H2E305", f"boundary {s}->{s + 1} ({reshard[s]}): "
                    "full-copy transfer has a masked send row", where=w))
    for i in range(N):
        s = int(layout.stage_of[i])
        row = recv[i]
        if s == 0:
            if np.any(row != 0.0):
                diags.append(error(
                    "H2E305", f"stage-0 device {i} has a nonzero recv "
                    "row (stage 0 only injects)", where=w))
            continue
        lo, hi = int(layout.offset[s - 1]), int(layout.offset[s])
        if np.any(row[:lo] != 0.0) or np.any(row[hi:] != 0.0):
            diags.append(error(
                "H2E305", f"device {i} receives from outside the "
                f"previous stage's span [{lo}, {hi})", where=w))
        if reshard[s - 1] == "sr_ag":
            if not np.all(row[lo:hi] == 1.0):
                diags.append(error(
                    "H2E305", f"device {i} (sr_ag source): recv row must "
                    "sum the whole source group", where=w))
        elif int((row[lo:hi] != 0.0).sum()) != 1:
            diags.append(error(
                "H2E305", f"device {i} ({reshard[s - 1]} source): recv "
                "row is not one-hot at the matched rank", where=w))
    return diags


def check_grouped_program(schedule, stage_tp: Sequence[int],
                          reshard: Sequence[str], d_model: int, *,
                          microbatches: int, max_layers: int = 1,
                          where: str = "") -> List[Diagnostic]:
    """Full grouped-runtime check: single-chunk stream with
    INJECT/PREV-only routing (H2E305 — the one-fused-transfer
    invariant), consistent layout/boundary tables (H2E305), and a
    convergent per-device trace (vacuous by construction once the
    tables hold, but the proof is cheap)."""
    from ..core.tickprogram import group_layout
    w = where or None
    S = len(stage_tp)
    try:
        tables = spmd_tick_tables(schedule, S, microbatches)
    except NotImplementedError as e:
        return [error("H2E205", str(e), where=w)]
    except ValueError as e:
        return [error("H2E101", f"unsupported (S, b): {e}", where=w)]
    used = set(np.unique(tables.src[tables.active])) \
        if tables.active.any() else set()
    if not used <= {SRC_INJECT, SRC_PREV}:
        bad = sorted(used - {SRC_INJECT, SRC_PREV})
        return [error(
            "H2E305", f"grouped runtime moves activations with one "
            f"fused forward transfer per tick, but the stream uses "
            f"routing codes {bad} (next/local hops)", where=w)]
    layout = group_layout(stage_tp)
    diags = check_group_tables(layout, reshard, d_model, where=where)
    if diags:
        return diags
    trace = grouped_collective_trace(layout, ticks=tables.ticks,
                                     max_layers=max_layers)
    return check_convergence([trace] * layout.num_devices, where=where)
