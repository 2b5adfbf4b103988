"""Schedule / tick-program safety passes (H2E2xx, H2W201, H2E304).

These are the conformance-harness invariants (tests/test_schedule_
conformance.py) promoted into reusable analyzer passes: the harness now
calls these and asserts the diagnostic list is empty, and the load-time
gate runs the same passes on the exact (S, b) points a plan executes.

All passes are jax-free — they walk ``Schedule.ops`` lists and the
numpy tick tables from ``repro_torch.core.tickprogram``.

A copy of the JAX package's ``analysis/schedule_safety.py``,
held equal to it by ``tests/test_torch_planning.py``.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from ..core.schedules import get_schedule
from ..core.schedules.base import Schedule
from ..core.tickprogram import (SRC_INJECT, SRC_LOCAL, SRC_NEXT,
                                    SRC_PREV, TickTables, spmd_tick_tables)

from .diagnostics import Diagnostic, error, warning

ALPHA_TOL = 1e-6


def check_coverage(sched: Schedule, S: int, b: int) -> List[Diagnostic]:
    """H2E201: every (microbatch, chunk) appears exactly once per op
    kind per stage."""
    diags: List[Diagnostic] = []
    v = sched.n_chunks
    kinds = ("F", "D", "W") if sched.splits_backward else ("F", "B")
    want = sorted((m, k) for m in range(b) for k in range(v))
    for s, row in enumerate(sched.ops(S, b)):
        seen = {k: [] for k in kinds}
        for op in row:
            if op.kind not in kinds:
                diags.append(error(
                    "H2E201", f"unexpected op kind {op.kind!r} for "
                    f"schedule {sched.name}",
                    where=f"{sched.name} S={S} b={b} stage={s}"))
                return diags
            seen[op.kind].append((op.mb, op.chunk))
        for kind in kinds:
            if sorted(seen[kind]) != want:
                diags.append(error(
                    "H2E201", f"{kind} ops do not cover each "
                    f"(microbatch, chunk) exactly once "
                    f"({len(seen[kind])} ops for {len(want)} slots)",
                    where=f"{sched.name} S={S} b={b} stage={s}"))
    return diags


def check_placement(sched: Schedule, S: int) -> List[Diagnostic]:
    """H2E202: global_stage/device_of are inverse bijections with
    strictly increasing chunk slots."""
    diags: List[Diagnostic] = []
    v = sched.n_chunks
    where = f"{sched.name} S={S}"
    gs = [sched.global_stage(s, k, S) for s in range(S) for k in range(v)]
    if sorted(gs) != list(range(S * v)):
        diags.append(error(
            "H2E202", "global_stage is not a bijection onto "
            f"range({S * v})", where=where))
        return diags
    for s in range(S):
        slots = [sched.global_stage(s, k, S) for k in range(v)]
        if slots != sorted(set(slots)):
            diags.append(error(
                "H2E202", f"chunk slots on stage {s} are not strictly "
                f"increasing: {slots}", where=where))
        for k in range(v):
            if sched.device_of(slots[k], S) != s:
                diags.append(error(
                    "H2E202", f"device_of({slots[k]}) != {s}: placement "
                    "maps are not inverses", where=where))
    return diags


def check_causal_replay(sched: Schedule, S: int, b: int
                        ) -> List[Diagnostic]:
    """H2E203: an independent causal replay (per-stage in-order
    execution under the cross-stage readiness rules) must complete.
    Deadlock means the op order contradicts the stage topology."""
    G = S * sched.n_chunks
    ops = sched.ops(S, b)
    idx = [0] * S
    f_done, d_done = set(), set()
    while any(i < len(row) for i, row in zip(idx, ops)):
        progressed = False
        for s in range(S):
            while idx[s] < len(ops[s]):
                op = ops[s][idx[s]]
                g = sched.global_stage(s, op.chunk, S)
                if sched.device_of(g, S) != s:
                    return [error(
                        "H2E203", f"op {op} placed on stage {s} but its "
                        f"global stage {g} maps elsewhere",
                        where=f"{sched.name} S={S} b={b}")]
                if op.kind == "F":
                    ready = g == 0 or (op.mb, g - 1) in f_done
                    done = f_done
                elif op.kind in ("B", "D"):
                    ready = (op.mb, g) in f_done and \
                        (g == G - 1 or (op.mb, g + 1) in d_done)
                    done = d_done
                else:                                        # W
                    ready = (op.mb, g) in d_done
                    done = None
                if not ready:
                    break
                if done is not None:
                    done.add((op.mb, g))
                idx[s] += 1
                progressed = True
        if not progressed:
            stuck = [(s, ops[s][idx[s]]) for s in range(S)
                     if idx[s] < len(ops[s])]
            return [error(
                "H2E203", f"causal replay deadlocks; stages stuck at "
                f"{stuck[:4]}", where=f"{sched.name} S={S} b={b}")]
    return []


def check_inflight(sched: Schedule, S: int, b: int) -> List[Diagnostic]:
    """H2E204: the stash-profile walk never exceeds the closed-form
    ``inflight`` the memory-feasibility check trusts, and every stage
    frees everything it stashed."""
    diags: List[Diagnostic] = []
    free_at = "W" if sched.splits_backward else "B"
    unit = 1.0 / sched.n_chunks
    for s, row in enumerate(sched.ops(S, b)):
        held = peak = 0.0
        for op in row:
            if op.kind == "F":
                held += unit
                peak = max(peak, held)
            elif op.kind == free_at:
                held -= unit
        where = f"{sched.name} S={S} b={b} stage={s}"
        if abs(held) > 1e-9:
            diags.append(error(
                "H2E204", f"stage ends holding {held} activation sets "
                "(stash never freed)", where=where))
        bound = sched.inflight(S, b, s)
        if peak > bound + 1e-9:
            diags.append(error(
                "H2E204", f"walked peak {peak} exceeds closed form "
                f"{bound} — the memory model under-counts", where=where))
    return diags


def check_alpha(sched: Schedule, S: int, b: int) -> List[Diagnostic]:
    """H2W201: closed-form α vs the simulator-derived value.  Vacuous
    for S ≤ 1 — α only weights the OTHER stages' compute in the §4.3.2
    closed form, so a single-stage pipeline never consults it."""
    if S <= 1:
        return []
    a, da = sched.alpha(S, b), sched.derived_alpha(S, b)
    if abs(a - da) > ALPHA_TOL:
        return [warning(
            "H2W201", f"closed-form alpha {a:.6f} != simulator-derived "
            f"{da:.6f}", where=f"{sched.name} S={S} b={b}")]
    return []


def check_streamable(sched: Schedule, S: int, b: int
                     ) -> List[Diagnostic]:
    """H2E205 / H2E101: a tight tick-synchronous stream must realize
    the schedule (``spmd_tick_tables`` is the constructive proof)."""
    where = f"{sched.name} S={S} b={b}"
    try:
        spmd_tick_tables(sched, S, b)
    except NotImplementedError as e:
        return [error("H2E205", str(e), where=where)]
    except ValueError as e:
        return [error("H2E101", f"unsupported (S, b): {e}", where=where)]
    return []


def check_pad_inertness(tables: TickTables, *, where: str = ""
                        ) -> List[Diagnostic]:
    """H2E304: every active op's input producer was itself active on the
    previous tick — no op consumes a value produced on an inactive
    (padded / no-op) tick.  Works on a single replica's 2-D tables."""
    diags: List[Diagnostic] = []
    active, src = np.asarray(tables.active), np.asarray(tables.src)
    T, S = active.shape
    for t in range(T):
        for s in range(S):
            if not active[t, s]:
                continue
            code = int(src[t, s])
            if code == SRC_INJECT:
                continue
            # neighbors are circular — the ppermute ring carries the
            # interleaved wrap S−1 → 0 (see spmd_tick_tables routing)
            ps = {SRC_PREV: (s - 1) % S, SRC_NEXT: (s + 1) % S,
                  SRC_LOCAL: s}[code]
            if t == 0 or not active[t - 1, ps]:
                diags.append(error(
                    "H2E304", f"tick {t} stage {s} reads src={code} "
                    f"from ({t - 1}, {ps}) which is inactive — a pad "
                    "tick leaks into an active op",
                    where=where or None))
    return diags


def verify_schedule(sched, S: int, b: int) -> List[Diagnostic]:
    """All schedule-safety passes for one (S, b) point."""
    sched = get_schedule(sched)
    if not sched.supports(S, b):
        return [error(
            "H2E101", f"schedule {sched.name} does not support "
            f"S={S}, b={b}", where=f"{sched.name} S={S} b={b}")]
    diags = []
    diags += check_coverage(sched, S, b)
    diags += check_placement(sched, S)
    diags += check_causal_replay(sched, S, b)
    diags += check_inflight(sched, S, b)
    diags += check_alpha(sched, S, b)
    diags += check_streamable(sched, S, b)
    if not any(d.is_error for d in diags):
        tables = spmd_tick_tables(sched, S, b)
        diags += check_pad_inertness(
            tables, where=f"{sched.name} S={S} b={b}")
    return diags


@functools.lru_cache(maxsize=512)
def _verify_registered(name: str, S: int, b: int) -> Tuple[Diagnostic, ...]:
    return tuple(verify_schedule(name, S, b))


def verify_schedule_cached(sched, S: int, b: int) -> List[Diagnostic]:
    """Registry schedules are stateless: cache per (name, S, b) so the
    ``from_plan`` gate stays cheap on repeated loads."""
    sched = get_schedule(sched)
    if type(sched).__module__.startswith("repro_torch.core.schedules"):
        return list(_verify_registered(sched.name, S, b))
    return verify_schedule(sched, S, b)
