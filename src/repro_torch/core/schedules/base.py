"""Pipeline-schedule abstraction (DESIGN.md §3, §7).

A :class:`Schedule` is defined by TWO things: the per-stage list of typed
ops it executes — forward (``F``), combined backward (``B``), or the
backward split into dgrad (``D``) and wgrad (``W``) — and, for chunked
(virtual-stage) schedules, the *placement* of model chunks on physical
stages (:meth:`Schedule.global_stage` / :meth:`Schedule.device_of`).
Everything else the system needs is *derived* from that structure:

* the event-driven simulator (``simulator.py``) replays the op lists with
  per-stage heterogeneous times → makespan / bubble (Table 9 ablations);
* the cost model's bubble coefficient α (paper §4.3.2) — each schedule
  ships a closed form, and :meth:`Schedule.derived_alpha` re-derives it
  from the op lists with canonical unit times so the closed forms are
  regression-tested against the abstraction rather than trusted.
  Shipped α closed forms: gpipe 1, 1f1b 1, zb_h1 (f+d)/(f+d+w) = 2/3,
  interleaved 1/v, zb_v f/(v·(f+d+w)) = 1/6 (the irreducible fill ramp;
  the paper's "ZB-V ⇒ α = 0" idealization drops the ramp entirely,
  which is exact only in the repeated-iteration regime);
* the in-flight-microbatch memory profile (paper Observation #4,
  generalized beyond 1F1B) consumed by the memory-feasibility check —
  :meth:`Schedule.derived_inflight` walks each stage's op list counting
  stashed forward activations (freed at ``B``, or at ``W`` for
  backward-split schedules, since wgrad still needs the layer input).
  Shipped closed forms: gpipe b, 1f1b/zb_h1 min(b, S−k), interleaved
  min(2(S−k−1) + (v−1)S + 1, v·b)/v, zb_v min(b, S) flat;
* the SPMD runtime's tick→(microbatch, chunk) tables
  (``repro.core.heteropp.spmd_tick_tables``) — the op lists' per-stage
  forward order plus the placement determine which neighbor each device
  reads from at every tick (DESIGN.md §7).

Concrete schedules live in ``library.py`` and self-register; look them up
with :func:`get_schedule`.

A copy of the JAX package's ``core/schedules/base.py``,
held equal to it by ``tests/test_torch_planning.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

ScheduleLike = Union[str, "Schedule"]


@dataclasses.dataclass(frozen=True)
class Op:
    """One unit of per-stage work.

    kind:  "F" forward | "B" full backward | "D" dgrad | "W" wgrad
    mb:    microbatch index
    chunk: virtual-stage chunk (interleaved schedules; 0 otherwise)
    """
    kind: str
    mb: int
    chunk: int = 0


class Schedule:
    """Base class: subclasses implement :meth:`ops` plus a closed-form
    :meth:`alpha` / :meth:`inflight`; the ``derived_*`` methods compute the
    same quantities from the op lists for cross-validation."""

    name: str = "?"
    n_chunks: int = 1              # virtual stages per physical stage
    splits_backward: bool = False  # emits D/W instead of B

    # canonical unit times (f : dgrad : wgrad) used for the α derivation;
    # full backward = dgrad + wgrad = 2f, the transformer rule of thumb
    UNIT_F, UNIT_D, UNIT_W = 1.0, 1.0, 1.0

    def __init__(self):
        self._inflight_cache: Dict[tuple, List[float]] = {}
        self._tail_cache: Dict[tuple, List[List[float]]] = {}

    # ------------------------------------------------------------------ ops
    def ops(self, num_stages: int, microbatches: int) -> List[List[Op]]:
        raise NotImplementedError

    def ops_timed(self, num_stages: int, microbatches: int,
                  fdur: Sequence[float], ddur: Sequence[float],
                  wdur: Sequence[float]) -> List[List[Op]]:
        """Op lists specialized to per-stage per-chunk durations.  Most
        schedules have one canonical order and ignore the times; ZB-V
        re-runs its greedy construction at the profiled durations (the ZB
        papers schedule at measured times), which the simulator uses so
        the replay reflects what the heuristic would actually emit."""
        return self.ops(num_stages, microbatches)

    def supports(self, num_stages: int, microbatches: int) -> bool:
        """Whether this schedule is well-formed for (S, b)."""
        return num_stages >= 1 and microbatches >= 1

    # ----------------------------------------------------------- placement
    def global_stage(self, stage: int, chunk: int, num_stages: int) -> int:
        """Global chunk-stage index g hosted by (physical stage, local
        chunk slot).  Model layers are assigned to global stages in
        ascending-g order, so this mapping IS the chunk placement.
        Default: chunk-major (Megatron interleaved), g = chunk·S + stage.
        ZB-V overrides with the V shape.  Required invariant: for a fixed
        stage, g must be strictly increasing in the chunk slot."""
        return chunk * num_stages + stage

    def device_of(self, g: int, num_stages: int) -> int:
        """Physical stage hosting global chunk-stage ``g`` (the inverse
        of :meth:`global_stage`)."""
        return g % num_stages

    # ---------------------------------------------------------------- alpha
    def alpha(self, num_stages: Optional[int] = None,
              microbatches: Optional[int] = None) -> float:
        """Closed-form bubble coefficient for the §4.3.2 cost model:
        iter_time = max_i(b·T_i + T_i^upd + α·Σ_{j≠i} T_j)."""
        raise NotImplementedError

    def derived_alpha(self, num_stages: int, microbatches: int) -> float:
        """Re-derive α from the op lists: replay with canonical unit times
        and zero transfer cost, then invert the uniform-pipeline closed
        form T = b·T_c + α·(S−1)·T_c."""
        from .simulator import simulate
        S, b = num_stages, microbatches
        if S <= 1:
            return 0.0
        f, d, w = self.UNIT_F, self.UNIT_D, self.UNIT_W
        tc = f + d + w
        r = simulate(self, [f] * S, [d + w] * S, b, [0.0] * (S - 1),
                     wgrad_frac=w / (d + w))
        return max(0.0, (r.makespan - b * tc) / ((S - 1) * tc))

    # --------------------------------------------------------------- memory
    def inflight(self, num_stages: int, microbatches: int, stage: int
                 ) -> float:
        """Peak number of in-flight microbatch activation sets held by
        global stage ``stage`` (in full-stage units; may be fractional for
        chunked schedules).  Default: derived from the op lists, cached
        per (S, b)."""
        return self.inflight_profile(num_stages, microbatches)[stage]

    def inflight_profile(self, num_stages: int, microbatches: int
                         ) -> List[float]:
        key = (num_stages, microbatches)
        prof = self._inflight_cache.get(key)
        if prof is None:
            prof = self.derived_inflight(num_stages, microbatches)
            if len(self._inflight_cache) > 256:
                self._inflight_cache.clear()
            self._inflight_cache[key] = prof
        return prof

    def derived_inflight(self, num_stages: int, microbatches: int
                         ) -> List[float]:
        """Walk each stage's op list: +1 activation set on F, freed at B
        (or at W for backward-split schedules).  Chunk ops stash 1/v of a
        stage's activation set."""
        free_at = "W" if self.splits_backward else "B"
        unit = 1.0 / self.n_chunks
        out = []
        for seq in self.ops(num_stages, microbatches):
            held = peak = 0.0
            for op in seq:
                if op.kind == "F":
                    held += unit
                    peak = max(peak, held)
                elif op.kind == free_at:
                    held -= unit
            out.append(peak)
        return out

    # ------------------------------------------------------------ grad sync
    def wgrad_tails(self, num_stages: int, microbatches: int
                    ) -> List[float]:
        """Closed-form per-chunk-slot wgrad tail windows (canonical
        units): how long before the stage's final compute op chunk slot
        k's last weight-gradient completes — the window in which that
        chunk's gradient buckets drain over the dp transport while the
        stage is still computing (DESIGN.md §10).  O(1) like ``alpha``/
        ``inflight`` so ``cost_model.evaluate`` stays O(1) per plan;
        regression-tested against :meth:`wgrad_tail_profile` (boundary
        stages may differ by up to one backward op — the tolerance the
        test allows).  Default: all-zero (single-chunk schedules only
        finalize their gradients at the very last backward)."""
        return [0.0] * self.n_chunks

    def wgrad_tail_profile(self, num_stages: int, microbatches: int
                           ) -> List[List[float]]:
        """Per physical stage, per chunk slot: the canonical-unit time
        between the chunk's LAST weight-gradient op (W, or B for
        single-``B`` schedules) and the stage's final compute op —
        the window in which that chunk's gradient buckets can drain
        over the dp transport while the stage is still busy with the
        rest of its wgrad wave (DESIGN.md §10).

        Derived by replaying the op lists at canonical unit times (like
        :meth:`derived_alpha`) and cached per (S, b); one unit is
        (f + d + w) per microbatch per stage, so consumers scale by
        ``t_stage_per_microbatch / (UNIT_F + UNIT_D + UNIT_W)``.
        Single-chunk schedules have a single all-zero column (the
        stage's grads are only final at its very last backward);
        chunked schedules expose the earlier chunks' windows — the
        grad-sync overlap the zig-zag placements buy."""
        key = (num_stages, microbatches)
        prof = self._tail_cache.get(key)
        if prof is None:
            from .simulator import simulate
            S, b, v = num_stages, microbatches, self.n_chunks
            f, d, w = self.UNIT_F, self.UNIT_D, self.UNIT_W
            r = simulate(self, [f] * S, [d + w] * S, b, [0.0] * (S - 1),
                         wgrad_frac=w / (d + w))
            prof = [[max(0.0, r.stage_end[s]
                         - r.grad_last[self.global_stage(s, k, S)])
                     for k in range(v)] for s in range(S)]
            if len(self._tail_cache) > 256:
                self._tail_cache.clear()
            self._tail_cache[key] = prof
        return prof

    # ------------------------------------------------------------- analysis
    def verify(self, num_stages: int, microbatches: int) -> list:
        """Run the static safety passes (``repro_torch.analysis``, DESIGN.md
        §15) on this schedule at one (S, b) point: op coverage,
        placement bijection, causal replay, inflight bound, α
        cross-check, streamability, pad inertness.  Returns the
        diagnostic list — empty means safe to execute."""
        from ...analysis.schedule_safety import verify_schedule
        return verify_schedule(self, num_stages, microbatches)

    def __repr__(self):
        return f"<Schedule {self.name}>"


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Schedule] = {}


def register(sched: Schedule) -> Schedule:
    _REGISTRY[sched.name] = sched
    return sched


def get_schedule(sched: ScheduleLike) -> Schedule:
    if isinstance(sched, Schedule):
        return sched
    try:
        return _REGISTRY[sched]
    except KeyError:
        raise KeyError(f"unknown schedule {sched!r}; "
                       f"available: {available_schedules()}") from None


def available_schedules() -> List[str]:
    return sorted(_REGISTRY)
