"""Concrete pipeline schedules (DESIGN.md §3–§4, §7).

| name          | α closed form        | inflight(k) closed form            |
|---------------|----------------------|------------------------------------|
| ``gpipe``     | 1                    | b                                  |
| ``1f1b``      | 1                    | min(b, S−k)                        |
| ``zb_h1``     | (f+d)/(f+d+w) = 2/3  | min(b, S−k)                        |
| ``interleaved``| 1/v                 | min(2(S−k−1) + (v−1)S + 1, v·b)/v  |
| ``interleaved3``| 1/v (v=3)          | same closed form at v=3            |
| ``zb_v``      | f/(v(f+d+w)) = 1/6   | min(b, S) (flat)                   |
| ``wave``      | f/(v(f+d+w)) = 1/12  | min(b, S) (flat)                   |

(f, d, w are the canonical unit times, full backward = dgrad + wgrad =
2·forward; inflight is in full-stage activation sets, so chunked
schedules count 1/v per stashed chunk.)  Every closed form shipped here
is regression-tested against the op-list derivation
(``Schedule.derived_alpha`` / ``derived_inflight``) in
``tests/test_schedules.py`` — the op lists are the source of truth, the
closed forms keep ``cost_model.evaluate`` / ``heteroauto.search`` O(1)
per candidate plan.  The per-chunk ``wgrad_tails`` windows (the
grad-sync overlap contract, DESIGN.md §10) are closed forms too:
all-zero for single-chunk schedules, (v−1−k)·w/v for the zig-zag
greedy family, k·S·(d+w)/v for chunk-major interleaving.

A copy of the JAX package's ``core/schedules/library.py``,
held equal to it by ``tests/test_torch_planning.py``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .base import Op, Schedule, register


class GPipe(Schedule):
    """All forwards, then all backwards.  α = 1 (same time-bubble as
    1F1B on uniform stages) but every microbatch's activations stay
    stashed until its backward: inflight = b at every stage.  This is the
    schedule the SPMD runtime's autodiff-through-scan realizes."""

    name = "gpipe"

    def ops(self, S: int, b: int) -> List[List[Op]]:
        row = [Op("F", m) for m in range(b)] + [Op("B", m) for m in range(b)]
        return [list(row) for _ in range(S)]

    def alpha(self, num_stages=None, microbatches=None) -> float:
        return 1.0

    def inflight(self, S: int, b: int, stage: int) -> float:
        return float(b)


class OneFOneB(Schedule):
    """Classic 1F1B: stage s warms up with min(S−s, b) forwards then
    alternates B/F.  α = 1; inflight(k) = min(b, S−k) — the paper's
    Observation #4 memory rule."""

    name = "1f1b"

    def ops(self, S: int, b: int) -> List[List[Op]]:
        out = []
        for s in range(S):
            warmup = min(S - s, b)
            seq = [Op("F", m) for m in range(warmup)]
            nf, nb = warmup, 0
            while nb < b:
                seq.append(Op("B", nb))
                nb += 1
                if nf < b:
                    seq.append(Op("F", nf))
                    nf += 1
            out.append(seq)
        return out

    def alpha(self, num_stages=None, microbatches=None) -> float:
        return 1.0

    def inflight(self, S: int, b: int, stage: int) -> float:
        return float(min(b, S - stage))


class ZBH1(Schedule):
    """ZB-H1-style backward split (Qi et al., zero-bubble pipelining).

    Backward is split into dgrad (D, unlocks the upstream stage) and
    wgrad (W, local weight gradient).  Stage s runs the 1F1B pattern with
    B → (D, W): downstream stages only wait on D, so the cooldown wave
    propagates at dgrad speed and each stage's W fills what was bubble in
    1F1B — wgrad genuinely slides off the critical path.  W(m) is issued
    right after D(m), so the stashed-activation profile is exactly
    1F1B's: inflight(k) = min(b, S−k).

    α = (f + d) / (f + d + w): only fwd+dgrad remain on the fill/drain
    path.  With the canonical f:d:w = 1:1:1 units (full bwd = 2·fwd)
    that is 2/3 — between the paper's 1F1B (α=1) and ideal ZB-V (α=0).
    """

    name = "zb_h1"
    splits_backward = True

    def ops(self, S: int, b: int) -> List[List[Op]]:
        out = []
        for s in range(S):
            warmup = min(S - s, b)
            seq = [Op("F", m) for m in range(warmup)]
            nf = warmup
            nd = 0
            while nd < b:
                seq.append(Op("D", nd))
                seq.append(Op("W", nd))
                nd += 1
                if nf < b:
                    seq.append(Op("F", nf))
                    nf += 1
            out.append(seq)
        return out

    def alpha(self, num_stages=None, microbatches=None) -> float:
        f, d, w = self.UNIT_F, self.UNIT_D, self.UNIT_W
        return (f + d) / (f + d + w)

    def inflight(self, S: int, b: int, stage: int) -> float:
        return float(min(b, S - stage))


class Interleaved1F1B(Schedule):
    """Interleaved (virtual-stage) 1F1B, Megatron-style: each physical
    stage holds ``n_chunks`` model chunks of 1/v of its layers; global
    pipeline depth becomes S·v while fill/drain cost per chunk shrinks by
    v, so α = 1/v.  Microbatches advance in groups of S per chunk;
    requires b % S == 0 (the Megatron constraint).  Memory rises: the
    extra warmup chunks stay stashed (profile derived from the op lists).
    """

    def __init__(self, n_chunks: int = 2):
        super().__init__()
        assert n_chunks >= 2
        self.n_chunks = n_chunks
        self.name = "interleaved" if n_chunks == 2 else \
            f"interleaved{n_chunks}"

    def supports(self, S: int, b: int) -> bool:
        return S >= 2 and b >= S and b % S == 0

    def _orders(self, S: int, b: int):
        v = self.n_chunks
        fwd = [(c, g * S + k) for g in range(b // S)
               for c in range(v) for k in range(S)]
        bwd = [(c, g * S + k) for g in range(b // S)
               for c in reversed(range(v)) for k in range(S)]
        return fwd, bwd

    def ops(self, S: int, b: int) -> List[List[Op]]:
        assert self.supports(S, b), (S, b, self.name)
        v = self.n_chunks
        forder, border = self._orders(S, b)
        total = v * b
        out = []
        for s in range(S):
            warmup = min(2 * (S - s - 1) + (v - 1) * S + 1, total)
            seq = [Op("F", m, c) for c, m in forder[:warmup]]
            nf, nb = warmup, 0
            while nb < total:
                c, m = border[nb]
                seq.append(Op("B", m, c))
                nb += 1
                if nf < total:
                    c, m = forder[nf]
                    seq.append(Op("F", m, c))
                    nf += 1
            out.append(seq)
        return out

    def alpha(self, num_stages=None, microbatches=None) -> float:
        return 1.0 / self.n_chunks

    def inflight(self, S: int, b: int, stage: int) -> float:
        """Closed form (O(1), keeps schedule search from deriving op lists
        per (S, b)): the warmup forwards are the peak — after warmup the
        steady state alternates B/F, so the stash never grows again.
        Warmup at stage k is min(2(S−k−1) + (v−1)S + 1, v·b) chunk ops,
        each stashing 1/v of a full-stage activation set."""
        v = self.n_chunks
        return min(2 * (S - stage - 1) + (v - 1) * S + 1, v * b) / v

    def wgrad_tails(self, num_stages: int, microbatches: int
                    ) -> List[float]:
        """Chunk-major drains chunks in DESCENDING slot order per group
        of S microbatches: after chunk k's last backward the stage still
        runs the k lower chunks' backwards of the final group — k·S
        chunk-backward ops of (d+w)/v each."""
        f, d, w = self.UNIT_F, self.UNIT_D, self.UNIT_W
        v = self.n_chunks
        return [k * num_stages * (d + w) / v for k in range(v)]


class _GreedyZigZag(Schedule):
    """Shared greedy list-scheduler for zig-zag chunk placements whose
    leg turns are device-local hops (the V of ZB-V, the W of ``wave``).

    Subclasses fix ``n_chunks`` and the placement
    (``global_stage``/``device_of``) plus the forward injection tick
    ``_t0(m, S)``; the construction below is placement-generic.  Op
    lists come from a deterministic greedy: priority dgrad > forward >
    wgrad (the dgrad chain is the critical path, wgrad fills what would
    otherwise be bubble), with forward injection throttled so no device
    ever stashes more than ``_stash_cap`` full-stage activation sets.
    ``ops`` builds the canonical order (unit times); ``ops_timed``
    re-runs the same greedy at profiled per-stage durations — the ZB
    papers schedule at measured times, and a canonical-ratio order
    replays poorly when dgrad ≠ wgrad — which is what the simulator
    uses.  Per-device forward order is in both cases the tight stream
    sorted by injection tick ``_t0(m, S) + g``, exactly the order the
    SPMD runtime's tick-synchronous scan requires (DESIGN §7).
    """

    splits_backward = True

    def __init__(self):
        super().__init__()
        self._ops_cache: Dict[Tuple[int, int], List[List[Op]]] = {}

    def supports(self, S: int, b: int) -> bool:
        return S >= 2 and b >= S

    def _t0(self, m: int, S: int) -> int:
        """Forward injection tick of microbatch m (the tight-stream
        schedule is rigid: F(m, g) runs at tick _t0(m) + g)."""
        raise NotImplementedError

    def _stash_cap(self, S: int, b: int) -> float:
        """Peak stashed activation sets per device (full-stage units)."""
        return float(min(b, S))

    def ops(self, S: int, b: int) -> List[List[Op]]:
        return self.ops_timed(S, b, [1.0] * S, [1.0] * S, [1.0] * S)

    def ops_timed(self, S: int, b: int, fdur, ddur, wdur) -> List[List[Op]]:
        assert self.supports(S, b), (S, b, self.name)
        key = (S, b, tuple(fdur), tuple(ddur), tuple(wdur))
        seq = self._ops_cache.get(key)
        if seq is None:
            seq = self._construct(S, b, list(fdur), list(ddur), list(wdur))
            if len(self._ops_cache) > 64:
                self._ops_cache.clear()
            self._ops_cache[key] = seq
        return seq

    def _construct(self, S: int, b: int, fdur, ddur, wdur
                   ) -> List[List[Op]]:
        """Continuous-time greedy list scheduler: repeatedly run, on the
        device whose best candidate starts earliest, the highest-priority
        op ready at that moment (D > F > W on ties).  Dgrad candidates
        are maintained incrementally — an op enters its device's unlocked
        list when its own F and the downstream D are scheduled (their
        finish times then known) — so each of the 3·v·b·S iterations
        scans only the O(drain-wave) unlocked set, not every pending op."""
        import heapq
        v, G = self.n_chunks, self.n_chunks * S
        gmap = [[self.global_stage(s, k, S) for k in range(v)]
                for s in range(S)]
        slot = {gmap[s][k]: k for s in range(S) for k in range(v)}
        # per-device forward order: the tight stream sorted by the
        # injection tick _t0(m) + g; subclasses choose _t0 so that no
        # two chunk streams of one device ever collide on a tick
        f_stream = []
        for s in range(S):
            keyed = sorted((self._t0(m, S) + gmap[s][k], m, k)
                           for k in range(v) for m in range(b))
            f_stream.append([(m, k) for _, m, k in keyed])
        cap = v * self._stash_cap(S, b)      # stash cap, in chunk units
        f_done: Dict[Tuple[int, int], float] = {}  # (m, g) -> finish time
        d_done: Dict[Tuple[int, int], float] = {}
        seq: List[List[Op]] = [[] for _ in range(S)]
        free = [0.0] * S
        held = [0] * S
        f_idx = [0] * S
        # unlocked_d[s]: (dep-ready time, (m, -g), k) — deps scheduled
        unlocked_d: List[List[Tuple[float, Tuple[int, int], int]]] = \
            [[] for _ in range(S)]
        pend_w: List[List[Tuple[int, int, int]]] = [[] for _ in range(S)]

        def unlock_d(m: int, g: int) -> None:
            core = f_done[(m, g)] if g == G - 1 else \
                max(f_done[(m, g)], d_done[(m, g + 1)])
            s = self.device_of(g, S)
            unlocked_d[s].append((core, (m, -g), slot[g]))

        for _ in range(3 * v * b * S):
            best = None
            for s in range(S):
                cands = []
                # 1) dgrad: the critical chain (lowest mb, highest g)
                if unlocked_d[s]:
                    core, key, k = min(
                        unlocked_d[s],
                        key=lambda x: (max(free[s], x[0]), x[1]))
                    cands.append((max(free[s], core), 0,
                                  ("D", key[0], -key[1], k)))
                # 2) forward, in tight-stream order, memory-throttled
                if f_idx[s] < len(f_stream[s]) and held[s] + 1 <= cap:
                    m, k = f_stream[s][f_idx[s]]
                    g = gmap[s][k]
                    dep = f_done.get((m, g - 1)) if g else 0.0
                    if dep is not None:
                        cands.append((max(free[s], dep), 1, ("F", m, g, k)))
                # 3) wgrad fills the bubble
                if pend_w[s]:
                    m, g, k = pend_w[s][0]
                    cands.append((free[s], 2, ("W", m, g, k)))
                if not cands:
                    continue
                t, pr, op = min(cands)
                if best is None or (t, pr, s) < best[:3]:
                    best = (t, pr, s, op)
            assert best is not None, ("zb_v construction stalled", S, b)
            t, _, s, (kind, m, g, k) = best
            if kind == "D":
                unlocked_d[s] = [x for x in unlocked_d[s]
                                 if x[1] != (m, -g)]
                d_done[(m, g)] = t + ddur[s]
                free[s] = t + ddur[s]
                heapq.heappush(pend_w[s], (m, g, k))
                if g > 0 and (m, g - 1) in f_done:
                    unlock_d(m, g - 1)
            elif kind == "F":
                f_idx[s] += 1
                f_done[(m, g)] = t + fdur[s]
                free[s] = t + fdur[s]
                held[s] += 1
                if g == G - 1 or (m, g + 1) in d_done:
                    unlock_d(m, g)
            else:
                heapq.heappop(pend_w[s])
                free[s] = t + wdur[s]
                held[s] -= 1
            seq[s].append(Op(kind, m, k))
        return seq

    def alpha(self, num_stages=None, microbatches=None) -> float:
        # the only residual bubble of a zig-zag greedy is the forward
        # fill ramp: S−1 chunk-forward hops of f/v each
        f, d, w = self.UNIT_F, self.UNIT_D, self.UNIT_W
        return f / (self.n_chunks * (f + d + w))

    def inflight(self, S: int, b: int, stage: int) -> float:
        return self._stash_cap(S, b)

    def wgrad_tails(self, num_stages: int, microbatches: int
                    ) -> List[float]:
        """The greedy defers wgrad to fill bubbles, so each chunk's
        final W lands in the end-of-iteration W backlog: slot k (whose
        pending W sorts before the higher slots') completes v−1−k
        wgrad ops of w/v each before the stage's last op."""
        f, d, w = self.UNIT_F, self.UNIT_D, self.UNIT_W
        v = self.n_chunks
        return [(v - 1 - k) * w / v for k in range(v)]


class ZBV(_GreedyZigZag):
    """ZB-V (Qi et al., "Pipeline Parallelism with Controllable Memory"):
    two chunks per device placed in a V — device s hosts global stages
    ``s`` (down the left leg) and ``2S−1−s`` (back up the right leg) — so
    the turn of the V (g = S−1 → S) is a *local* hop and the drain chain
    re-enters each device immediately.  Backward is split into dgrad /
    wgrad like ZB-H1; wgrad is the bubble filler (greedy construction:
    see :class:`_GreedyZigZag`).

    α = f/(v·(f+d+w)) = 1/6 at canonical units: the only residual bubble
    is the forward fill ramp (S−1 chunk-forward hops), which a single-
    iteration replay cannot remove; the paper's "ZB-V ⇒ α = 0" drops the
    ramp (exact in the repeated-iteration regime where iteration k+1's
    warmup fills iteration k's cooldown).  inflight(k) = min(b, S), flat:
    every device stashes the same peak — equal to 1F1B's *worst* stage,
    but not decreasing toward the tail like 1F1B's min(b, S−k).

    Requires b ≥ S: with fewer microbatches the drain starves the filler
    and the derived α degrades above the closed form.
    """

    name = "zb_v"
    n_chunks = 2

    def global_stage(self, stage: int, chunk: int, num_stages: int) -> int:
        return stage if chunk == 0 else 2 * num_stages - 1 - stage

    def device_of(self, g: int, num_stages: int) -> int:
        return g if g < num_stages else 2 * num_stages - 1 - g

    def _t0(self, m: int, S: int) -> int:
        # inject every 2 ticks: a device's chunk streams sit at offsets
        # s and 2S−1−s, whose difference is odd — never a collision
        return 2 * m


class Wave(_GreedyZigZag):
    """W-shaped ("wave") placement — the v = 4 member of the zig-zag
    family (Hanayo-style wave pipelining composed with the zero-bubble
    backward split): device s hosts global stages ``s`` (down),
    ``2S−1−s`` (up), ``2S+s`` (down again) and ``4S−1−s`` (up again).
    All three leg turns (g = S−1→S at device S−1, 2S−1→2S at device 0,
    3S−1→3S at device S−1) are device-local hops, so like ZB-V the
    drain never pays a wrap-around transfer.

    Doubling the chunk count halves the fill ramp again:
    α = f/(v·(f+d+w)) = **1/12** at canonical units — half of ZB-V's
    1/6 — at the same flat min(b, S) activation stash (the cap is in
    full-stage sets; wave stashes 4 quarter-chunks where ZB-V stashes 2
    half-chunks).  The price is tick-stream density: a device hosts two
    SAME-parity chunk streams (offsets s and 2S+s differ by 2S), so
    injections must avoid pairwise tick differences of exactly 2S —
    microbatches enter in groups of S two ticks apart, with a 2S+2 gap
    between groups (``_t0``); forward throughput is unchanged because
    each device runs v = 4 chunk-forwards per microbatch.

    Grad-sync overlap is where the W shape pays off (DESIGN.md §10):
    with 4 chunks per device, 3/4 of each stage's gradient buckets are
    ready before the stage's final wgrad, so more of the dp sync hides
    under the wgrad wave than ZB-V (1/2) or any single-chunk schedule
    (none).
    """

    name = "wave"
    n_chunks = 4

    def global_stage(self, stage: int, chunk: int, num_stages: int) -> int:
        S = num_stages
        leg = chunk
        if leg == 0:
            return stage
        if leg == 1:
            return 2 * S - 1 - stage
        if leg == 2:
            return 2 * S + stage
        return 4 * S - 1 - stage

    def device_of(self, g: int, num_stages: int) -> int:
        leg, r = divmod(g, num_stages)
        return r if leg % 2 == 0 else num_stages - 1 - r

    def _t0(self, m: int, S: int) -> int:
        # groups of S microbatches at spacing 2, groups 4S apart: the
        # same-parity streams (offset difference exactly 2S) never
        # collide because no two injection ticks differ by exactly 2S
        return 4 * S * (m // S) + 2 * (m % S)


register(GPipe())
register(OneFOneB())
register(ZBH1())
register(Interleaved1F1B(2))
# v=3 virtual stages: α = 1/3 between interleaved (1/2) and zb_v (1/6),
# at a higher warmup stash (closed forms are v-generic; the conformance
# harness in tests/test_schedule_conformance.py covers it like any other
# registry entry, and the runtime executes it via the same tick tables)
register(Interleaved1F1B(3))
register(ZBV())
register(Wave())
