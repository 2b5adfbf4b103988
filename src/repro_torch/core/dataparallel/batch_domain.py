"""Heterogeneous batch domains: per-dp-replica microbatch allocations.

The paper's inter-replica load balancing (§4, Table 7) assigns each
data-parallel replica a share of the global batch proportional to its
throughput, so replicas built from slower chips do not pace the
iteration.  HETHUB and HexiScale (PAPERS.md) report the same mechanism
as the largest single recovery on heterogeneous clusters.

This module is the analytic half: :func:`partition` produces the
allocations (largest-remainder rounding on top of the proportional
split, with a per-replica minimum), :func:`check_memory_caps` holds them
to per-replica activation budgets, and :func:`domain_cost` gives the
exact iteration-pacing terms the cost model charges —

    T_dp = max_r  alloc_r · t_r          (the pacing replica)
    T_lb = (Σ_r alloc_r) / (Σ_r 1/t_r)   (the fluid lower bound)

with ``imbalance = T_dp / T_lb − 1`` the exact relative bubble a domain
leaves on the table.  Uniform domains on identical replicas have
imbalance 0; uniform domains on heterogeneous replicas are the
"uniform" ablation row of ``benchmarks/bench_ablation.py``.

Non-uniform domains EXECUTE on the SPMD runtime (DESIGN.md §13): each
dp replica runs the schedule's tick program for ITS OWN allocation,
padded with bit-inert no-op ticks to the pacing replica's length
(``heteropp.domain_tick_tables``), and the global batch is sharded by
the per-replica token counts — :func:`pad_index_map` maps the tight
replica-major batch onto the padded per-replica slots the sharded
program consumes.  Per-replica WEIGHTING needs no extra machinery: the
loss is the global batch mean (CE sums and token counts psum over dp
before the division), so replica r's contribution is automatically
weighted by ``allocations[r] / total`` and the gradient sync stays the
plain sum ``grad_sync`` already performs.

A copy of the JAX package's ``core/dataparallel/batch_domain.py``,
held equal to it by ``tests/test_torch_planning.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class BatchDomain:
    """Per-dp-replica microbatch allocations for one global batch.

    ``allocations[r]`` is the number of microbatches replica r runs per
    iteration; ``throughputs[r]`` is the modeled relative rate the split
    was balanced against (microbatches per unit time; only ratios
    matter)."""
    allocations: tuple
    throughputs: tuple

    def __post_init__(self):
        assert len(self.allocations) == len(self.throughputs)
        assert all(a >= 0 for a in self.allocations), self.allocations
        assert all(t > 0 for t in self.throughputs), self.throughputs

    @property
    def dp(self) -> int:
        return len(self.allocations)

    @property
    def total(self) -> int:
        return sum(self.allocations)

    @property
    def uniform(self) -> bool:
        return len(set(self.allocations)) <= 1

    @property
    def max_allocation(self) -> int:
        return max(self.allocations)

    def describe(self) -> str:
        return f"dp={self.dp} alloc={list(self.allocations)}"


def partition(total_microbatches: int, throughputs: Sequence[float], *,
              min_per_replica: int = 1, quantum: int = 1) -> BatchDomain:
    """Split ``total_microbatches`` across replicas ∝ ``throughputs``.

    Largest-remainder rounding in units of ``quantum`` microbatches,
    with every replica guaranteed ``min_per_replica`` (a replica that
    gets zero microbatches would idle a whole pipeline).  Because every
    allocation is a multiple of ``quantum``, the floor must be one too —
    a non-multiple floor is refused loudly instead of being silently
    rounded UP to whole quanta (the old behaviour over-granted the
    documented guarantee and made the "cannot give" error fire for
    totals the caller's floor would have admitted).  Raises if the
    constraints cannot be met (too few microbatches for dp replicas)."""
    dp = len(throughputs)
    if dp < 1:
        raise ValueError("need at least one replica")
    if any(t <= 0 for t in throughputs):
        raise ValueError(f"throughputs must be positive: {throughputs}")
    if total_microbatches % quantum:
        raise ValueError(f"total_microbatches={total_microbatches} not a "
                         f"multiple of quantum={quantum}")
    if min_per_replica % quantum:
        raise ValueError(
            f"min_per_replica={min_per_replica} is not a multiple of "
            f"quantum={quantum}: allocations are handed out in whole "
            f"quanta, so a fractional floor would be silently rounded "
            f"up — pass a floor the quantum can honor exactly")
    floor_q = min_per_replica // quantum          # exact (checked above)
    units = total_microbatches // quantum
    if units < dp * floor_q:
        raise ValueError(
            f"cannot give {dp} replicas ≥{min_per_replica} microbatches "
            f"each out of {total_microbatches} (quantum {quantum})")
    tot_rate = float(sum(throughputs))
    raw = [units * t / tot_rate for t in throughputs]
    alloc = [max(floor_q, int(r)) for r in raw]
    # largest-remainder repair to the exact unit total, never dropping a
    # replica below the floor
    while sum(alloc) > units:
        cands = [i for i in range(dp) if alloc[i] > floor_q]
        i = min(cands, key=lambda i: raw[i] - alloc[i])
        alloc[i] -= 1
    while sum(alloc) < units:
        i = max(range(dp), key=lambda i: raw[i] - alloc[i])
        alloc[i] += 1
    return BatchDomain(tuple(a * quantum for a in alloc),
                       tuple(float(t) for t in throughputs))


def _argmax(values: Sequence[float]) -> int:
    """Explicit argmax with a deterministic LOWEST-INDEX tie-break —
    replicas with equal pacing time resolve to the first one, by
    strict ``>`` comparison rather than a float-equality ``.index``
    lookup on a separately computed max."""
    best = 0
    for i in range(1, len(values)):
        if values[i] > values[best]:
            best = i
    return best


def domain_cost(domain: BatchDomain,
                t_microbatch: Optional[Sequence[float]] = None) -> dict:
    """Exact pacing terms of a batch domain.

    ``t_microbatch[r]`` is replica r's time per microbatch (defaults to
    the reciprocal of the domain's throughputs).  Returns the pacing
    replica's time ``iter_time``, the fluid lower bound ``balanced``,
    and ``imbalance = iter_time / balanced − 1``.  Ties on the pacing
    time resolve to the lowest replica index (:func:`_argmax`)."""
    t = list(t_microbatch) if t_microbatch is not None else \
        [1.0 / r for r in domain.throughputs]
    assert len(t) == domain.dp, (len(t), domain.dp)
    times = [a * ti for a, ti in zip(domain.allocations, t)]
    pacing = _argmax(times)
    iter_time = times[pacing]
    balanced = domain.total / sum(1.0 / ti for ti in t)
    return {
        "iter_time": iter_time,
        "pacing_replica": pacing,
        "balanced": balanced,
        "imbalance": iter_time / balanced - 1.0 if balanced > 0 else 0.0,
        "replica_times": times,
    }


def pad_index_map(allocations: Sequence[int]) -> List[int]:
    """Slot map from the TIGHT replica-major batch layout to the padded
    per-replica layout the SPMD runtime shards (DESIGN.md §13).

    The tight layout holds ``Σ allocations`` microbatches with replica
    r's ``allocations[r]`` consecutive; the padded layout holds
    ``dp · max(allocations)`` slots so every dp shard is the same size.
    Entry ``[r · bmax + j]`` is the tight index of replica r's j-th
    local slot; pad slots (``j ≥ allocations[r]``) repeat the replica's
    LAST real microbatch — their content is never read (replica r's
    tick program only names microbatches < allocations[r]), repeating a
    real row just keeps every gather in range."""
    allocations = [int(a) for a in allocations]
    if not allocations or any(a < 1 for a in allocations):
        raise ValueError(f"allocations must be positive: {allocations}")
    bmax = max(allocations)
    idx: List[int] = []
    offset = 0
    for a in allocations:
        idx.extend(offset + min(j, a - 1) for j in range(bmax))
        offset += a
    return idx


def check_memory_caps(domain: BatchDomain, act_bytes_per_mb: float,
                      cap_bytes: Sequence[float], *,
                      inflight_cap: Optional[int] = None) -> List[bool]:
    """Per-replica activation-budget check: replica r stashes at most
    ``min(alloc_r, inflight_cap)`` microbatch activation sets of
    ``act_bytes_per_mb`` each (the schedule's in-flight bound caps the
    stash below the full allocation — pass the pipeline's
    ``schedule.inflight`` peak).  Returns one bool per replica; True
    means the allocation fits under ``cap_bytes[r]``."""
    assert len(cap_bytes) == domain.dp, (len(cap_bytes), domain.dp)
    out = []
    for a, cap in zip(domain.allocations, cap_bytes):
        stash = min(a, inflight_cap) if inflight_cap is not None else a
        out.append(stash * act_bytes_per_mb <= cap)
    return out
