"""Bucketed gradient synchronization over the data-parallel axis.

Analytic half — per-bucket byte accounting against the
``repro_torch.comm.latency`` transports:

* :func:`bucketize` coalesces a gradient pytree's leaves into buckets of
  ≤ ``bucket_bytes`` (a leaf larger than the budget becomes its own
  bucket), preserving leaf order so the accounting is deterministic;
* :func:`sync_time` prices a bucket list under a transport with the ring
  closed forms — every element crosses the wire ``2(dp−1)/dp`` times in
  both modes, the difference is the message structure:

      psum            one fused all-reduce over the total:
                      2(dp−1) · p2p(total/dp)
      reduce_scatter  per-bucket reduce-scatter + all-gather:
                      Σ_b 2(dp−1) · p2p(bucket_b/dp)

  so flat psum amortizes per-message latency best, while the bucketed
  ZeRO-1 mode pays one extra latency per bucket and buys optimizer-state
  sharding (×1/dp memory — the small-chip enabler the cost model's
  ``opt_bytes / dp`` term assumes) and bucket-granular overlap.

Runtime half — the collectives the 3-D (dp, pipe, tp) pipeline train
step executes (``replica_grad_norm``, ``spec_axes`` and the psum /
reduce-scatter sync inside ``heteropp``) — is not ported yet: it comes
with the HeteroPP runtime on ``torch.distributed``.  What is here is the
byte accounting the cost model prices, :func:`zero1_scatter_dim` (pure
shape arithmetic), and :func:`tree_leaf_bytes` over the port's
nested-dict trees.

Non-uniform batch domains (DESIGN.md §13) need NO sync-side weighting:
the loss is the global batch mean (CE sums and token counts psum over
dp before the division), so each replica's raw gradient is already the
allocation-weighted PARTIAL of the global gradient and both modes stay
the plain sums above — the same collectives, the same prices.

A copy of the analytic half of the JAX package's
``core/dataparallel/grad_sync.py``, held equal to it by
``tests/test_torch_planning.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ...tree import flatten

GRAD_SYNC_MODES = ("psum", "reduce_scatter")

PyTree = Any


@dataclasses.dataclass(frozen=True)
class GradBuckets:
    """Deterministic bucket assignment of gradient leaves.

    ``buckets[i]`` is a list of (leaf_name, nbytes); per-bucket byte
    totals are exact (no padding modeled — ring chunks are fractional)."""
    buckets: Tuple[Tuple[Tuple[str, int], ...], ...]
    bucket_bytes: int

    @property
    def sizes(self) -> List[int]:
        return [sum(nb for _, nb in b) for b in self.buckets]

    @property
    def total_bytes(self) -> int:
        return sum(self.sizes)

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)


def bucketize(leaf_bytes: Sequence[Tuple[str, int]],
              bucket_bytes: int = 25 * 2 ** 20) -> GradBuckets:
    """Greedy in-order coalescing of (name, nbytes) leaves into buckets
    of at most ``bucket_bytes`` each; an oversized leaf gets a bucket of
    its own (never split — one collective per bucket)."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive: {bucket_bytes}")
    buckets: List[List[Tuple[str, int]]] = []
    cur: List[Tuple[str, int]] = []
    cur_sz = 0
    for name, nb in leaf_bytes:
        if nb < 0:
            raise ValueError(f"negative leaf size {name}: {nb}")
        if cur and cur_sz + nb > bucket_bytes:
            buckets.append(cur)
            cur, cur_sz = [], 0
        cur.append((name, nb))
        cur_sz += nb
        if cur_sz >= bucket_bytes:
            buckets.append(cur)
            cur, cur_sz = [], 0
    if cur:
        buckets.append(cur)
    return GradBuckets(tuple(tuple(b) for b in buckets), bucket_bytes)


def tree_leaf_bytes(tree: PyTree) -> List[Tuple[str, int]]:
    """(path, nbytes) per leaf of a nested dict of tensors, in the
    sorted-key order ``jax.tree_util`` flattens a dict in, with its
    "/"-joined path names — the input :func:`bucketize` expects."""
    return [(path, leaf.numel() * leaf.element_size())
            for path, leaf in flatten(tree).items()]


def sync_time(buckets: GradBuckets, dp: int, transport: str = "device_rdma",
              mode: str = "reduce_scatter") -> Dict[str, Any]:
    """Closed-form sync cost of a bucket list over a dp ring.

    Returns total seconds, per-bucket seconds, and the per-member wire
    bytes (2(dp−1)/dp of the gradient volume in both modes).

    The ``psum`` figure is the fully-fused idealization (one message
    per ring round).  The runtime's bucketed psum
    (``heteropp._bucketed_dp_psum``) issues one all-reduce per bucket,
    which adds 2(dp−1)·(num_buckets−1) per-message setups over this
    model — sub-percent of the total at the default bucket sizes
    (25 MiB ⇒ ≥ MiB-scale messages), and inside the tolerance the
    overlap validation allows (DESIGN.md §10)."""
    from ...comm.latency import p2p_latency
    if mode not in GRAD_SYNC_MODES:
        raise ValueError(f"mode {mode!r} not in {GRAD_SYNC_MODES}")
    if dp < 1:
        raise ValueError(f"dp must be >= 1: {dp}")
    total = buckets.total_bytes
    wire = 2 * (dp - 1) * total / dp if dp > 1 else 0.0
    if dp == 1:
        return {"total": 0.0, "per_bucket": [0.0] * buckets.num_buckets,
                "wire_bytes": 0.0, "messages": 0}
    if mode == "psum":
        # one fused message; per-bucket attribution is bytes-proportional
        # so the list shape matches the reduce_scatter branch
        t = 2 * (dp - 1) * p2p_latency(transport, total / dp)
        per = [t * sz / total if total else 0.0 for sz in buckets.sizes]
        return {"total": t, "per_bucket": per, "wire_bytes": wire,
                "messages": 2 * (dp - 1)}
    per = [2 * (dp - 1) * p2p_latency(transport, sz / dp)
           for sz in buckets.sizes]
    return {"total": sum(per), "per_bucket": per, "wire_bytes": wire,
            "messages": 2 * (dp - 1) * buckets.num_buckets}


# ---------------------------------------------------------------------------
# ZeRO-1 shard-dim rule (used by heteropp's dp train step)
# ---------------------------------------------------------------------------

def zero1_scatter_dim(local_shape: Tuple[int, ...], dp: int,
                      taken_dims: Sequence[int] = ()) -> Optional[int]:
    """ZeRO-1 shard dim for one leaf: the first dim of the device-LOCAL
    shape divisible by dp (and not already carrying another mesh axis);
    None falls back to the replicated (whole-leaf psum) path."""
    for i, s in enumerate(local_shape):
        if i in taken_dims:
            continue
        if s >= dp and s % dp == 0:
            return i
    return None
