"""Heterogeneous data-parallel subsystem (DESIGN.md §9).

Two halves, mirroring the schedule subsystem's analytic/runtime split:

* :mod:`batch_domain` — the ANALYTIC side of heterogeneous dp: split the
  global batch into per-replica microbatch allocations proportional to
  each replica's modeled throughput (paper §4's inter-replica load
  balancing), with divisibility rounding, per-replica memory-cap checks,
  and exact closed-form imbalance terms.  ``heteroauto.search`` consumes
  these for dp degrees that do not divide the global batch, and the SPMD
  runtime EXECUTES the resulting non-uniform allocations via per-replica
  tick programs padded to the pacing replica's length
  (``heteropp.domain_tick_tables`` — DESIGN.md §13).

* :mod:`grad_sync` — gradient synchronization over the dp axis: bucketed
  byte accounting with closed-form sync times over the
  ``repro_torch.comm.latency`` transports (flat all-reduce vs ZeRO-1
  reduce-scatter + all-gather), and the RUNTIME collectives the 3-D
  (dp, pipe, tp) pipeline train step executes — ``psum`` (replicated
  optimizer state) or ``reduce_scatter`` (dp-sharded optimizer state,
  the memory-capped small-chip mode).

The port has both analytic halves; the runtime collectives come with
the HeteroPP runtime on ``torch.distributed``.
"""
from .batch_domain import (BatchDomain, check_memory_caps, domain_cost,
                           pad_index_map, partition)
from .grad_sync import (GRAD_SYNC_MODES, GradBuckets, bucketize, sync_time,
                        tree_leaf_bytes, zero1_scatter_dim)

__all__ = [
    "BatchDomain", "check_memory_caps", "domain_cost", "pad_index_map",
    "partition",
    "GRAD_SYNC_MODES", "GradBuckets", "bucketize", "sync_time",
    "tree_leaf_bytes", "zero1_scatter_dim",
]
