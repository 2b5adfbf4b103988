"""Topology-aware activation resharding between pipeline stages (paper §5).

When consecutive stages use different TP degrees, the activation produced by
stage i (sharded s_tp,i-ways) must be redistributed to stage i+1 (sharded
s_tp,i+1-ways) across the slow inter-island link.  Two strategies:

  * ``naive``  — gather the full activation on every source rank, send the
    full tensor cross-island (what uniform frameworks do);
  * ``sr_ag``  — the paper's send/recv + all-gather: each source rank sends
    only a 1/max(tp_i, tp_j) shard across the island boundary, and the
    destination island reconstructs with an intra-island all-gather (cheap:
    intra-node bandwidth ≫ NIC bandwidth).

``cross_bytes``/``intra_bytes`` give the analytic byte counts used by the
cost model and the Table 9 ablation; ``choose_strategy`` is the
per-boundary argmin the grouped stage runtime (``heteropp.from_plan``,
DESIGN.md §12) and ``cost_model.evaluate`` both consume, so the executed
boundary collective and the priced one cannot drift apart.

A copy of the closed forms of the JAX package's ``core/resharding.py``,
held equal to it by ``tests/test_torch_planning.py``.  Its runnable
``reshard`` (a ``shard_map`` of both strategies) comes with the grouped
non-uniform-tp stage runtime of HeteroPP on ``torch.distributed``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ReshardCost:
    cross_bytes: int     # bytes crossing the island boundary (per boundary)
    intra_bytes: int     # bytes moved inside the destination island
    cross_messages: int


def naive_cost(act_bytes: int, tp_src: int, tp_dst: int) -> ReshardCost:
    """Full activation crosses the boundary (once per DP replica)."""
    return ReshardCost(cross_bytes=act_bytes, intra_bytes=0, cross_messages=tp_src)


def sr_ag_cost(act_bytes: int, tp_src: int, tp_dst: int) -> ReshardCost:
    """Send/recv of minimal shards + intra-island all-gather (§5):
    the boundary carries exactly one copy of the activation, split into
    max(tp_src, tp_dst) concurrent messages that saturate multiple NICs."""
    m = max(tp_src, tp_dst)
    gather = act_bytes * (tp_dst - 1) // tp_dst if tp_dst > 1 else 0
    return ReshardCost(cross_bytes=act_bytes, intra_bytes=gather,
                       cross_messages=m)


def boundary_time(act_bytes: int, tp_src: int, tp_dst: int, *,
                  nic_bw: float, intra_bw: float, strategy: str,
                  nics_per_node: int = 8) -> float:
    """Wall time of one stage-boundary reshard.

    naive: every source rank pushes the FULL activation through its NIC
    (redundant copies serialize on the boundary);
    sr_ag: one copy total, striped over min(messages, nics) NICs in
    parallel, plus the intra-island all-gather.
    """
    if strategy == "naive":
        c = naive_cost(act_bytes, tp_src, tp_dst)
        return c.cross_bytes * tp_src / (nic_bw * min(tp_src, nics_per_node))
    c = sr_ag_cost(act_bytes, tp_src, tp_dst)
    lanes = min(c.cross_messages, nics_per_node)
    t = c.cross_bytes / (nic_bw * lanes)
    if c.intra_bytes:
        t += c.intra_bytes / intra_bw
    return t


def choose_strategy(tp_src: int, tp_dst: int, *, nic_bw: float,
                    intra_bw: float, nics_per_node: int = 8) -> str:
    """Pick the cheaper boundary strategy by :func:`boundary_time`.

    Both closed forms are linear in ``act_bytes`` with no constant term,
    so the argmin is independent of the payload size — compare at a unit
    payload.  Ties go to ``sr_ag`` (the paper's default)."""
    unit = 1 << 20
    kw = dict(nic_bw=nic_bw, intra_bw=intra_bw,
              nics_per_node=nics_per_node)
    t_sr = boundary_time(unit, tp_src, tp_dst, strategy="sr_ag", **kw)
    t_nv = boundary_time(unit, tp_src, tp_dst, strategy="naive", **kw)
    return "sr_ag" if t_sr <= t_nv else "naive"
