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

The closed forms are a copy of the JAX package's ``core/resharding.py``,
held equal to it by ``tests/test_torch_planning.py``.  The runnable part
is the port's own: :func:`reshard` and :func:`hop` move an activation
across a :class:`Boundary` on ``torch.distributed`` point to point
(``comm.p2p.P2P.send_recv``), so only the messages each strategy names
cross, and their bytes are what the counters count.  The port's
convention (``core/heteropp.py``) holds an activation whole on every tp
member, so ``sr_ag`` cuts it at both groups' t-way partitions of the
feature dim, each source member sends the pieces of its own slice to the
destination members whose parts hold them, and the destination group
all-gathers its parts; ``naive`` (and ``none``, equal tp) sends the
whole activation from source member r mod tp_src to destination member
r.  The reverse hop (the gradient going back) is the same strategy with
the groups swapped: each source member gets one whole gradient, never a
sum of tp_dst copies.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F


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


# ---------------------------------------------------------------------------
# the runnable hop (torch.distributed point to point)
# ---------------------------------------------------------------------------

STRATEGIES = ("none", "naive", "sr_ag")


def _owner(i: int, width: int, t: int) -> int:
    """The member of a t-way cut of ``width`` (member r holds ``width·r
    // t`` up to ``width·(r + 1) // t``) whose slice holds index ``i``."""
    return max(r for r in range(t) if width * r // t <= i)


def boundary_messages(tp_src: int, tp_dst: int, width: int,
                      strategy: str) -> List[Tuple[int, int, int, int]]:
    """The messages of one hop of a ``width``-wide activation from a
    ``tp_src``-member group to a ``tp_dst``-member one: ``(source member,
    destination member, lo, hi)``, the feature columns ``lo:hi``.

    ``sr_ag``: the feature dim cut at both groups' t-way partitions, each
    piece from the source member whose slice holds it to the destination
    member whose part holds it: one copy of the activation crosses, in
    max(tp_src, tp_dst) pieces when one degree divides the other.
    ``naive`` / ``none``: destination member r takes the whole activation
    from source member r mod tp_src (tp_dst copies cross)."""
    if strategy == "sr_ag":
        cuts = sorted({width * r // tp_src for r in range(tp_src + 1)}
                      | {width * r // tp_dst for r in range(tp_dst + 1)})
        return [(_owner(lo, width, tp_src), _owner(lo, width, tp_dst), lo, hi)
                for lo, hi in zip(cuts, cuts[1:]) if hi > lo]
    if strategy in ("naive", "none"):
        return [(r % tp_src, r, 0, width) for r in range(tp_dst)]
    raise ValueError(f"unknown reshard strategy {strategy!r}; pick from {STRATEGIES}")


@dataclasses.dataclass(frozen=True)
class Boundary:
    """One stage boundary: the global ranks of its source and destination
    groups (member order) and its strategy."""
    src: Tuple[int, ...]
    dst: Tuple[int, ...]
    strategy: str

    def messages(self, width: int) -> List[Tuple[int, int, int, int]]:
        return boundary_messages(len(self.src), len(self.dst), width, self.strategy)

    def reversed(self) -> "Boundary":
        """The hop back (a gradient's): the same strategy, groups swapped."""
        return Boundary(self.dst, self.src, self.strategy)


def hop(p2p, like, *, send=None, recv: Optional[Boundary] = None, gather=None):
    """One exchange of this rank at up to two boundaries, in one batch of
    point-to-point messages: ``send`` ``(x, boundary)``, this rank a
    member of ``boundary.src`` sending its messages of ``x`` (zeros where
    ``x`` is None); ``recv``, a boundary whose ``dst`` holds this rank.
    ``p2p`` is a ``comm.p2p.P2P`` over the world group (global ranks);
    ``like`` gives the activation's shape and dtype; ``gather`` is this
    rank's P2P over ``recv.dst`` (an ``sr_ag`` hop into more than one
    member all-gathers its parts there).  Returns the whole activation
    that arrived (a new tensor), or None without ``recv``."""
    width = like.shape[-1]
    sends, recvs = [], []
    if send is not None:
        x, b = send
        me = b.src.index(p2p.rank)
        sends = [(None if x is None else x[..., lo:hi], b.dst[rd], like[..., lo:hi])
                 for rs, rd, lo, hi in b.messages(width) if rs == me]
    if recv is not None:
        me = recv.dst.index(p2p.rank)
        recvs = [(recv.src[rs], like[..., lo:hi])
                 for rs, rd, lo, hi in recv.messages(width) if rd == me]
    got = p2p.send_recv(sends, recvs)
    if recv is None:
        return None
    mine = got[0] if len(got) == 1 else torch.cat(got, -1)   # pieces in column order
    t = len(recv.dst)
    if recv.strategy != "sr_ag" or t == 1:
        return mine
    return _gather_parts(gather, mine, like, t)


def _gather_parts(gather, mine, like, t: int):
    """The destination group's all-gather of its members' parts of the
    feature dim (a t-way cut; unequal parts go padded to the widest)."""
    width = like.shape[-1]
    cuts = [width * r // t for r in range(t + 1)]
    sizes = [b - a for a, b in zip(cuts, cuts[1:])]
    w = max(sizes)
    if mine.shape[-1] < w:
        mine = F.pad(mine, (0, w - mine.shape[-1]))
    full = torch.empty((*like.shape[:-1], t * w), dtype=like.dtype, device=mine.device)
    gather.all_gather_(full, mine.contiguous(), like.dim() - 1)
    if all(n == w for n in sizes):
        return full
    return torch.cat([full[..., r * w:r * w + n] for r, n in enumerate(sizes)], -1)


def reshard(x, p2p, boundary: Boundary, *, gather=None, like=None):
    """Move an activation held whole by every rank of ``boundary.src`` to
    every rank of ``boundary.dst`` by the boundary's strategy (one
    :func:`hop`).  Call it on every rank of both groups: a source rank
    passes its ``x`` and gets None, a destination rank passes ``like``
    (or ``x``, for shape and dtype) and gets the activation."""
    like = x if like is None else like
    me = p2p.rank
    return hop(p2p, like, send=(x, boundary) if me in boundary.src else None,
               recv=boundary if me in boundary.dst else None, gather=gather)
