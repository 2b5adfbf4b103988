"""The collectives of the HeteroPP runtime: the one-hop exchange between
pipeline stages (the port's counterpart of ``jax.lax.ppermute``, the JAX
package's DiComm device-direct hop), and the all-reduce, reduce-scatter
and all-gather of its tensor- and data-parallel groups, each over one
``torch.distributed`` process group.  :class:`Grid` builds the groups of
a (dp, pipe, tp) rank grid, or of the grouped runtime's flat layout in
which each stage has a tp degree of its own (:meth:`Grid.grouped`).

Two transports, which the caller names; nothing picks one quietly:

* ``"device"``: NCCL, one card a rank.  Tensors go from card to card;
  the exchange's time includes a device synchronize, since NCCL's wait
  only orders the stream.
  Fewer cards than ranks raises (NCCL refuses two ranks on one card);
  the error names ``--p2p host``.
* ``"host"``: gloo.  A CUDA tensor is staged through a pinned host
  buffer on both sides (gloo's send and receive take host tensors); a
  CPU tensor goes as it is.  This is what the CPU tests and one card
  with several ranks use.

:class:`P2P` counts the bytes it sends, the wall time of its exchanges
(waiting for the peer included) and, of that, the time of the staging
copies, so a run can report them a tick; and the wall time of each kind
of collective (and the bytes an all-gather brings in), so a run can
report it for each group.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TRANSPORTS = ("device", "host")
BACKENDS = {"device": "nccl", "host": "gloo"}

Perm = Sequence[Tuple[int, int]]
# gloo sums these through an fp32 buffer (exact for two summands)
NARROW = (torch.bfloat16, torch.float16)


def check_transport(transport: str, device: torch.device, world_size: int) -> None:
    """Raise unless ``transport`` can join ``world_size`` ranks on this
    machine whose tensors live on ``device`` (its type: ``cpu`` or
    ``cuda``)."""
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown p2p transport {transport!r}; expected one of "
                         f"{TRANSPORTS}")
    if transport != "device":
        return
    if device.type != "cuda":
        raise ValueError("p2p transport 'device' (NCCL) moves CUDA tensors; "
                         "on the CPU use --p2p host (gloo)")
    have = torch.cuda.device_count()
    if have < world_size:
        raise ValueError(
            f"p2p transport 'device' (NCCL) needs one card a rank: {world_size} "
            f"ranks, {have} card(s); NCCL refuses two ranks on one card, so "
            f"use --p2p host (gloo, staged through host memory)")


def rank_device(device: torch.device, local_rank: int, transport: str) -> torch.device:
    """The device of the rank that is ``local_rank`` on its machine: the
    CPU, its own card (``device``), or the cards taken in turn (``host``,
    where ranks may share a card)."""
    if device.type == "cpu":
        return device
    n = torch.cuda.device_count()
    return torch.device("cuda", local_rank if transport == "device" else local_rank % n)


class P2P:
    """Collectives of one rank over ``group`` (the default group when
    None).  Peers are named by their rank in the group; the exchange
    maps them to the global ranks ``torch.distributed`` addresses.
    ``bytes_sent``, ``seconds`` (wall time, waiting for the peer
    included) and ``copy_seconds`` (the host staging copies in it) add up
    over every :meth:`ppermute` and :meth:`send_recv`;
    ``reduce_seconds``, ``scatter_seconds`` and ``gather_seconds`` over
    every :meth:`all_reduce_`, :meth:`reduce_scatter_` and
    :meth:`all_gather_`, and ``gather_bytes`` (the other members' parts
    that arrive) over every :meth:`all_gather_`.  On the card each
    collective synchronizes the device before and after, so its time is
    its own.

    On the ``host`` transport (gloo) a bf16 or fp16 tensor is summed
    through an fp32 host buffer and rounded back, a reduce-scatter is an
    all-reduce of the whole tensor of which the rank keeps its slice (the
    same sums as :meth:`all_reduce_`), and an all-gather moves the
    tensor's bytes; on ``device`` (NCCL) each collective runs in the
    tensor's dtype on the card."""

    def __init__(self, transport: str, device: torch.device, group=None):
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown p2p transport {transport!r}")
        self.transport = transport
        self.device = torch.device(device)
        self.group = group
        self.rank = dist.get_rank(group)
        self.world_size = dist.get_world_size(group)
        # a point-to-point peer is named to torch by its GLOBAL rank
        self.global_ranks = [r if group is None else dist.get_global_rank(group, r)
                             for r in range(self.world_size)]
        self.staged = transport == "host" and self.device.type == "cuda"
        self._zeros: Dict[Tuple, torch.Tensor] = {}
        self.reset_counts()

    def reset_counts(self) -> None:
        self.bytes_sent, self.seconds, self.copy_seconds = 0, 0.0, 0.0
        self.reduce_seconds = self.scatter_seconds = self.gather_seconds = 0.0
        self.gather_bytes = 0

    def _wire_zeros(self, like: torch.Tensor) -> torch.Tensor:
        """A cached zero tensor shaped like ``like`` where it goes on the
        wire (pinned host memory when staged)."""
        key = (tuple(like.shape), like.dtype)
        if key not in self._zeros:
            if self.staged:
                z = torch.zeros(like.shape, dtype=like.dtype, pin_memory=True)
            else:
                z = torch.zeros(like.shape, dtype=like.dtype, device=self.device)
            self._zeros[key] = z
        return self._zeros[key]

    def _wire(self, x: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
        if x is None:
            return self._wire_zeros(like)
        x = x.detach().contiguous()
        if self.staged:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            return host
        return x

    def _empty(self, like: torch.Tensor) -> torch.Tensor:
        if self.staged:
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(like.shape, dtype=like.dtype, device=self.device)

    def ppermute(self, items: Sequence[Tuple[Optional[torch.Tensor], Perm]],
                 like: torch.Tensor) -> List[torch.Tensor]:
        """One exchange for each ``(x, perm)``: this rank sends ``x`` to
        ``dst`` for every ``(rank, dst)`` in ``perm`` (zeros where ``x``
        is None) and receives from ``src`` for the ``(src, rank)`` in
        ``perm``; what it receives comes back on this rank's device, in a
        new tensor, or zeros where no pair sends to this rank.  Every
        tensor is shaped like ``like``; ranks are group ranks.  All sends
        and receives of one call go in one ``batch_isend_irecv``, so a
        send and a receive of one tick cannot deadlock; the perms' order
        is the tag order, the same on every rank."""
        if self.device.type == "cuda":
            # wait for this rank's queued work (the staging copy would wait
            # for it), so the exchange's time is the exchange's
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        ops, outs, recvs = [], [], []
        for tag, (x, perm) in enumerate(items):
            recv_buf = None
            for src, dst in perm:
                if src == self.rank and dst == self.rank:
                    recv_buf = ("local", x)
                elif src == self.rank:
                    buf = self._wire(x, like)
                    ops.append(dist.P2POp(dist.isend, buf, self.global_ranks[dst],
                                          self.group, tag))
                    self.bytes_sent += buf.numel() * buf.element_size()
                elif dst == self.rank:
                    buf = self._empty(like)
                    ops.append(dist.P2POp(dist.irecv, buf, self.global_ranks[src],
                                          self.group, tag))
                    recv_buf = ("wire", buf)
            recvs.append(recv_buf)
        t1 = time.perf_counter()
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            if self.device.type == "cuda" and not self.staged:
                # NCCL's wait only orders the stream: wait for the transfer
                torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        for r in recvs:
            if r is None:
                outs.append(torch.zeros(like.shape, dtype=like.dtype, device=self.device))
            elif r[0] == "local":
                x = r[1]
                outs.append(torch.zeros(like.shape, dtype=like.dtype, device=self.device)
                            if x is None else x.detach().clone())
            else:
                outs.append(r[1].to(self.device) if self.staged else r[1])
        t3 = time.perf_counter()
        self.seconds += t3 - t0
        if self.staged:
            self.copy_seconds += (t1 - t0) + (t3 - t2)
        return outs

    def send_recv(self, sends: Sequence[Tuple[Optional[torch.Tensor], int, torch.Tensor]],
                  recvs: Sequence[Tuple[int, torch.Tensor]]) -> List[torch.Tensor]:
        """One batch of point-to-point messages: each ``(x, peer, like)``
        of ``sends`` goes to ``peer`` (zeros shaped like ``like`` where
        ``x`` is None), and each ``(peer, like)`` of ``recvs`` comes from
        ``peer`` into a new tensor shaped like ``like``; returns those in
        ``recvs``' order, on this rank's device.  Peers are group ranks,
        at most one message a peer each way.  Counted as
        :meth:`ppermute` counts."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        ops, bufs = [], []
        for x, peer, like in sends:
            buf = self._wire(x, like)
            ops.append(dist.P2POp(dist.isend, buf, self.global_ranks[peer], self.group))
            self.bytes_sent += buf.numel() * buf.element_size()
        for peer, like in recvs:
            bufs.append(self._empty(like))
            ops.append(dist.P2POp(dist.irecv, bufs[-1], self.global_ranks[peer], self.group))
        t1 = time.perf_counter()
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            if self.device.type == "cuda" and not self.staged:
                torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        outs = [b.to(self.device) for b in bufs] if self.staged else bufs
        t3 = time.perf_counter()
        self.seconds += t3 - t0
        if self.staged:
            self.copy_seconds += (t1 - t0) + (t3 - t2)
        return outs

    def _start(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _since(self, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _host_buffer(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as gloo sums it: on the CPU, fp32 for a narrow float (the
        same storage where ``t`` is already such a tensor)."""
        return t.detach().to("cpu", torch.float32 if t.dtype in NARROW else t.dtype)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group in place."""
        t0 = self._start()
        if self.transport == "host":
            buf = self._host_buffer(t)
            dist.all_reduce(buf, group=self.group)
            if buf.data_ptr() != t.data_ptr():
                t.copy_(buf)
        else:
            dist.all_reduce(t, group=self.group)
        self.reduce_seconds += self._since(t0)
        return t

    def reduce_scatter_(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum of ``t`` over the group, cut into ``world_size`` equal
        slices along ``dim``: this rank's slice, a new tensor (``t`` is
        left as it was)."""
        n = self.world_size
        t0 = self._start()
        if self.transport == "host":
            buf = self._host_buffer(t)
            if buf.data_ptr() == t.data_ptr():
                buf = buf.clone()
            dist.all_reduce(buf, group=self.group)
            out = buf.chunk(n, dim)[self.rank].to(self.device, t.dtype).contiguous()
        else:
            x = t.detach().movedim(dim, 0).contiguous()
            part = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                               device=x.device)
            dist.reduce_scatter_tensor(part, x, group=self.group)
            out = part.movedim(0, dim).contiguous()
        self.scatter_seconds += self._since(t0)
        return out

    def all_gather_(self, out: torch.Tensor, part: torch.Tensor, dim: int) -> torch.Tensor:
        """Fill ``out`` with every rank's ``part`` laid end to end along
        ``dim`` in group-rank order (in place; returns ``out``)."""
        t0 = self._start()
        self.gather_bytes += (self.world_size - 1) * part.numel() * part.element_size()
        if self.transport == "host":
            # a gather sums nothing: it moves the bytes as they are
            buf = part.detach().to("cpu").contiguous()
            parts = [torch.empty_like(buf.view(torch.uint8))
                     for _ in range(self.world_size)]
            dist.all_gather(parts, buf.view(torch.uint8), group=self.group)
            out.copy_(torch.cat([p.view(buf.dtype) for p in parts], dim))
        else:
            x = part.detach().movedim(dim, 0).contiguous()
            full = torch.empty((x.shape[0] * self.world_size, *x.shape[1:]),
                               dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(full, x, group=self.group)
            out.copy_(full.movedim(0, dim))
        self.gather_seconds += self._since(t0)
        return out


@dataclasses.dataclass
class Grid:
    """One rank's place on a (dp, pipe, tp) grid of D·S·T ranks, in the
    JAX package's mesh order ``rank = (d·S + s)·T + k``, and its groups,
    each a :class:`P2P` with counters of its own:

    * ``pipe``: same (d, k), all s: the stage hop (member k of stage s
      talks to member k of stage s ± 1);
    * ``tp``: same (d, s), all k: the Megatron all-reduces (None at T 1);
    * ``dp``: same (s, k), all d: the gradient sync (None at D 1);
    * ``rep``: same k, all (d, s): pipe ∪ dp, where the loss, the token
      count and the replicated leaves' gradients are summed;
    * ``world``: every rank: the clip norm.

    Build it with :meth:`build`, on every rank of the job in the same
    order (``new_group`` is collective).  :meth:`grouped` builds the
    grouped runtime's layout instead, where stages differ in tp."""
    D: int
    S: int
    T: int                   # this rank's stage's tp degree
    d: int
    s: int
    k: int
    pipe: Optional[P2P]      # None on a grouped layout (``boundary`` hops)
    tp: Optional[P2P]
    dp: Optional[P2P]
    rep: P2P
    world: P2P
    boundary: Optional[P2P] = None
    stage_tp: Tuple[int, ...] = ()

    @staticmethod
    def rank_of(d: int, s: int, k: int, S: int, T: int) -> int:
        return (d * S + s) * T + k

    @classmethod
    def build(cls, transport: str, device: torch.device, *, dp: int = 1,
              pipe: int = 1, tp: int = 1) -> "Grid":
        world = dist.get_world_size()
        if world != dp * pipe * tp:
            raise ValueError(f"a (dp {dp}, pipe {pipe}, tp {tp}) grid needs "
                             f"{dp * pipe * tp} ranks; the job has {world}")
        me = dist.get_rank()
        d, rest = divmod(me, pipe * tp)
        s, k = divmod(rest, tp)
        at = lambda d, s, k: cls.rank_of(d, s, k, pipe, tp)

        def family(groups):
            # every rank creates every group of the family, in one order
            mine = None
            for ranks in groups:
                g = None if len(ranks) == world else dist.new_group(ranks)
                if me in ranks:
                    mine = P2P(transport, device, g)
            return mine

        return cls(
            dp, pipe, tp, d, s, k,
            pipe=family([[at(a, i, c) for i in range(pipe)]
                         for a in range(dp) for c in range(tp)]),
            tp=family([[at(a, i, c) for c in range(tp)]
                       for a in range(dp) for i in range(pipe)]) if tp > 1 else None,
            dp=family([[at(a, i, c) for a in range(dp)]
                       for i in range(pipe) for c in range(tp)]) if dp > 1 else None,
            rep=family([[at(a, i, c) for a in range(dp) for i in range(pipe)]
                        for c in range(tp)]),
            world=P2P(transport, device))

    @classmethod
    def grouped(cls, transport: str, device: torch.device,
                stage_tp: Sequence[int]) -> "Grid":
        """The grouped runtime's flat layout of N = Σ ``stage_tp`` ranks:
        stage s owns ranks ``offset[s]`` … ``offset[s] + stage_tp[s] - 1``
        (the copied ``tickprogram.group_layout`` order), member k its k-th.
        Its groups: ``tp``, this rank's stage (None at tp 1; every stage's
        group is created on every rank, in stage order, so groups of
        unequal size are collective as ``new_group`` wants);
        ``boundary``, the stage-boundary hops (point-to-point over the
        world group, peers named by global rank: a hop crosses two
        groups); ``rep``, the world, where one member a stage adds the
        loss, the token count and the replicated leaves' gradients
        (:meth:`stage_sum_`); ``world``, the clip norm.  dp is 1."""
        stage_tp = tuple(int(t) for t in stage_tp)
        world = dist.get_world_size()
        if world != sum(stage_tp):
            raise ValueError(f"a grouped layout of stage_tp {stage_tp} needs "
                             f"{sum(stage_tp)} ranks; the job has {world}")
        me = dist.get_rank()
        tp = None
        for i, t in enumerate(stage_tp):
            first = sum(stage_tp[:i])
            if first <= me < first + t:
                s, k = i, me - first
            if t > 1:
                g = None if t == world else dist.new_group(list(range(first, first + t)))
                if first <= me < first + t:
                    tp = P2P(transport, device, g)
        return cls(1, len(stage_tp), stage_tp[s], 0, s, k, pipe=None, tp=tp, dp=None,
                   rep=P2P(transport, device), world=P2P(transport, device),
                   boundary=P2P(transport, device), stage_tp=stage_tp)

    def stage_ranks(self, s: int) -> Tuple[int, ...]:
        """The global ranks of stage ``s``'s tp members on a grouped
        layout, in member order."""
        first = sum(self.stage_tp[:s])
        return tuple(range(first, first + self.stage_tp[s]))

    def stage_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the stages and replicas, in place, of a value that
        every tp member of a stage holds alike, each (replica, stage)
        counted once: over ``rep`` (same k) on a (dp, pipe, tp) grid; on
        a grouped layout, where stages have different member counts, over
        the world with member 0 of each stage alone contributing."""
        if self.stage_tp and self.k:
            t.zero_()
        return self.rep.all_reduce_(t)

    def counts(self) -> Dict[str, float]:
        """The counters a step reads, by group: the hops' bytes, wall and
        staging copies (pipe); on a grouped layout the boundary hops'
        (their bytes cross the stage boundary) and the all-gathers that
        rebuild an ``sr_ag`` hop's activation in the destination stage
        (bytes brought in, wall); the all-reduces of the loss, the token
        count and the replicated leaves' gradients (rep); the tp
        all-reduces; the dp sync (all-reduce, reduce-scatter,
        all-gather); the clip norm's all-reduce (world)."""
        z = lambda p, f: getattr(p, f) if p is not None else 0.0
        gather = self.tp if self.stage_tp else None
        return {"p2p_bytes": z(self.pipe, "bytes_sent"), "p2p_s": z(self.pipe, "seconds"),
                "p2p_copy_s": z(self.pipe, "copy_seconds"),
                "boundary_bytes": z(self.boundary, "bytes_sent"),
                "boundary_s": z(self.boundary, "seconds"),
                "boundary_copy_s": z(self.boundary, "copy_seconds"),
                "boundary_gather_bytes": z(gather, "gather_bytes"),
                "boundary_gather_s": z(gather, "gather_seconds"),
                "reduce_s": self.rep.reduce_seconds,
                "tp_s": z(self.tp, "reduce_seconds"),
                "dp_s": z(self.dp, "reduce_seconds"),
                "dp_scatter_s": z(self.dp, "scatter_seconds"),
                "dp_gather_s": z(self.dp, "gather_seconds"),
                "norm_s": self.world.reduce_seconds}
