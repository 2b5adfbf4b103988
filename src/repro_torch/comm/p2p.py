"""The one-hop exchange between pipeline stages: the port's counterpart of
``jax.lax.ppermute`` in the JAX package's HeteroPP runtime (its DiComm
device-direct hop), over a ``torch.distributed`` process group with one
rank a stage.

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
copies, so a run can report them a tick.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TRANSPORTS = ("device", "host")
BACKENDS = {"device": "nccl", "host": "gloo"}

Perm = Sequence[Tuple[int, int]]


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
    """Point-to-point exchanges of one rank over ``group`` (the default
    group when None).  ``bytes_sent``, ``seconds`` (wall time, waiting for
    the peer included) and ``copy_seconds`` (the host staging copies in
    it) add up over every :meth:`ppermute`; ``reduce_seconds`` over every
    :meth:`all_reduce_`."""

    def __init__(self, transport: str, device: torch.device, group=None):
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown p2p transport {transport!r}")
        self.transport = transport
        self.device = torch.device(device)
        self.group = group
        self.rank = dist.get_rank(group)
        self.world_size = dist.get_world_size(group)
        self.staged = transport == "host" and self.device.type == "cuda"
        self.bytes_sent = 0
        self.seconds = 0.0
        self.copy_seconds = 0.0
        self.reduce_seconds = 0.0
        self._zeros: Dict[Tuple, torch.Tensor] = {}

    def reset_counts(self) -> None:
        self.bytes_sent, self.seconds, self.copy_seconds = 0, 0.0, 0.0
        self.reduce_seconds = 0.0

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
        tensor is shaped like ``like``.  All sends and receives of one
        call go in one ``batch_isend_irecv``, so a send and a receive of
        one tick cannot deadlock; the perms' order is the tag order, the
        same on every rank."""
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
                    ops.append(dist.P2POp(dist.isend, buf, dst, self.group, tag))
                    self.bytes_sent += buf.numel() * buf.element_size()
                elif dst == self.rank:
                    buf = self._empty(like)
                    ops.append(dist.P2POp(dist.irecv, buf, src, self.group, tag))
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

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group in place (fp32 or wider; staged
        through host memory on the ``host`` transport)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        if self.staged:
            host = t.detach().cpu()
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.reduce_seconds += time.perf_counter() - t0
        return t
