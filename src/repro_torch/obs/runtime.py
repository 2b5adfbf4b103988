"""The executed-trace tracer of the HeteroPP pipeline (DESIGN.md §14) and
the device-side run statistics of the launchers: the port's
counterpart of ``repro/obs/runtime.py``.

The JAX package's train step scans the whole tick program inside one
``shard_map`` call, so its tracer re-drives the tick body one fenced host
call a tick.  The port's pipeline is a host loop already
(``core.heteropp.make_pipeline_loss``): the tracer hands that loop a
fenced clock (``torch.cuda.synchronize`` then ``time.perf_counter`` on
the card, ``perf_counter`` alone on the CPU), and the loop stamps each
tick's compute and exchange, forward and backward.  The traced pass is
the very tick loop a train step runs, not a second copy of it.

Fencing every tick serializes what the loop would otherwise overlap
(the card's queue and the host-staged exchange), so the traced wall
time is a fenced measurement beside the step time, not the step time.

Opt-in only (``train.py --trace``): the launcher imports this module's
tracer only when asked, and an untraced step pays two ``is None`` tests
a tick and a third on an emitting tick.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from .trace import SOURCE_EXECUTED, build_trace

__all__ = ["trace_pipeline", "fenced_clock", "device_memory_highwater"]


def device_memory_highwater(device=None) -> Optional[int]:
    """Peak bytes allocated by PyTorch on the card since the last
    ``torch.cuda.reset_peak_memory_stats``, or None on the CPU, which
    keeps no such count."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.max_memory_allocated(dev))


def fenced_clock(device) -> Callable[[], float]:
    """``time.perf_counter`` after everything queued on ``device`` has
    run (the JAX tracer's ``block_until_ready`` fence); on the CPU,
    where work is done when the call returns, ``perf_counter`` alone."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return time.perf_counter

    def clock() -> float:
        torch.cuda.synchronize(dev)
        return time.perf_counter()

    return clock


def trace_pipeline(cfg, spec, grid, params, tokens, *,
                   backend: str = "auto") -> Optional[dict]:
    """Run this rank's pipeline loss once, forward and backward, on
    ``params`` (its ``local_stage_params`` tree, leaves requiring grad)
    and ``tokens`` (the train step's layout), with the tick loop stamped
    by :func:`fenced_clock`; no optimizer update, no dp sync.  Every rank
    of ``grid`` calls it.  One warm-up pass runs first; all ranks meet in
    a barrier before the timed one.

    Every rank's stamps are gathered on world rank 0 (``gather_object``;
    on NCCL the current device is set first) and taken relative to the
    earliest start over the ranks: ``perf_counter`` is
    ``CLOCK_MONOTONIC``, which the processes of one host share.  Ranks on
    different hosts are out of scope: their clocks share no origin.

    Returns, on world rank 0, the executed-timeline trace (``obs.trace``
    schema, ``source="executed"``); None on the other ranks.  For each
    (replica d, stage s), tp member 0's stamps give an ``F`` span per
    active forward tick (its compute: the stage forward and an emitting
    tick's CE) and a ``B`` span per active backward tick (its
    ``autograd.grad``), each with ``replica``, ``stage``, ``chunk``,
    ``mb``, ``g`` and the forward ``tick``.  The JAX package's trace has
    ``F`` only: its scan hides the backward.  ``metadata`` holds
    ``ticks`` (the pacing replica's: a short replica of an uneven domain
    stops early), ``wall_s``, the traced ``loss``, and by world rank
    ``grid`` ([d, s, k]), ``tick_times_s`` (each forward tick's wall,
    its exchange included), ``exchange_s`` (each tick's hop and wait,
    ``forward`` and ``backward``, in tick order), ``rank_wall_s``,
    ``launches`` (the timed pass's kernel launches) and
    ``peak_bytes_in_use``; and ``denom_check``: ``measured``, the masked
    target tokens that the emitting ticks' CE consumed, counted in the
    loop and summed over the stages and replicas (tp member 0 of each),
    and ``loss_denom``, the denominator the loss divided by, each against
    the closed form Σ allocations × mb_size × (seq − 1) (``expected``).
    A mismatch raises ``RuntimeError``: the traced loop did not stream
    every microbatch through the program once."""
    import torch.distributed as dist

    from ..core import heteropp as HP
    from ..core.schedules import get_schedule
    from ..kernels import ops

    dev = tokens.device
    if grid.world.transport == "device":
        torch.cuda.set_device(dev)
    loss_fn = HP.make_pipeline_loss(cfg, spec, grid, backend=backend,
                                    clock=fenced_clock(dev))
    loss_fn(params, tokens)                       # warm-up
    dist.barrier()
    before = {fn.__name__: fn.launches for fn in ops.KERNELS}
    loss, _ = loss_fn(params, tokens)
    st = loss_fn.stats
    mine = {"grid": [grid.d, grid.s, grid.k], "stamps": st["tick_stamps"],
            "ce_tokens": st["ce_tokens"], "denom": st["denom"],
            "launches": {fn.__name__: fn.launches - before[fn.__name__]
                         for fn in ops.KERNELS},
            "peak_bytes_in_use": device_memory_highwater(dev)}
    rank = dist.get_rank()
    got = [None] * dist.get_world_size() if rank == 0 else None
    dist.gather_object(mine, got, dst=0)
    if rank != 0:
        return None
    return _executed_trace(spec, get_schedule(spec.schedule), got, float(loss),
                           tuple(tokens.shape))


def _executed_trace(spec, sched, ranks, loss: float, token_shape) -> dict:
    """The trace of :func:`trace_pipeline` from every rank's gathered
    stamps (rank order)."""
    S = spec.num_stages
    origin = min(r["stamps"]["forward"][0][5] for r in ranks)
    spans, measured = [], 0.0
    for r in ranks:
        d, s, k = r["grid"]
        if k != 0:
            continue
        measured += r["ce_tokens"]
        fwd = {}
        for t, active, mb, ck, _, start, computed, _ in r["stamps"]["forward"]:
            if not active:
                continue
            fwd[t] = (mb, ck)
            spans.append(_span("F", d, s, ck, mb, sched.global_stage(s, ck, S), t,
                               start - origin, computed - origin))
        for t, active, start, computed, _ in r["stamps"]["backward"]:
            if active:
                mb, ck = fwd[t]
                spans.append(_span("B", d, s, ck, mb, sched.global_stage(s, ck, S), t,
                                   start - origin, computed - origin))
    _, mb_size, seq = token_shape
    expected = float(sum(spec.batch_allocations) * mb_size * (seq - 1))
    loss_denom = ranks[0]["denom"]
    if measured != expected or loss_denom != expected:
        raise RuntimeError(
            f"traced denominator: the CE consumed {measured} tokens and the "
            f"loss divided by {loss_denom}, expected {expected}: the traced "
            f"tick loop did not stream every microbatch through the program "
            f"once")
    ticks = max(len(r["stamps"]["forward"]) for r in ranks)
    by_tick = lambda rows: [e - c for *_, c, e in sorted(rows)]
    last = lambda r: r["stamps"]["backward"][-1][-1]
    meta = {
        "wall_s": max(last(r) for r in ranks) - origin,
        "loss": loss,
        "denom_check": {"measured": measured, "loss_denom": loss_denom,
                        "expected": expected},
        "grid": [r["grid"] for r in ranks],
        "tick_times_s": [[e - st for *_, st, _, e in r["stamps"]["forward"]]
                         for r in ranks],
        "exchange_s": [{"forward": by_tick(r["stamps"]["forward"]),
                        "backward": by_tick(r["stamps"]["backward"])} for r in ranks],
        "rank_wall_s": [last(r) - r["stamps"]["forward"][0][5] for r in ranks],
        "launches": [r["launches"] for r in ranks],
        "peak_bytes_in_use": [r["peak_bytes_in_use"] for r in ranks],
    }
    return build_trace(spans, source=SOURCE_EXECUTED, schedule=sched.name,
                       num_stages=S, n_chunks=spec.n_chunks, dp=spec.data_parallel,
                       ticks=ticks, extra_meta=meta)


def _span(kind, replica, stage, chunk, mb, g, tick, start_s, end_s) -> dict:
    return {"replica": replica, "stage": stage, "chunk": chunk, "kind": kind,
            "mb": mb, "g": g, "start_s": start_s, "end_s": end_s, "tick": tick}
