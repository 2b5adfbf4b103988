"""Pluggable pipeline-schedule subsystem (DESIGN.md §3–§7, §10).

One :class:`Schedule` abstraction — per-stage F/B/D/W op lists plus a
chunk placement for virtual-stage schedules — drives: the generic
event-driven :func:`simulate` (including the per-bucket grad-sync
overlap events of §10), the cost model's α coefficient, memory
profile and exposed-sync term (``repro_torch.core.cost_model``), HeteroAuto's
schedule search dimension, and the SPMD runtime's tick→(microbatch,
chunk, route) program (``repro.core.heteropp.spmd_tick_tables``).
Shipped: gpipe, 1f1b, interleaved (chunk-major virtual stages), zb_h1,
zb_v (V placement, backward split), wave (W placement, v=4) — all with
closed-form α AND inflight, all executable on the real shard_map
pipeline.

A copy of the JAX package's ``core/schedules/__init__.py``,
held equal to it by ``tests/test_torch_planning.py``.
"""
from .base import (Op, Schedule, ScheduleLike, available_schedules,
                   get_schedule, register)
from .library import GPipe, Interleaved1F1B, OneFOneB, Wave, ZBH1, ZBV
from .simulator import OpSpan, SimResult, SyncEvent, simulate

__all__ = [
    "Op", "Schedule", "ScheduleLike", "available_schedules", "get_schedule",
    "register", "GPipe", "Interleaved1F1B", "OneFOneB", "Wave", "ZBH1",
    "ZBV", "OpSpan", "SimResult", "SyncEvent", "simulate",
]
