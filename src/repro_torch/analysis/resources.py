"""Resource-bound pass (H2E401 / H2W401): per-stage peak memory vs the
chip HBM cap, priced by the SAME model the gate protects — the cost
model's weights + grads + optimizer + schedule-inflight activation
formula (``cost_model.evaluate``, paper Observation #4).  A plan this
pass refuses would OOM on step one; a plan it warns about sits within
10% of the safety-margined cap and will not survive much drift between
the analytic activation model and the real allocator.

A copy of the JAX package's ``analysis/resources.py``,
held equal to it by ``tests/test_torch_planning.py``.
"""
from __future__ import annotations

from typing import List, Optional

from ..core import cost_model as CM
from ..models.config import ModelConfig

from .diagnostics import Diagnostic, error, warning

NEAR_CAP = 0.90


def check_resources(plan: CM.ParallelPlan, cfg: ModelConfig,
                    seq_len: int, gbs_tokens: Optional[float] = None
                    ) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    if gbs_tokens is None:
        gbs_tokens = float(plan.dp * plan.microbatches * seq_len)
    try:
        cost = CM.evaluate(plan, cfg, seq_len, gbs_tokens)
    except (ValueError, KeyError) as e:
        return [error("H2E101", f"cost model rejects the plan: {e}")]
    for s, (mem, cap) in enumerate(zip(cost.stage_mem_gb,
                                       cost.stage_cap_gb)):
        eff = cap * CM.MEM_SAFETY
        where = f"stage group {s} ({plan.stages[s].group.name})"
        if mem > eff:
            diags.append(error(
                "H2E401", f"peak memory {mem:.1f} GiB exceeds the "
                f"{cap:.1f} GiB chip's safety-margined cap "
                f"{eff:.1f} GiB (margin {CM.MEM_SAFETY:.0%}) — "
                "enable recompute, raise tp/pp, or move layers off "
                "this stage", where=where))
        elif mem > NEAR_CAP * eff:
            diags.append(warning(
                "H2W401", f"peak memory {mem:.1f} GiB is within 10% of "
                f"the safety-margined cap {eff:.1f} GiB", where=where))
    return diags
