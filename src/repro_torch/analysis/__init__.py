"""Static plan verification (DESIGN.md §15) — a jax-free load-time
gate over ParallelPlans.

``analyze_plan(plan, cfg, ...)`` runs every pass and returns typed
diagnostics (``H2Exxx`` errors / ``H2Wxxx`` warnings);
``verify_plan(plan)`` is the cfg-free gate ``heteropp.from_plan`` calls
on every load, raising :class:`PlanVerificationError` on errors.
The JAX package's CLI (``analysis/lint.py``) is not copied yet.

A copy of the JAX package's ``analysis/__init__.py`` (without the CLI),
held equal to it by ``tests/test_torch_planning.py``.
"""
from .collectives import (check_convergence, check_domain_divergence,
                          check_group_tables, check_grouped_program,
                          grouped_collective_trace,
                          replica_collective_trace)
from .diagnostics import (CODES, Diagnostic, error, format_report, split,
                          warning)
from .kernel_lint import check_attention, check_kernels, check_tp
from .plan_verifier import PlanVerificationError, analyze_plan, verify_plan
from .resources import check_resources
from .schedule_safety import (check_alpha, check_causal_replay,
                              check_coverage, check_inflight,
                              check_pad_inertness, check_placement,
                              check_streamable, verify_schedule,
                              verify_schedule_cached)

__all__ = [
    "CODES", "Diagnostic", "PlanVerificationError", "analyze_plan",
    "check_alpha", "check_attention", "check_causal_replay",
    "check_convergence", "check_coverage", "check_domain_divergence",
    "check_group_tables", "check_grouped_program", "check_inflight",
    "check_kernels", "check_pad_inertness", "check_placement",
    "check_resources", "check_streamable", "check_tp", "error",
    "format_report", "grouped_collective_trace",
    "replica_collective_trace", "split", "verify_plan",
    "verify_schedule", "verify_schedule_cached", "warning",
]
