"""The static plan verifier driver (DESIGN.md §15).

``analyze_plan`` runs every pass against a ParallelPlan (object or the
``--plan`` JSON dict) and returns the diagnostic list; ``verify_plan``
is the gate form — cfg-free, raising :class:`PlanVerificationError`
(a ``ValueError``, so existing refusal handlers keep working) when any
error-severity diagnostic survives.

Two depths:

* **cfg-free** (what ``heteropp.from_plan`` runs on every load): plan
  shape, schedule safety on the executed (S, b) points, collective
  divergence across the batch domain, grouped-layout consistency,
  grad-sync config.  Needs nothing but the plan — importable and
  runnable without jax.
* **cfg-full** (what ``launch/train.py`` and the lint CLI run): adds
  the resource-bound pass (per-stage peak memory vs chip HBM) and the
  kernel-precondition lint, which need the model config and sequence
  length.

A copy of the JAX package's ``analysis/plan_verifier.py``,
held equal to it by ``tests/test_torch_planning.py``.
"""
from __future__ import annotations

from typing import List, Optional

from ..core import cost_model as CM
from ..core.schedules import get_schedule
from ..core.tickprogram import chunk_layer_counts

from .collectives import check_domain_divergence, check_grouped_program
from .diagnostics import Diagnostic, error, format_report, split
from .kernel_lint import check_kernels
from .resources import check_resources
from .schedule_safety import verify_schedule_cached


class PlanVerificationError(ValueError):
    """Raised by :func:`verify_plan` when a plan fails the static
    verifier.  Subclasses ``ValueError`` so the existing plan-refusal
    handlers (``launch/train.py``, ``heteroauto.runtime_path``)
    classify it as a refusal without changes."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = diagnostics
        errs, _ = split(diagnostics)
        codes = sorted({d.code for d in errs})
        super().__init__(
            f"plan fails static verification ({', '.join(codes)}):\n"
            + format_report(errs))


def _coerce(plan):
    if isinstance(plan, CM.ParallelPlan):
        return plan, []
    try:
        return CM.ParallelPlan.from_dict(dict(plan)), []
    except (KeyError, ValueError, TypeError) as e:
        return None, [error("H2E101", f"plan does not parse: {e}")]


def _expand_stages(plan):
    """Per-pipeline-stage (tp, layers) — the from_plan expansion."""
    per_tp, phys = [], []
    for s in plan.stages:
        per_tp.extend([s.tp] * s.pp)
        per, left = s.layers_per_stage, s.layers
        for _ in range(s.pp):
            take = min(per, left)
            phys.append(take)
            left -= take
    return per_tp, phys


def _check_grad_sync(plan) -> List[Diagnostic]:
    from ..comm.latency import TRANSPORTS
    from ..core.dataparallel.grad_sync import GRAD_SYNC_MODES
    diags: List[Diagnostic] = []
    if plan.dp_sync not in GRAD_SYNC_MODES:
        diags.append(error(
            "H2E101", f"dp_sync {plan.dp_sync!r} not in "
            f"{GRAD_SYNC_MODES}", where="grad sync"))
    if plan.dp_transport not in TRANSPORTS:
        diags.append(error(
            "H2E101", f"dp_transport {plan.dp_transport!r} not in "
            f"{sorted(TRANSPORTS)}", where="grad sync"))
    if plan.dp > 1 and plan.dp_sync == "psum" and plan.bucket_bytes < 1:
        diags.append(error(
            "H2E101", f"bucket_bytes={plan.bucket_bytes} but the psum "
            "sync program drains positive-size buckets", where="grad sync"))
    return diags


def analyze_plan(plan, cfg=None, *, seq_len: Optional[int] = None,
                 gbs_tokens: Optional[float] = None,
                 page_size: Optional[int] = None,
                 microbatches: Optional[int] = None,
                 execute_tp: bool = True, execute_dp: bool = True
                 ) -> List[Diagnostic]:
    """Run every applicable pass; returns diagnostics (never raises on
    a bad plan — parse/shape failures become H2E101 entries).

    ``execute_tp`` / ``execute_dp`` mirror ``heteropp.from_plan``: with
    a flag off, that dimension stays a cost-model artifact and its
    runtime checks are skipped (legacy callers execute the layer split
    alone, so a grouped-inexpressible plan must not be refused then).
    """
    plan, diags = _coerce(plan)
    if plan is None:
        return diags
    try:
        sched = get_schedule(plan.schedule)
    except KeyError as e:
        return diags + [error("H2E101", str(e))]

    total_pp = sum(s.pp for s in plan.stages)
    b = microbatches or plan.microbatches
    domain = tuple(plan.batch_domain or ()) if execute_dp else ()
    if domain and len(set(domain)) > 1 and microbatches is not None \
            and microbatches != max(domain):
        diags.append(error(
            "H2E101", f"microbatches={microbatches} override conflicts "
            f"with the plan's non-uniform batch domain {list(domain)}: "
            "the override cannot rescale a per-replica split "
            "(DESIGN.md §13)"))
        domain = ()

    # schedule / tick-program safety at the pacing point
    diags += verify_schedule_cached(sched, total_pp, b)
    diags += _check_grad_sync(plan)

    per_tp, phys = _expand_stages(plan)
    max_layers = max(chunk_layer_counts(phys, sched)) if phys else 1
    uniform_tp = len(set(per_tp)) <= 1
    tp = per_tp[0] if uniform_tp and per_tp else 1

    grouped = execute_tp and not uniform_tp
    if grouped:
        tps = sorted(set(per_tp))
        if sched.n_chunks > 1:
            diags.append(error(
                "H2E101", f"non-uniform per-stage tp {tps} under the "
                f"chunked {plan.schedule!r} schedule — the grouped "
                "stage runtime streams single-chunk schedules only "
                "(DESIGN.md §12)"))
        elif execute_dp and plan.dp > 1:
            diags.append(error(
                "H2E101", f"non-uniform per-stage tp {tps} AND "
                f"dp={plan.dp} — dp replicas of grouped pipelines stay "
                "a cost-model dimension (DESIGN.md §12)"))
        else:
            from ..core import resharding as RS
            chips = []
            for s in plan.stages:
                chips.extend([s.group.spec] * s.pp)
            reshard = tuple(
                "none" if per_tp[i] == per_tp[i + 1] else
                RS.choose_strategy(per_tp[i], per_tp[i + 1],
                                   nic_bw=chips[i].nic_bw,
                                   intra_bw=chips[i + 1].intra_node_bw)
                for i in range(len(per_tp) - 1))
            d_model = cfg.d_model if cfg is not None \
                else 128 * max(per_tp)
            diags += check_grouped_program(
                sched, per_tp, reshard, d_model, microbatches=b,
                max_layers=max_layers, where="grouped runtime")
    elif domain and len(set(domain)) > 1:
        diags += check_domain_divergence(
            sched, total_pp, domain,
            tp=tp if execute_tp else 1, max_layers=max_layers,
            dp_sync=plan.dp_sync if plan.dp > 1 else None,
            where=f"batch domain {list(domain)}")

    if cfg is not None:
        seq = seq_len if seq_len is not None else 4096
        diags += check_resources(plan, cfg, seq, gbs_tokens)
        exec_tps = per_tp if execute_tp else ()
        diags += check_kernels(cfg, tps=exec_tps, seq_len=seq,
                               page_size=page_size)
    return diags


def verify_plan(plan, *, microbatches: Optional[int] = None,
                execute_tp: bool = True, execute_dp: bool = True
                ) -> List[Diagnostic]:
    """Cfg-free gate: raise :class:`PlanVerificationError` on errors,
    return the (warning-only) diagnostics otherwise."""
    diags = analyze_plan(plan, microbatches=microbatches,
                         execute_tp=execute_tp, execute_dp=execute_dp)
    errs, _ = split(diags)
    if errs:
        raise PlanVerificationError(diags)
    return diags
