"""CLI for the static plan verifier: ``python -m repro_torch.analysis.lint
plan.json [...]`` — mirrors ``repro_torch.obs.validate``.  A copy of
``repro/analysis/lint.py``, held to the same output by
``tests/test_torch_planning.py``.

Exit 0 and one ``PLAN_LINT_OK <file>`` line per clean plan; errors are
printed as ``H2Exxx`` diagnostics and exit 1.  Warnings print but do
not fail.  ``--arch`` adds the cfg-full passes (resource bounds +
kernel lint); ``--schedules`` additionally sweeps every registered
schedule over the conformance grid through the promoted safety passes.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .diagnostics import split
from .plan_verifier import analyze_plan
from .schedule_safety import verify_schedule_cached

#: the conformance-harness grid (tests/test_schedule_conformance.py)
GRID = [(2, 2), (2, 8), (3, 6), (4, 8), (4, 16), (5, 10), (6, 12),
        (8, 16)]


def _load_cfg(arch: Optional[str], smoke: bool):
    if arch is None:
        return None
    from ..configs import get_config
    cfg = get_config(arch)
    if smoke:
        from ..models.config import reduced
        cfg = reduced(cfg)
    return cfg


def _lint_file(path: str, cfg, args) -> bool:
    try:
        with open(path) as f:
            plan = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"{path}: unreadable plan: {e}", file=sys.stderr)
        return False
    diags = analyze_plan(plan, cfg, seq_len=args.seq,
                         gbs_tokens=args.gbs_tokens,
                         page_size=args.page_size)
    errs, warns = split(diags)
    for d in warns:
        print(f"{path}: WARNING {d.format()}")
    for d in errs:
        print(f"{path}: {d.format()}", file=sys.stderr)
    if errs:
        return False
    print(f"PLAN_LINT_OK {path}")
    return True


def _lint_registry() -> bool:
    from ..core.schedules import available_schedules, get_schedule
    ok, points = True, 0
    for name in available_schedules():
        sched = get_schedule(name)
        for S, b in GRID:
            if not sched.supports(S, b):
                continue
            points += 1
            diags = verify_schedule_cached(sched, S, b)
            errs, warns = split(diags)
            for d in warns:
                print(f"schedule {name}: WARNING {d.format()}")
            for d in errs:
                print(f"schedule {name}: {d.format()}", file=sys.stderr)
                ok = False
    if ok:
        print(f"SCHEDULE_REGISTRY_OK schedules="
              f"{len(available_schedules())} points={points}")
    return ok


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="statically verify ParallelPlan JSON files "
                    "(DESIGN.md §15)")
    p.add_argument("plans", nargs="*", help="plan JSON files")
    p.add_argument("--arch", default=None,
                   help="model config name; enables the cfg-full "
                        "passes (memory bounds, kernel lint)")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced smoke variant of --arch")
    p.add_argument("--seq", type=int, default=4096)
    p.add_argument("--gbs-tokens", type=float, default=None)
    p.add_argument("--page-size", type=int, default=None)
    p.add_argument("--schedules", action="store_true",
                   help="also sweep the whole schedule registry over "
                        "the conformance grid")
    args = p.parse_args(argv)
    if not args.plans and not args.schedules:
        p.error("nothing to lint: pass plan files and/or --schedules")

    cfg = _load_cfg(args.arch, args.smoke)
    ok = True
    for path in args.plans:
        ok = _lint_file(path, cfg, args) and ok
    if args.schedules:
        ok = _lint_registry() and ok
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
