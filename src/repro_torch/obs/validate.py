"""Run-directory validator (the CI gate for DESIGN.md §14).

    PYTHONPATH=src python -m repro_torch.obs.validate RUN_DIR [--require-trace]

Checks whatever observability artifacts a run directory holds —
``metrics.jsonl`` (schema'd meta line + metrics/histogram rows),
``trace_predicted.json`` / ``trace_executed.json`` (``validate_trace``
conformance), ``align.json`` (tick counts must match; a missing
``stragglers`` section warns rather than fails — older producers
predate it), and ``plan.json`` (folded through the static plan
verifier, ``repro_torch.analysis`` — DESIGN.md §15) — and prints
``OBS_SCHEMA_OK RUN_DIR`` or every error with exit 1.  Warnings print
but keep exit 0.  ``--require-trace`` additionally fails when the
trace/alignment trio is absent (the ``train.py --trace`` contract).
Imports neither torch nor the planning core at module level, so it can
gate artifacts from any producer.  A copy of ``repro/obs/validate.py``,
held equal to it by ``tests/test_torch_obs.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .metrics import MET_SCHEMA_VERSION
from .trace import validate_trace

TRACE_FILES = ("trace_predicted.json", "trace_executed.json")


def validate_metrics_lines(lines) -> List[str]:
    """Schema check for a ``metrics.jsonl`` body: a versioned ``meta``
    first row, then ``metrics``/``histogram`` rows, every row a JSON
    object with a numeric ``ts``."""
    errs: List[str] = []
    rows = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except json.JSONDecodeError as e:
            errs.append(f"line {i + 1}: not JSON ({e})")
            continue
        if not isinstance(row, dict):
            errs.append(f"line {i + 1}: row is not an object")
            continue
        rows.append((i + 1, row))
    if not rows:
        return errs + ["no rows"]
    first = rows[0][1]
    if first.get("kind") != "meta":
        errs.append("first row must be kind=meta")
    elif first.get("schema_version") != MET_SCHEMA_VERSION:
        errs.append(f"meta schema_version "
                    f"{first.get('schema_version')!r} != "
                    f"{MET_SCHEMA_VERSION}")
    for ln, row in rows:
        kind = row.get("kind")
        if kind not in ("meta", "metrics", "histogram"):
            errs.append(f"line {ln}: unknown kind {kind!r}")
            continue
        if not isinstance(row.get("ts"), (int, float)):
            errs.append(f"line {ln}: missing numeric ts")
        if kind == "histogram" and not isinstance(row.get("name"), str):
            errs.append(f"line {ln}: histogram row missing name")
    if not any(r.get("kind") in ("metrics", "histogram")
               for _, r in rows):
        errs.append("no metrics/histogram rows after the meta line")
    return errs


def validate_run_dir(run_dir: str, *, require_trace: bool = False,
                     warnings: Optional[List[str]] = None) -> List[str]:
    """Returns the error list; non-fatal findings are appended to the
    caller-supplied ``warnings`` list (ignored when None)."""
    errs: List[str] = []
    warns = warnings if warnings is not None else []
    if not os.path.isdir(run_dir):
        return [f"not a directory: {run_dir}"]

    def load(name):
        path = os.path.join(run_dir, name)
        if not os.path.exists(path):
            return None
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            errs.append(f"{name}: unreadable ({e})")
            return None

    mpath = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(mpath):
        with open(mpath, encoding="utf-8") as f:
            errs.extend(f"metrics.jsonl: {e}"
                        for e in validate_metrics_lines(f))
    else:
        errs.append("metrics.jsonl missing")

    traces = {}
    for name in TRACE_FILES:
        trace = load(name)
        if trace is not None:
            traces[name] = trace
            errs.extend(f"{name}: {e}" for e in validate_trace(trace))
        elif require_trace:
            errs.append(f"{name} missing (--require-trace)")

    align = load("align.json")
    if align is not None:
        if not align.get("ticks_match"):
            errs.append(
                f"align.json: ticks_match is false (priced="
                f"{align.get('priced_ticks')}, executed="
                f"{align.get('executed_ticks')})")
        exe = traces.get("trace_executed.json")
        if exe is not None and align.get("executed_ticks") != \
                exe.get("metadata", {}).get("ticks"):
            errs.append("align.json executed_ticks disagrees with "
                        "trace_executed.json metadata.ticks")
        if "stragglers" not in align:
            # producers before the straggler report omit the section;
            # the alignment numbers above are still fully checkable
            warns.append("align.json: no stragglers section (older "
                         "producer?) — straggler attribution unchecked")
    elif require_trace:
        errs.append("align.json missing (--require-trace)")

    plan = load("plan.json")
    if plan is not None:
        # fold the static plan verifier in (cfg-free passes —
        # DESIGN.md §15)
        from ..analysis import analyze_plan, split
        perrs, pwarns = split(analyze_plan(plan))
        errs.extend(f"plan.json: {d.format()}" for d in perrs)
        warns.extend(f"plan.json: {d.format()}" for d in pwarns)
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate a run directory's observability artifacts")
    ap.add_argument("run_dir")
    ap.add_argument("--require-trace", action="store_true",
                    help="fail when the trace/alignment files are absent")
    args = ap.parse_args(argv)
    warns: List[str] = []
    errs = validate_run_dir(args.run_dir,
                            require_trace=args.require_trace,
                            warnings=warns)
    for w in warns:
        print(f"WARNING: {w}")
    if errs:
        for e in errs:
            print(f"ERROR: {e}", file=sys.stderr)
        return 1
    print(f"OBS_SCHEMA_OK {args.run_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
