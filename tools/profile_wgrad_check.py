#!/usr/bin/env python
"""Repeat ``chip_smoke.py``'s measured auto-profiler on the card and show
how steady its weight-gradient split is: ``phase_profiler`` for granite-8b
(phase 12), qwen3-moe (its profile beside phase 11), whisper-base and
paligemma-3b (phase 42's serve phases), ``--reps`` times each, then
paligemma-3b ``--reps`` times with the card's sleep before each timed
backward pass switched off (the timing before that sleep was added), so
that ``t_dgrad`` and ``t_wgrad`` read with and without the host's launch
cadence.  Each call prints chip_smoke's own lines; a call whose checks
fail prints its error and the run goes on.

    python3 tools/profile_wgrad_check.py [--reps 3]

Needs one card; prints the card's ``nvidia-smi`` name and power limit
first and ``{"t_dgrad": ..., "t_wgrad": ...}`` lines a call last.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import chip_smoke as cs
    from repro_torch.core import profiler
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    build.load()
    cases = [("granite-8b", (), {}),
             ("qwen3-moe", (cs.MOE_ARCH, cs.MOE_TRAIN_LAYERS), {}),
             ("whisper-base", (cs.WHISPER_ARCH,),
              dict(seq=cs.WHISPER_SEQ, iters=cs.WHISPER_PROFILE_ITERS)),
             ("paligemma-3b", (cs.PALIGEMMA_ARCH,),
              dict(seq=cs.PALIGEMMA_SEQ, iters=cs.PALIGEMMA_PROFILE_ITERS))]
    rows = []
    measure = profiler.measure_layer_profile

    def keep(*a, **kw):
        out = measure(*a, **kw)
        rows[-1].update(t_dgrad=out["t_dgrad"], t_wgrad=out["t_wgrad"])
        return out

    profiler.measure_layer_profile = keep
    sleep = torch.cuda._sleep
    runs = [(name, a, kw, True) for _ in range(args.reps) for name, a, kw in cases]
    runs += [(cases[-1][0], cases[-1][1], cases[-1][2], False)] * args.reps
    for name, a, kw, hold in runs:
        # without the hold only the sleep that calibrates the hold runs
        torch.cuda._sleep = sleep if hold else (
            lambda c: sleep(c) if c == 10_000_000 else None)
        rows.append({"model": name, "hold": hold})
        t0 = time.perf_counter()
        try:
            cs.phase_profiler(*a, **kw)
        except AssertionError as e:
            rows[-1]["error"] = str(e)[:300]
        rows[-1]["s"] = round(time.perf_counter() - t0, 1)
    torch.cuda._sleep = sleep
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
