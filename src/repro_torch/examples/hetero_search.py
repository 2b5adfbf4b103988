"""HeteroAuto walkthrough (the counterpart of ``examples/hetero_search.py``),
the paper's core contribution, end to end, on the port's planning
copies:

  1. describe a hyper-heterogeneous cluster (chip types x counts),
  2. reproduce the homogeneous Table 6 baselines,
  3. search a HeteroPP plan (DFS + two-stage refinement, schedule as a
     search dimension),
  4. report HeteroSpeedupRatio (Fig 11) and replay the plan through the
     schedule simulator with DiComm transports (Table 9 style),
  5. optionally save the winning plan as JSON (``--save-plan plan.json``)
     for ``python -m repro_torch.launch.train --plan`` to execute on the
     HeteroPP pipeline.

    PYTHONPATH=src python -m repro_torch.examples.hetero_search \\
        [--cluster A:256,B:256,C:256] [--gbs-mtokens 6] [--schedule auto] \\
        [--save-plan plan.json]

It plans and runs nothing: no device is used.
"""
from __future__ import annotations

import argparse
import json

from ..configs import get_config
from ..core import chips, heteroauto, schedule as SCH
from ..core.schedules import available_schedules, get_schedule


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster", default="A:256,B:256,C:256",
                    help="comma list of CHIP:COUNT "
                         f"(chips: {list(chips.CHIPS)})")
    ap.add_argument("--gbs-mtokens", type=float, default=6.0)
    ap.add_argument("--model", default="h2_100b")
    ap.add_argument("--schedule", default="auto",
                    choices=["auto"] + available_schedules(),
                    help="pipeline schedule ('auto' searches over the "
                         "default candidate set)")
    ap.add_argument("--save-plan", default=None, metavar="PLAN.json",
                    help="write the winning plan as JSON for "
                         "launch/train.py --plan")
    args = ap.parse_args(argv)

    cfg = get_config(args.model)
    groups = []
    for part in args.cluster.split(","):
        name, count = part.split(":")
        groups.append(chips.ChipGroup(chips.CHIPS[name], int(count)))
    gbs = int(args.gbs_mtokens * 2 ** 20)

    print(f"model: {cfg.name} ({cfg.param_count() / 1e9:.0f}B), "
          f"GBS {gbs / 2 ** 20:.0f}M tokens")
    print("cluster:", ", ".join(f"{g.spec.name}x{g.count}" for g in groups))

    baselines = []
    for g in groups:
        t6 = chips.TABLE6.get(g.spec.name)
        r = heteroauto.homogeneous_baseline(
            g, cfg, 2 * 2 ** 20, 4096,
            fixed={"dp": t6["dp"], "tp": t6["tp"],
                   "recompute": t6["recompute"]} if t6 else None,
            allow_offload=True)
        baselines.append((g, r))
        print(f"  homogeneous {g.spec.name}: TGS={r.tgs:.1f}")

    sched = None if args.schedule == "auto" else args.schedule
    r = heteroauto.search(groups, cfg, gbs, 4096, two_stage=True,
                          schedule=sched)
    if r.plan is None:
        print("no feasible heterogeneous plan")
        return
    print(f"\nHeteroAuto plan ({r.search_time_s:.2f}s, "
          f"{r.evaluated} configs):")
    print(" ", r.plan.describe())
    # which layout the JAX launcher's --plan would take: "uniform-tp" (2-D
    # pipe x tp mesh), "grouped-tp" (DESIGN.md §12 stage groups), or
    # "refused: ..." for the inexpressible layouts
    print(f"  runtime: {r.runtime}")
    if args.save_plan:
        with open(args.save_plan, "w") as f:
            json.dump(r.plan.to_dict(), f, indent=2)
        print(f"  plan saved to {args.save_plan} "
              f"(run: launch/train.py --plan {args.save_plan})")
    print(f"  iteration time: {r.cost.iter_time:.2f}s  TGS={r.tgs:.1f} "
          f"(schedule={r.plan.schedule}, α={r.cost.alpha:.2f})")
    # Fig 11 is an apples-to-apples metric: re-baseline the homogeneous
    # configs under the SAME schedule the hetero plan runs, so the ratio
    # measures heterogeneity, not the schedule's bubble reduction
    ratio_baselines = baselines
    if r.plan.schedule != "1f1b":
        ratio_baselines = []
        for g in groups:
            t6 = chips.TABLE6.get(g.spec.name)
            rb = heteroauto.homogeneous_baseline(
                g, cfg, 2 * 2 ** 20, 4096, alpha=None,
                schedule=r.plan.schedule,
                fixed={"dp": t6["dp"], "tp": t6["tp"],
                       "recompute": t6["recompute"]} if t6 else None,
                allow_offload=True)
            ratio_baselines.append((g, rb))
    ratio = heteroauto.hetero_speedup_ratio(r, ratio_baselines)
    print(f"  HeteroSpeedupRatio = {ratio:.2%} "
          f"(both sides on {r.plan.schedule})"
          f"{' (superlinear!)' if ratio > 1 else ''}")

    for transport in ("device_rdma", "cpu_tcp"):
        sim = SCH.simulate_plan(r.plan, cfg, 4096, transport=transport)
        print(f"  {r.plan.schedule} replay [{transport:11s}]: "
              f"makespan={sim.makespan:.2f}s bubble={sim.bubble_frac:.1%}")

    print("  schedule comparison (device_rdma replay):")
    b = r.plan.microbatches
    for name in available_schedules():
        if not get_schedule(name).supports(r.plan.total_pp, b):
            print(f"    {name:12s}: n/a for (S={r.plan.total_pp}, b={b})")
            continue
        sim = SCH.simulate_plan(r.plan, cfg, 4096, schedule=name)
        print(f"    {name:12s}: makespan={sim.makespan:.2f}s "
              f"bubble={sim.bubble_frac:.1%}")


if __name__ == "__main__":
    main()
