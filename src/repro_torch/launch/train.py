"""Training launcher (the counterpart of ``repro/launch/train.py``): one
device, or the HeteroPP pipeline with one process a stage.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_780m \\
        --steps 50 --batch 8 --seq 256 [--backend auto|einsum|kernel] \\
        [--device cuda|cpu] [--smoke] [--ckpt-dir DIR --ckpt-every N] \\
        [--accum A] [--remat-policy full|dots] \\
        [--model-parallel N [--data-parallel D] [--p2p device|host]] \\
        [--pipeline-parallel N [--tensor-parallel T] [--data-parallel D] \\
         [--schedule 1f1b] [--microbatches B] \\
         [--grad-sync psum|reduce_scatter] [--bucket-bytes N] \\
         | --plan plan.json | --search A:1,B:1 [--search-dp 1,2] \
         [--search-uneven-dp]] [--reshard sr_ag|naive] [--p2p device|host] \\
         [--trace [--straggler-factor 1.5]]

Runs on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises.  On the card, a run whose shapes the
kernels would refuse (``analysis.card_lint``: head dims, the decode
group, the scan's tiles, the sequence in whole chunks) exits naming the
rule before any weights are built, on each rank's share of the heads.
``--backend`` picks the kernel
path: ``auto`` takes the CUDA kernels (``flash_attention``,
``ssd_scan``) on the card and the plain paths on the CPU; ``kernel``
forces them (and raises on the CPU).  Weights are random, drawn from
``--seed``; data is the ``SyntheticTokens`` stream of the JAX launcher.
Prints ``arch=… family=… params~…M devices=…`` and every
``--log-every`` steps ``step N loss=… lr=… gnorm=… TGS=…``, with the
same row in ``<run-dir>/metrics.jsonl``.  ``main`` also returns the
per-step losses and times to a caller in Python.

``--model-parallel N`` (or ``--data-parallel D`` without a pipeline)
trains on a (data, model) rank grid (``launch.mesh.make_local_mesh``:
rank = d·N + m) through ``sharding.spmd``: the JAX launcher's GSPMD path,
its state placed by the copied ``sharding`` rules (FSDP over data, one
dim over model), its collectives written out (at N > 1 Megatron blocks,
expert parallelism and mamba2 head sharding; a part whose count N does
not split, ``sharding.spmd.whole_parts``, computed whole on every member,
printed on the ``arch=`` line and named under ``"whole"`` in the
metadata row).  The data degree D is the world over N: a
``torchrun`` job's ``WORLD_SIZE``, or one rank a visible card under
``--p2p device`` (the default), the launcher spawning them.  JAX sees a
host's devices from one process, torch needs a process a rank, so on the
CPU, or with ranks sharing a card (``--p2p host``), ``--data-parallel D``
gives the data degree (``make_local_mesh``'s ``data``; default 1).
``--accum`` and ``--ckpt-dir`` / ``--ckpt-every`` work there: rank 0
writes the single-device checkpoint format, gathered, so a checkpoint
resumes on a grid or one device either way.  Rank 0 prints ``arch=…
devices=D·N`` and the step lines, writes ``metrics.jsonl`` with ``"mode":
"gspmd"`` and ends with a summary of the step p50 and the collectives a
step by axis; ``main`` returns the losses, step times, each rank's peak
memory and persistent state bytes (with their closed form) and the
collectives.  A 1 x 1 grid is the single-device path.

``--pipeline-parallel N`` trains through ``core.heteropp`` on a rank
grid of D·N·T ranks (``--data-parallel D`` replicas of N physical
stages, each over ``--tensor-parallel T`` Megatron members; rank
``(d·N + s)·T + k``), under ``--schedule`` (default 1f1b) with
``--microbatches`` microbatches a replica (default N), the layers split
evenly.  With D > 1 ``--grad-sync`` picks the dp gradient sync: ZeRO-1
``reduce_scatter`` (the default) or ``psum``, bucketed with
``--bucket-bytes N``.  ``--plan plan.json`` runs a saved HeteroAuto
``ParallelPlan`` (``ParallelPlan.to_dict`` JSON: its schedule, stages,
non-uniform layer split, per-stage recompute, tp, dp and sync mode), and
``--search CHIP:N,...`` runs the HeteroAuto search on that cluster first
and trains the winner (``--search-dp`` widens its dp candidates,
``--search-uneven-dp`` admits dp degrees that do not divide the batch).
A plan whose stages disagree on tp runs on the grouped layout of Σ tp_s
ranks (stage s on tp_s of them, the plan's ``sr_ag`` or ``naive``
reshard at each boundary where tp changes, the one
``resharding.choose_strategy`` prices lower unless ``--reshard`` names
one for every such boundary, as ``cost_model.evaluate(resharding=…)``
prices it); a plan with a non-uniform
``batch_domain`` gives each dp replica its own microbatch count.  A plan
passes the copied static verifier first (``--no-verify-plan`` skips
it).  The launcher starts its
own ranks (``launch.ranks.spawn``, a ``FileStore`` in the run
directory), or runs one rank of a job started outside it: a ``torchrun``
job when its environment names one (the card is ``LOCAL_RANK``), or the
process group its caller has joined.  ``--p2p`` names the transport of
every group: ``device`` (NCCL, one card a rank; the default) or
``host`` (gloo through host memory: the CPU, or several ranks on one
card).  Every rank logs its steps and losses: rank 0 prints them and
writes ``metrics.jsonl`` with ``"mode": "pipeline"``, then prints the
step p50 and the collectives' ms a step by group; rank r writes
``rank<r>/metrics.jsonl`` in the run directory.

``--trace`` (pipeline runs only) traces one more forward and backward
after the timed steps, on the final parameters and the last batch
(``obs.runtime.trace_pipeline``: the step's own tick loop, each tick's
compute and exchange stamped after a device synchronize), and rank 0
writes next to ``metrics.jsonl`` what the JAX launcher writes:
``trace_predicted.json`` (the event simulator's timeline of the plan,
or of the spec in layer units where there is no plan or it is a
per-leaf psum plan, which the cost model cannot price),
``trace_executed.json``, ``align.json`` (ticks priced against executed, per-stage forward shares,
and a ``stragglers`` section: stages against the plan's priced compute,
replicas against their allocations, flagged beyond
``--straggler-factor`` × the median) and ``plan.json`` when there is a
plan; ``python -m repro_torch.obs.validate --require-trace RUN_DIR``
checks them.  The timed steps' launches and times do not include the
traced passes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from .. import device as devices
from ..analysis import card_lint
from ..checkpointing.io import (checkpoint_step, load_checkpoint,
                                save_checkpoint)
from ..comm import p2p as P2P
from ..configs import canonical, get_config, get_smoke_config, list_configs
from ..core.dataparallel.grad_sync import GRAD_SYNC_MODES
from ..core.schedules import available_schedules
from ..data.pipeline import DataConfig, make_loader
from ..kernels import build as kbuild
from ..kernels import ops
from ..kernels.ops import BACKENDS
from ..obs.metrics import MetricsLogger
from ..obs.runtime import device_memory_highwater
from ..optim import adamw
from ..optim.adamw import AdamWConfig
from ..training.train_step import (make_train_state, make_train_step,
                                   train_state_from)
from . import ranks

# a rank that waits longer than this on another fails the run
RANK_TIMEOUT_S = 1800.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--backend", default="auto", choices=BACKENDS,
                    help="kernel path: auto (CUDA kernels on the card, "
                         "plain PyTorch on the CPU), einsum, or kernel "
                         "(forced; raises on the CPU)")
    ap.add_argument("--device", default="cuda", choices=devices.DEVICES)
    ap.add_argument("--remat-policy", default="full", choices=("full", "dots"),
                    help="what each layer's checkpoint keeps: its input alone "
                         "(full), or also its projections' outputs (dots, "
                         "jax.checkpoint_policies.dots_with_no_batch_dims_saveable)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10,
                    help="cadence of BOTH the human step line and the "
                         "metrics.jsonl row")
    ap.add_argument("--run-dir", default=None,
                    help="metrics.jsonl directory (default runs/<arch>)")
    ap.add_argument("--pipeline-parallel", type=int, default=1,
                    help="train the HeteroPP pipeline over N ranks, one a "
                         "stage, the layers split evenly")
    ap.add_argument("--schedule", default=None, choices=available_schedules(),
                    help="pipeline schedule (with --pipeline-parallel; "
                         "default 1f1b; plans carry their own)")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="pipeline microbatches (default: = stages; plans "
                         "carry their own)")
    ap.add_argument("--plan", default=None,
                    help="train a saved HeteroAuto ParallelPlan (JSON of "
                         "ParallelPlan.to_dict) through the pipeline")
    ap.add_argument("--search", default=None, metavar="CHIP:N,...",
                    help="HeteroAuto-search this chip cluster (e.g. A:1,B:1) "
                         "and train the winning plan")
    ap.add_argument("--search-dp", default=None, metavar="N,...",
                    help="with --search: dp candidate degrees (comma list, "
                         "default 1)")
    ap.add_argument("--search-uneven-dp", action="store_true",
                    help="with --search: also consider dp degrees that do not "
                         "divide the batch; the winner carries a "
                         "throughput-proportional batch_domain")
    ap.add_argument("--reshard", default=None, choices=("sr_ag", "naive"),
                    help="with a plan whose stages disagree on tp: this "
                         "strategy at every boundary where tp changes (default: "
                         "each boundary's choose_strategy pick)")
    ap.add_argument("--no-verify-plan", action="store_true",
                    help="skip the static plan verifier for --plan/--search")
    ap.add_argument("--p2p", default=None, choices=P2P.TRANSPORTS,
                    help="pipeline stage-to-stage transport: device (NCCL, "
                         "one card a rank; the default) or host (gloo "
                         "through host memory: the CPU, or ranks sharing a "
                         "card)")
    ap.add_argument("--tensor-parallel", type=int, default=0,
                    help="with --pipeline-parallel: shard every stage over N "
                         "Megatron tp members (default 1; plans carry their "
                         "own tp)")
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="with --pipeline-parallel: N pipeline replicas, each "
                         "taking its share of the microbatches (default 1; "
                         "plans carry their own dp); without it, the data "
                         "degree of the (data, model) grid under --p2p host")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="train on a (data, model) rank grid with a model "
                         "axis of N (the JAX launcher's GSPMD path; dense and "
                         "vlm models at N > 1)")
    ap.add_argument("--grad-sync", default=None, choices=GRAD_SYNC_MODES,
                    help="with --data-parallel: psum (replicated optimizer "
                         "state) or ZeRO-1 reduce_scatter + all-gather "
                         "(dp-sharded optimizer state; the default)")
    ap.add_argument("--bucket-bytes", type=int, default=0,
                    help="with --data-parallel --grad-sync psum: fused "
                         "all-reduces of at most this many bytes in "
                         "wgrad-completion order; 0 = one a leaf")
    ap.add_argument("--trace", action="store_true",
                    help="after training, trace one fenced forward and backward of "
                         "the pipeline's tick loop and write trace_predicted.json / "
                         "trace_executed.json / align.json to --run-dir (pipeline "
                         "runs only)")
    ap.add_argument("--straggler-factor", type=float, default=1.5,
                    help="with --trace: flag a stage/replica whose measured/priced "
                         "ratio exceeds this factor x the cohort median")
    return ap.parse_args(argv)


def _refuse(args, pipeline: bool) -> None:
    """Flags the chosen path would not honour exit with a message."""
    if (args.search_dp or args.search_uneven_dp) and not args.search:
        flag = "--search-dp" if args.search_dp else "--search-uneven-dp"
        raise SystemExit(f"{flag} only shapes the HeteroAuto search; "
                         f"add --search CHIP:N,...")
    if args.model_parallel < 1 or args.data_parallel < 0:
        raise SystemExit("--model-parallel and --data-parallel must be positive")
    if not pipeline:
        if args.trace:
            # the trace re-drives the pipeline's tick program; the grid has none
            raise SystemExit("--trace re-drives the pipeline's tick program; "
                             "add --pipeline-parallel N (or --plan/--search)")
        if args.tensor_parallel:
            raise SystemExit(
                f"--tensor-parallel {args.tensor_parallel} only applies to the "
                f"pipeline; add --pipeline-parallel N (or use --model-parallel "
                f"for the (data, model) grid's tensor parallelism)")
        given = [flag for flag, on in (
            ("--schedule", args.schedule), ("--microbatches", args.microbatches),
            ("--no-verify-plan", args.no_verify_plan),
            ("--grad-sync", args.grad_sync),
            ("--bucket-bytes", args.bucket_bytes), ("--reshard", args.reshard)) if on]
        if given:
            raise SystemExit(f"{' '.join(given)} only apply to the pipeline; "
                             "add --pipeline-parallel N, --plan or --search")
        return
    if args.model_parallel > 1:
        raise SystemExit(f"--model-parallel {args.model_parallel} is the (data, model) "
                         f"grid's; the pipeline takes --tensor-parallel")
    if args.remat_policy != "full":
        raise SystemExit(f"--remat-policy {args.remat_policy}: the pipeline's stages "
                         f"checkpoint each layer whole (each plan stage's recompute "
                         f"flag); drop --remat-policy")
    if args.plan and args.search:
        raise SystemExit("--plan and --search are mutually exclusive")
    if args.reshard and not (args.plan or args.search):
        raise SystemExit(f"--reshard {args.reshard} picks the boundary collective of a "
                         f"plan whose stages disagree on tp; add --plan or --search")
    if args.plan or args.search:
        src = "--plan" if args.plan else "--search"
        if args.schedule is not None:
            raise SystemExit(f"{src} uses the plan's schedule; drop "
                             f"--schedule {args.schedule}")
        if args.grad_sync is not None:
            raise SystemExit(f"{src} sets the grad-sync mode from the "
                             f"plan (searched over sync mode × bucket "
                             f"size — DESIGN.md §10); drop --grad-sync "
                             f"{args.grad_sync}")
        if args.pipeline_parallel > 1:
            raise SystemExit(f"{src} sets the stage count from the plan; "
                             f"drop --pipeline-parallel")
        if args.tensor_parallel:
            raise SystemExit(f"{src} sets tp from the plan (uniform plans "
                             f"execute on the (pipe, tp) mesh, non-uniform "
                             f"ones via the grouped stage runtime); drop "
                             f"--tensor-parallel {args.tensor_parallel}")
        if args.data_parallel:
            raise SystemExit(f"{src} sets dp from the plan (uniform batch "
                             f"domains execute on the (dp, pipe, tp) "
                             f"mesh); drop --data-parallel "
                             f"{args.data_parallel}")
        if args.bucket_bytes:
            raise SystemExit(f"{src} sets the grad-sync bucket size from "
                             f"the plan (searched over bucket size × sync "
                             f"mode — DESIGN.md §10); drop --bucket-bytes "
                             f"{args.bucket_bytes}")
    if args.accum != 1:
        raise SystemExit("--accum: the pipeline's microbatches take its "
                         "place; drop --accum")
    if args.ckpt_dir or args.ckpt_every:
        raise SystemExit("--ckpt-dir/--ckpt-every: checkpoints of the "
                         "pipeline's stage layout are not ported yet")


def main(argv=None):
    args = parse_args(argv)
    pipeline = args.pipeline_parallel > 1 or bool(args.plan or args.search)
    _refuse(args, pipeline)
    dev = devices.resolve(args.device)
    name = canonical(args.arch)
    cfg = get_smoke_config(name) if args.smoke else get_config(name)
    if pipeline:
        return run_pipeline(args, cfg, dev)
    grid = gspmd_grid(args, dev)
    if grid != (1, 1):
        return run_gspmd(args, cfg, dev, *grid)
    card_lint.refuse_on_card(cfg, dev, args.backend, seq_len=args.seq)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params~{cfg.param_count() / 1e6:.1f}M devices=1 ({dev})", flush=True)
    if dev.type == "cuda" and args.backend != "einsum":
        t0 = time.perf_counter()
        kbuild.load()                    # set-up, kept out of the step times
        print(f"kernels ready: {time.perf_counter() - t0:.1f} s")

    opt = _opt(args)
    state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                             device=dev)
    step_fn = make_train_step(cfg, opt, accum_steps=args.accum,
                              remat_policy=_remat_policy(args), backend=args.backend)
    loader = make_loader(cfg, DataConfig(batch_size=args.batch, seq_len=args.seq,
                                         seed=1234 + args.seed), device=dev)
    if args.ckpt_dir and checkpoint_step(args.ckpt_dir) is not None:
        state = load_checkpoint(args.ckpt_dir, state)
        print(f"resumed from {args.ckpt_dir} at step {state.step}")

    run_dir = args.run_dir or os.path.join("runs", cfg.name)
    meta = {"arch": cfg.name, "family": cfg.family, "mode": "single",
            "devices": 1, "batch": args.batch, "seq": args.seq,
            "backend": args.backend, "device": str(dev)}
    tokens_per_step = args.batch * args.seq
    losses, grad_norms, step_times = [], [], []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with MetricsLogger(run_dir, meta=meta) as metrics:
        t0 = time.perf_counter()
        t_last, i_last = t0, 0
        for i in range(args.steps):
            batch = next(loader)
            t1 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))          # waits for the step
            devices.synchronize(dev)
            step_times.append(time.perf_counter() - t1)
            grad_norms.append(float(m["grad_norm"]))
            if (i + 1) % args.log_every == 0 or i == 0:
                now = time.perf_counter()
                tgs = tokens_per_step * (i + 1) / (now - t0)
                metrics.log(step=i + 1, tokens_per_s=tgs, tgs=tgs,
                            step_time_s=(now - t_last) / (i + 1 - i_last),
                            peak_bytes_in_use=device_memory_highwater(dev),
                            **{k: float(v) for k, v in m.items()})
                t_last, i_last = now, i + 1
                print(f"step {i + 1:5d} loss={losses[-1]:.4f} "
                      f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.2f} "
                      f"TGS={tgs:.0f}", flush=True)
            if args.ckpt_dir and args.ckpt_every and \
                    (i + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, state, step=i + 1)
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, state, step=args.steps)
        print(f"checkpoint saved to {args.ckpt_dir}")
    return {"arch": cfg.name, "num_layers": cfg.num_layers, "losses": losses,
            "grad_norms": grad_norms, "step_times_s": step_times,
            "tokens_per_step": tokens_per_step,
            "peak_mem_bytes": device_memory_highwater(dev), "state": state}


def _torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def _remat_policy(args):
    return None if args.remat_policy == "full" else args.remat_policy


def _opt(args) -> AdamWConfig:
    return AdamWConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 5))


# ---------------------------------------------------------------------------
# the (data, model) grid: the JAX launcher's GSPMD path
# ---------------------------------------------------------------------------

def gspmd_grid(args, dev):
    """(D, M) of the (data, model) grid off the pipeline: (1, 1) unless
    ``--model-parallel``, ``--data-parallel``, ``--p2p`` or a job of
    several ranks asks for a grid.  The world is the job's (``torchrun``,
    or the process group a caller has joined), else one rank a card
    under ``--p2p device`` or ``--data-parallel`` x ``--model-parallel``
    under ``--p2p host``."""
    M = args.model_parallel
    joined = torch.distributed.is_available() and torch.distributed.is_initialized()
    if _torchrun():
        world = int(os.environ["WORLD_SIZE"])
    elif joined:
        world = torch.distributed.get_world_size()
    elif not (M > 1 or args.data_parallel or args.p2p):
        return 1, 1
    elif (args.p2p or "device") == "device":
        try:
            P2P.check_transport("device", dev, M * max(args.data_parallel, 1))
        except ValueError as e:
            raise SystemExit(str(e)) from None
        world = torch.cuda.device_count()
    else:
        world = (args.data_parallel or 1) * M
    if world % M:
        raise SystemExit(f"--model-parallel {M} does not divide the {world} ranks")
    D = world // M
    if args.data_parallel and args.data_parallel != D:
        raise SystemExit(f"--data-parallel {args.data_parallel} x --model-parallel {M} "
                         f"is not the job's {world} ranks")
    return D, M


def run_gspmd(args, cfg, dev, D, M):
    """Train on the (data, model) grid: checks, then one rank a grid
    cell (spawned here, or this process's rank of a job started outside
    the launcher).  Returns rank 0's results with each rank's peak
    memory, state bytes and collectives beside them and the kernels'
    launches summed over the ranks (when spawned here)."""
    from ..sharding import spmd
    transport = args.p2p or "device"
    world = D * M
    try:
        card_lint.refuse_on_card(cfg, dev, args.backend, seq_len=args.seq, members=(M,))
        P2P.check_transport(transport, dev, int(os.environ.get("LOCAL_WORLD_SIZE", world))
                            if _torchrun() else world)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e)) from None
    if args.batch % (args.accum * D):
        raise SystemExit(f"--batch {args.batch} does not split into --accum {args.accum} "
                         f"microbatches over the {D} data ranks")
    whole = spmd.whole_parts(cfg, M)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params~{cfg.param_count() / 1e6:.1f}M devices={D}·{M} (data {D} x model "
          f"{M}, {dev}, p2p {transport})"
          + "".join(f"; {part} whole on every member ({n})" for part, n in whole.items()),
          flush=True)
    run_dir = args.run_dir or os.path.join("runs", cfg.name)
    os.makedirs(run_dir, exist_ok=True)
    job = (args, cfg, D, M, transport)
    if _torchrun() or torch.distributed.is_initialized():
        return _join_job(job, transport, world, _gspmd_rank)
    threads = max(1, torch.get_num_threads() // world) if dev.type == "cpu" else None
    outs = ranks.spawn(_gspmd_rank, world, job, workdir=os.path.join(run_dir, "ranks"),
                       transport=transport, timeout=RANK_TIMEOUT_S, threads=threads)
    return merge_gspmd_results(outs)


def outside_collectives(step_times, stats):
    """Each step's seconds outside its collectives: its wall time less the
    wall ms of every all-gather, reduce-scatter and all-reduce it made
    (``spmd.Layout.counts``, each collective timed alone)."""
    return [t - sum(v for k, v in s.items() if k.endswith("_ms")) / 1e3
            for t, s in zip(step_times, stats)]


def merge_gspmd_results(outs):
    """The ranks' results of one grid run as the launcher returns them:
    rank 0's, each rank's peak memory, state bytes (and their closed
    form), losses and collectives a step beside it, the largest peak, and
    the kernels' launches summed over the ranks."""
    res = dict(outs[0])
    per_rank = [o["peak_mem_bytes"] for o in outs if o["peak_mem_bytes"] is not None]
    res["peak_mem_bytes"] = max(per_rank) if per_rank else None
    res["launches"] = {k: sum(o["launches"][k] for o in outs) for k in res["launches"]}
    for key in ("peak_mem_bytes", "losses", "state_bytes", "block_bytes", "grid",
                "stats", "step_times_s"):
        res[key + "_per_rank"] = [o[key] for o in outs]
    return res


def _gspmd_rank(rank, world, args, cfg, D, M, transport, *, local_rank=None):
    """One rank of the grid: its blocks of the seeded state (or of the
    checkpoint it resumes), its rows of every batch, the sharded step.
    Rank 0 prints and logs to ``metrics.jsonl``, every other rank to
    ``rank<r>/metrics.jsonl``.  Returns the rank's losses, step times,
    peak memory, persistent state bytes and their closed form, kernel
    launches (counted from 0 in this process) and collectives a step."""
    import statistics

    from ..checkpointing.io import CheckpointReader
    from ..launch.mesh import make_local_mesh
    from ..sharding import spmd
    base = devices.resolve(args.device)
    dev = P2P.rank_device(base, rank if local_rank is None else local_rank, transport)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if args.backend != "einsum":
            kbuild.load()
    mesh, grid = make_local_mesh(model=M, data=D, transport=transport, device=dev)
    layout = spmd.Layout(mesh, grid)
    step_fn = spmd.make_train_step(cfg, layout, _opt(args), accum_steps=args.accum,
                                   remat_policy=_remat_policy(args), backend=args.backend)
    specs = step_fn.specs
    if args.ckpt_dir and checkpoint_step(args.ckpt_dir) is not None:
        with CheckpointReader(args.ckpt_dir) as read:
            state = spmd.shard_state(read, layout, specs, device=dev)
        if rank == 0:
            print(f"resumed from {args.ckpt_dir} at step {state.step}")
    else:
        state = spmd.init_state(cfg, layout, specs,
                                torch.Generator(device=dev).manual_seed(args.seed),
                                device=dev)
    loader = make_loader(cfg, DataConfig(batch_size=args.batch, seq_len=args.seq,
                                         seed=1234 + args.seed), device=dev,
                         rows=spmd.local_rows(args.batch, layout, args.accum).numpy())
    run_dir = args.run_dir or os.path.join("runs", cfg.name)
    meta = {"arch": cfg.name, "family": cfg.family, "mode": "gspmd", "devices": world,
            "data_parallel": D, "model_parallel": M, "accum": args.accum,
            "batch": args.batch, "seq": args.seq, "backend": args.backend,
            "device": str(dev), "p2p": transport, "rank": rank, "grid": [grid.d, grid.k],
            "whole": step_fn.whole}

    def save(step):
        full = spmd.full_state(state, layout, specs)
        if rank == 0:
            save_checkpoint(args.ckpt_dir, full, step=step)

    tokens_per_step = args.batch * args.seq
    losses, grad_norms, step_times, stats = [], [], [], []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    logger = MetricsLogger(run_dir if rank == 0 else os.path.join(run_dir, f"rank{rank}"),
                           meta=meta)
    try:
        t0 = time.perf_counter()
        t_last, i_last = t0, 0
        for i in range(args.steps):
            batch = next(loader)
            t1 = time.perf_counter()
            state, m = step_fn(state, batch)
            devices.synchronize(dev)
            step_times.append(time.perf_counter() - t1)
            losses.append(m["loss"])
            grad_norms.append(m["grad_norm"])
            stats.append(dict(step_fn.stats))
            if (i + 1) % args.log_every == 0 or i == 0:
                now = time.perf_counter()
                tps = tokens_per_step * (i + 1) / (now - t0)
                logger.log(step=i + 1, tokens_per_s=tps, tgs=tps / world,
                           step_time_s=(now - t_last) / (i + 1 - i_last),
                           peak_bytes_in_use=device_memory_highwater(dev), **m,
                           **{k: v for k, v in stats[-1].items() if k != "whole"})
                t_last, i_last = now, i + 1
                if rank == 0:
                    print(f"step {i + 1:5d} loss={m['loss']:.4f} lr={m['lr']:.2e} "
                          f"gnorm={m['grad_norm']:.2f} TGS={tps / world:.0f}", flush=True)
            if args.ckpt_dir and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
                save(i + 1)
        launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
        peak = device_memory_highwater(dev)
        if args.ckpt_dir:
            save(args.steps)
            if rank == 0:
                print(f"checkpoint saved to {args.ckpt_dir}")
    finally:
        loader.close()
        logger.close()
    if rank == 0 and stats:
        steady = lambda k: statistics.median([s[k] for s in stats[1:] or stats])
        p50 = statistics.median(step_times[1:] or step_times)
        rest = outside_collectives(step_times, stats)
        print(f"summary (rank 0): p50 {p50 * 1e3:.1f} ms over steps 2-{len(stats)}, "
              f"{tokens_per_step / p50:.0f} tok/s, outside the collectives "
              f"{statistics.median(rest[1:] or rest) * 1e3:.1f} ms; collectives a step: "
              + "; ".join(
                  f"{axis} all-gather {steady(axis + '_gather_bytes') / 2**20:.1f} MiB "
                  f"{steady(axis + '_gather_ms'):.1f} ms, reduce-scatter "
                  f"{steady(axis + '_scatter_bytes') / 2**20:.1f} MiB "
                  f"{steady(axis + '_scatter_ms'):.1f} ms, all-reduce "
                  f"{steady(axis + '_reduce_bytes') / 2**20:.1f} MiB "
                  f"{steady(axis + '_reduce_ms'):.1f} ms"
                  for axis in ("data", "model", "world")), flush=True)
    return {"arch": cfg.name, "num_layers": cfg.num_layers, "losses": losses,
            "grad_norms": grad_norms, "step_times_s": step_times,
            "tokens_per_step": tokens_per_step,
            "peak_mem_bytes": peak, "mode": "gspmd", "launches": launches,
            "state_bytes": spmd.state_bytes(state),
            "block_bytes": sum(spmd.block_bytes(cfg, layout, specs).values()),
            "stats": stats, "rank": rank, "grid": [grid.d, grid.k], "device": str(dev),
            "whole": step_fn.whole}


# ---------------------------------------------------------------------------
# the HeteroPP pipeline
# ---------------------------------------------------------------------------

def pipeline_spec(args, cfg):
    """The PipelineSpec to train, its dp gradient-sync mode, and the plan
    it came from (or None): from ``--plan``, a fresh ``--search``, or the
    even split of ``--pipeline-parallel`` with ``--tensor-parallel`` and
    ``--data-parallel``.  Plans pass the static verifier first and carry
    their own sync mode."""
    from ..core import heteropp as HP
    mb = args.microbatches or None

    def _from_plan(plan):
        if not args.no_verify_plan:
            from ..analysis import analyze_plan, format_report, split
            errs, warns = split(analyze_plan(
                plan, cfg, seq_len=args.seq, gbs_tokens=args.batch * args.seq,
                microbatches=mb))
            for d in warns:
                print(f"plan verifier: WARNING {d.format()}")
            if errs:
                raise SystemExit("plan fails static verification "
                                 "(--no-verify-plan to bypass):\n"
                                 + format_report(errs))
        try:
            spec = HP.from_plan(plan, microbatches=mb, execute_tp=True,
                                execute_dp=True, verify=False)
            HP.validate_spec_tp(cfg, spec)
            if args.reshard:
                if not spec.grouped:
                    raise ValueError(f"--reshard {args.reshard}: the plan's stages share "
                                     f"one tp degree, so no boundary reshards")
                spec = dataclasses.replace(spec, reshard=tuple(
                    r if r == "none" else args.reshard for r in spec.reshard))
            return spec, plan.dp_sync, plan
        except (ValueError, NotImplementedError) as e:
            raise SystemExit(str(e)) from None

    if args.plan:
        from ..core.cost_model import ParallelPlan
        with open(args.plan) as f:
            try:
                plan = ParallelPlan.from_dict(json.load(f))
            except (KeyError, ValueError) as e:
                raise SystemExit(f"--plan {args.plan}: {e}") from None
        print(f"plan [{args.plan}]: {plan.describe()}")
        return _from_plan(plan)
    if args.search:
        from ..core import chips, heteroauto
        groups = []
        for part in args.search.split(","):
            chip, count = part.split(":")
            groups.append(chips.ChipGroup(chips.CHIPS[chip], int(count)))
        dp_cands = [int(d) for d in args.search_dp.split(",")] \
            if args.search_dp else [1]
        r = heteroauto.search(groups, cfg, args.batch * args.seq, args.seq,
                              two_stage=False, dp_candidates=dp_cands,
                              uneven_dp=args.search_uneven_dp)
        if r.plan is None:
            raise SystemExit(f"--search {args.search}: no feasible plan for "
                             f"{cfg.name}")
        print(f"searched plan ({r.evaluated} configs, {r.search_time_s:.2f}s): "
              f"{r.plan.describe()} [{r.runtime}]")
        return _from_plan(r.plan)
    from ..core.schedules import get_schedule
    pp = args.pipeline_parallel
    tp = args.tensor_parallel or 1
    dp = args.data_parallel or 1
    try:
        HP.validate_tensor_parallel(cfg, tp)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e)) from None
    grad_sync = args.grad_sync or "reduce_scatter"
    # flags the step would never consult refuse, not silently drop
    if args.grad_sync is not None and dp <= 1:
        raise SystemExit(
            f"--grad-sync {args.grad_sync} needs --data-parallel > 1: "
            f"there is no dp gradient sync without dp replicas")
    if args.bucket_bytes:
        if args.bucket_bytes < 0:
            raise SystemExit(
                f"--bucket-bytes must be positive: {args.bucket_bytes}")
        if dp <= 1:
            raise SystemExit(
                f"--bucket-bytes {args.bucket_bytes} needs "
                f"--data-parallel > 1: there is no dp grad sync to "
                f"bucket")
        if grad_sync != "psum":
            raise SystemExit(
                f"--bucket-bytes {args.bucket_bytes} only shapes the "
                f"psum sync mode (ZeRO-1 reduce_scatter keeps one "
                f"message per leaf — DESIGN.md §10); add "
                f"--grad-sync psum or drop the flag")
    sched = get_schedule(args.schedule or "1f1b")
    base, rem = divmod(cfg.num_layers, pp)
    phys = [base + (1 if i < rem else 0) for i in range(pp)]
    try:
        return HP.PipelineSpec(pp, HP.chunk_layer_counts(phys, sched),
                               microbatches=mb or pp, schedule=sched.name,
                               n_chunks=sched.n_chunks, tensor_parallel=tp,
                               data_parallel=dp,
                               bucket_bytes=args.bucket_bytes), grad_sync, None
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e)) from None


def run_pipeline(args, cfg, dev):
    """Train through the pipeline: checks, then one rank a (replica,
    stage, tp member) (spawned here, or this process's rank of a job
    started outside the launcher).  Returns rank 0's results: what the
    single-device path returns but the state, which stays in the ranks,
    and its collectives a step; when spawned here also each rank's peak
    memory, optimizer-state bytes and collectives, and the kernels'
    launches summed over the ranks."""
    from ..core.heteropp import pipeline_block_kind
    try:
        pipeline_block_kind(cfg)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    spec, grad_sync, plan = pipeline_spec(args, cfg)
    card_lint.refuse_on_card(cfg, dev, args.backend, seq_len=args.seq,
                             members=sorted(set(spec.stage_tps)))
    transport = args.p2p or "device"
    S, T, D = spec.num_stages, spec.tensor_parallel, spec.data_parallel
    # a grouped plan runs on Σ tp_s ranks, stage s on tp_s of them
    world = spec.pipe_width if spec.grouped else D * S * T
    env = os.environ
    torchrun = _torchrun()
    try:
        P2P.check_transport(transport, dev, int(env.get("LOCAL_WORLD_SIZE", world))
                            if torchrun else world)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if spec.total_layers != cfg.num_layers:
        raise SystemExit(f"plan covers {spec.total_layers} layers but "
                         f"{cfg.name} has {cfg.num_layers}")
    total_mb = spec.total_microbatches
    if args.batch % total_mb:
        raise SystemExit(f"--batch {args.batch} not divisible by the global "
                         f"microbatch count Σ allocations = {total_mb} "
                         f"(allocations {list(spec.batch_allocations)})")
    print(f"arch={cfg.name} family={cfg.family} "
          f"params~{cfg.param_count() / 1e6:.1f}M devices={world} ({dev}, p2p "
          f"{transport})", flush=True)
    print(f"pipeline: stages={S} "
          + (f"stage_tp={spec.stage_tp} reshard={spec.reshard} " if spec.grouped else "")
          + f"v={spec.n_chunks} layers/global-stage={spec.layers_per_stage} "
          f"recompute={spec.recompute} microbatches={spec.microbatches} "
          + (f"batch_domain={list(spec.batch_domain)} " if spec.batch_domain else "")
          + f"schedule={spec.schedule}", flush=True)
    if spec.grouped:
        print(f"grid: grouped, {world} ranks (stage s on ranks sum(stage_tp[:s]) "
              f"+ k, k < stage_tp[s])", flush=True)
    else:
        print(f"grid: dp={D} pipe={S} tp={T}, {world} ranks (rank = (d*{S} + s)*{T} + k)"
              + (f"; dp sync {grad_sync}" + (f" in buckets of {spec.bucket_bytes} bytes"
                                             if spec.bucket_bytes else "")
                 if D > 1 else ""), flush=True)
    run_dir = args.run_dir or os.path.join("runs", cfg.name)
    os.makedirs(run_dir, exist_ok=True)
    job = (args, cfg, spec, grad_sync, plan.to_dict() if plan is not None else None,
           transport)
    if torchrun or torch.distributed.is_initialized():
        return _join_job(job, transport, world)
    # ranks on the CPU share its cores
    threads = max(1, torch.get_num_threads() // world) if dev.type == "cpu" else None
    outs = ranks.spawn(_pipeline_rank, world, job,
                       workdir=os.path.join(run_dir, "ranks"),
                       transport=transport, timeout=RANK_TIMEOUT_S, threads=threads)
    return merge_rank_results(outs)


def merge_rank_results(outs):
    """The ranks' results of one pipeline run (what each rank returns, in
    rank order) as the launcher returns them: rank 0's, with each rank's
    peak memory, optimizer-state bytes, losses, grid position, ticks and
    collectives a step beside it, the largest peak, and the kernels'
    launches summed over the ranks."""
    res = dict(outs[0])
    res["peak_mem_bytes_per_rank"] = [o["peak_mem_bytes"] for o in outs]
    per_rank = [o["peak_mem_bytes"] for o in outs if o["peak_mem_bytes"] is not None]
    res["peak_mem_bytes"] = max(per_rank) if per_rank else None
    res["launches"] = {k: sum(o["launches"][k] for o in outs) for k in res["launches"]}
    for key in ("losses", "opt_state_bytes", "param_count", "grid", "ticks") + tuple(
            k + "_per_step" for k in STAT_KEYS):
        res[key + "_per_rank"] = [o[key] for o in outs]
    return res


def _export_obs(args, cfg, spec, plan, cost, executed, run_dir):
    """The ``--trace`` epilogue on rank 0 (DESIGN.md §14): the predicted
    timeline from the event simulator (of the plan where the cost model
    priced it, ``cost``; else of the spec in layer units), the executed
    one (``executed``, from ``obs.runtime.trace_pipeline``), their
    alignment report with its straggler sections (stages against
    ``cost``), all written next to ``metrics.jsonl``, and ``plan.json``
    when there is a plan.  Returns the run's trace summary:
    ``ticks_match``, ``max_abs_rel_err``, ``wall_s`` and the executed
    ``F`` and ``B`` seconds by stage."""
    from ..obs import align_traces, write_trace
    from ..obs.align import per_replica_seconds, per_stage_seconds
    from ..obs.straggler import replica_stragglers, stage_stragglers
    from ..obs.trace import predicted_trace_for_plan, predicted_trace_for_spec
    if cost is not None:
        predicted, _ = predicted_trace_for_plan(plan, cfg, args.seq, grad_sync=plan.dp > 1)
    else:
        predicted, _ = predicted_trace_for_spec(spec)
    report = align_traces(predicted, executed)
    stragglers = {}
    measured = per_stage_seconds(executed)
    if cost is not None:
        stragglers["stage"] = stage_stragglers(
            plan, cost, [measured[s] for s in sorted(measured)],
            factor=args.straggler_factor)
    if spec.data_parallel > 1:
        # expected ∝ allocations (one time a microbatch): the median
        # normalization makes the unit irrelevant
        per_rep = per_replica_seconds(executed)
        stragglers["replica"] = replica_stragglers(
            spec.batch_allocations, 1.0, [per_rep[r] for r in sorted(per_rep)],
            factor=args.straggler_factor)
    report["stragglers"] = stragglers
    write_trace(os.path.join(run_dir, "trace_predicted.json"), predicted)
    write_trace(os.path.join(run_dir, "trace_executed.json"), executed)
    if plan is not None:
        with open(os.path.join(run_dir, "plan.json"), "w", encoding="utf-8") as f:
            json.dump(plan.to_dict(), f, indent=2)
    with open(os.path.join(run_dir, "align.json"), "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    err = report["max_abs_rel_err"]
    wall = executed["metadata"]["wall_s"]
    print(f"trace: {run_dir}/trace_executed.json ticks={report['executed_ticks']} "
          f"(priced {report['priced_ticks']}, match={report['ticks_match']}) "
          f"wall={wall:.3f}s max_share_err={err if err is None else round(err, 4)}",
          flush=True)
    backward = per_stage_seconds(executed, kinds=("B",))
    S = spec.num_stages
    return {"ticks_match": report["ticks_match"], "max_abs_rel_err": err, "wall_s": wall,
            "stage_f_s": [measured.get(s, 0.0) for s in range(S)],
            "stage_b_s": [backward.get(s, 0.0) for s in range(S)]}


def _price_plan(plan_dict, cfg, args):
    """``(plan, cost, priced)``: the ``ParallelPlan`` of ``plan_dict``,
    its price under the cost model, and the meta row's priced fields (the
    plan's priced expectations ride in the meta row, so the drift and
    straggler reports are reproducible from the JSONL alone); all None
    and ``{}`` without a plan.  The one plan the cost model cannot price,
    per-leaf psum (``bucket_bytes`` 0, run only past
    ``--no-verify-plan``), gets no price and a ``priced_error``; any other
    pricing fault is raised."""
    if plan_dict is None:
        return None, None, {}
    from ..core.cost_model import ParallelPlan, evaluate
    plan = ParallelPlan.from_dict(plan_dict)
    try:
        cost = evaluate(plan, cfg, args.seq, args.batch * args.seq)
    except ValueError as e:
        if not (plan.dp_sync == "psum" and plan.bucket_bytes == 0):
            raise
        return plan, None, {"priced_error": str(e)}
    return plan, cost, {"priced_iter_time_s": cost.iter_time, "priced_tgs": cost.tgs,
                        "priced_exposed_sync_s": sum(cost.exposed_sync),
                        "priced_reshard_s": sum(cost.t_reshard)}


# a step's collectives by group (``Grid.counts``), seconds or bytes
STAT_KEYS = ("p2p_bytes", "p2p_s", "p2p_copy_s", "boundary_bytes", "boundary_s",
             "boundary_copy_s", "boundary_gather_bytes", "boundary_gather_s",
             "reduce_s", "tp_s", "dp_s", "dp_scatter_s", "dp_gather_s", "norm_s")


def _join_job(job, transport, world_size, rank_fn=None):
    """This process's rank of a job started outside the launcher: a
    ``torchrun`` job (joined here through ``env://``, on card
    ``LOCAL_RANK``), or a caller that has joined a process group already.
    Returns what the rank returns."""
    dist = torch.distributed
    own = not dist.is_initialized()
    if own:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        rank, world = dist.get_rank(), dist.get_world_size()
    if world != world_size:
        raise SystemExit(f"the job has {world} ranks for a grid of {world_size}")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if own:
        if transport == "device":
            torch.cuda.set_device(local_rank)
        ranks.init_group(rank, world, transport, "env://", RANK_TIMEOUT_S)
    elif dist.get_backend() != P2P.BACKENDS[transport]:
        raise SystemExit(f"the job's process group runs {dist.get_backend()}; "
                         f"--p2p {transport} needs {P2P.BACKENDS[transport]}")
    try:
        return (rank_fn or _pipeline_rank)(rank, world, *job, local_rank=local_rank)
    finally:
        if own:
            dist.destroy_process_group()


def _pipeline_rank(rank, world, args, cfg, spec, grad_sync, plan_dict, transport, *,
                   local_rank=None):
    """One rank's process: its (replica, stage, tp member) share of the
    seeded weights and optimizer state, its train step, the same batches
    as every other rank.  Rank 0 prints and logs to ``metrics.jsonl``;
    every other rank logs its steps and losses to ``rank<r>/metrics.jsonl``
    in the run directory.  Returns this rank's losses, step times, peak
    memory, optimizer-state bytes, kernel launches (counted from 0 in this
    process) and collectives a step, all of the timed steps alone; with
    ``--trace`` rank 0 also returns the trace summary (``_export_obs``) as
    ``trace`` and the timed traced pass's launches summed over the ranks
    as ``trace_launches`` (None elsewhere)."""
    import statistics

    from ..core import heteropp as HP
    from ..models import model as M
    from ..tree import tree_leaves
    base = devices.resolve(args.device)
    dev = P2P.rank_device(base, rank if local_rank is None else local_rank, transport)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if args.backend != "einsum":
            kbuild.load()
    S, D, b = spec.num_stages, spec.data_parallel, spec.microbatches
    total_mb = spec.total_microbatches
    grid = P2P.Grid.grouped(transport, dev, spec.stage_tp) if spec.grouped \
        else P2P.Grid.build(transport, dev, dp=D, pipe=S, tp=spec.tensor_parallel)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                           device=dev)
    local = HP.local_stage_params(params, cfg, spec, grid.s, grid.k)
    del params
    state = train_state_from(local, HP.stage_opt_state(local, spec, grid, grad_sync), 0)
    opt_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state.opt_state))
    step_fn = HP.make_pipeline_train_step(cfg, spec, grid, _opt(args),
                                          backend=args.backend, grad_sync=grad_sync)
    loader = make_loader(cfg, DataConfig(batch_size=args.batch, seq_len=args.seq,
                                         seed=1234 + args.seed), device=dev)
    tokens_per_step = args.batch * args.seq
    meta = {"arch": cfg.name, "family": cfg.family, "mode": "pipeline",
            "devices": world, "stages": S, "n_chunks": spec.n_chunks,
            "tensor_parallel": spec.tensor_parallel, "data_parallel": D,
            "stage_tp": list(spec.stage_tp), "reshard": list(spec.reshard),
            "batch_domain": list(spec.batch_domain),
            "grad_sync": grad_sync if D > 1 else None, "bucket_bytes": spec.bucket_bytes,
            "layers_per_stage": list(spec.layers_per_stage),
            "recompute": list(spec.recompute), "schedule": spec.schedule,
            "microbatches": b, "batch": args.batch, "seq": args.seq,
            "backend": args.backend, "device": str(dev), "p2p": transport,
            "plan": plan_dict, "rank": rank, "grid": [grid.d, grid.s, grid.k]}
    plan, cost, priced = _price_plan(plan_dict, cfg, args)
    meta.update(priced)
    run_dir = args.run_dir or os.path.join("runs", cfg.name)
    logger = MetricsLogger(run_dir if rank == 0 else os.path.join(run_dir, f"rank{rank}"),
                           meta=meta)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    losses, step_times, stats = [], [], []
    toks = None
    try:
        t0 = time.perf_counter()
        t_last, i_last = t0, 0
        for i in range(args.steps):
            toks = next(loader)["tokens"]
            # Σ allocations microbatches, replica-major (the tight layout)
            toks = toks.reshape(total_mb, args.batch // total_mb, args.seq)
            t1 = time.perf_counter()
            state, m = step_fn(state, toks)
            losses.append(float(m["loss"]))
            devices.synchronize(dev)
            step_times.append(time.perf_counter() - t1)
            stats.append(dict(step_fn.stats))
            if (i + 1) % args.log_every == 0 or i == 0:
                now = time.perf_counter()
                tps = tokens_per_step * (i + 1) / (now - t0)
                st = stats[-1]
                logger.log(step=i + 1, tokens_per_s=tps, tgs=tps / world,
                           step_time_s=(now - t_last) / (i + 1 - i_last),
                           peak_bytes_in_use=device_memory_highwater(dev),
                           loss=losses[-1], grad_norm=float(m["grad_norm"]),
                           lr=float(m["lr"]), **st)
                t_last, i_last = now, i + 1
                if rank == 0:
                    print(f"step {i + 1:5d} loss={losses[-1]:.4f} "
                          f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.2f} "
                          f"TGS={tps / world:.0f} "
                          f"p2p={(st['p2p_s'] + st['boundary_s']) * 1e3 / st['ticks']:.2f} "
                          f"ms/tick",
                          flush=True)
        # the timed steps' counts, before the traced passes
        launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
        peak = device_memory_highwater(dev)
        trace = trace_launches = None
        if args.trace:
            from ..obs.runtime import trace_pipeline
            if toks is None:
                toks = next(loader)["tokens"].reshape(total_mb, args.batch // total_mb,
                                                      args.seq)
            executed = trace_pipeline(cfg, spec, grid, state.params, toks,
                                      backend=args.backend)
            if rank == 0:
                trace = _export_obs(args, cfg, spec, plan, cost, executed, run_dir)
                trace_launches = {k: sum(r[k] for r in executed["metadata"]["launches"])
                                  for k in launches}
    finally:
        logger.close()
    if rank == 0 and stats:
        steady = lambda k: statistics.median([s[k] for s in stats[1:] or stats]) * 1e3
        p50 = statistics.median(step_times[1:] or step_times) * 1e3
        hops = ("boundary hops {:.1f} (host copies {:.1f}), boundary all-gather "
                "{:.1f}".format(steady("boundary_s"), steady("boundary_copy_s"),
                                steady("boundary_gather_s")) if spec.grouped else
                f"pipe hops {steady('p2p_s'):.1f} (host copies {steady('p2p_copy_s'):.1f})")
        print(f"summary (rank 0): p50 {p50:.1f} ms over steps 2-{len(stats)}; "
              f"collectives in ms/step: {hops}, tp all-reduce {steady('tp_s'):.1f}, "
              f"dp all-reduce {steady('dp_s'):.1f}, dp reduce-scatter "
              f"{steady('dp_scatter_s'):.1f}, dp all-gather {steady('dp_gather_s'):.1f}, "
              f"replicated all-reduce {steady('reduce_s'):.1f}, clip norm "
              f"{steady('norm_s'):.1f}", flush=True)
    ticks = stats[-1]["ticks"] if stats else 0
    out = {"arch": cfg.name, "num_layers": cfg.num_layers, "losses": losses,
           "step_times_s": step_times, "tokens_per_step": tokens_per_step,
           "peak_mem_bytes": peak, "mode": "pipeline", "launches": launches,
           "trace_launches": trace_launches, "trace": trace,
           "ticks": ticks, "opt_state_bytes": opt_bytes,
           "param_count": sum(t.numel() for t in tree_leaves(state.params)),
           "rank": rank, "grid": [grid.d, grid.s, grid.k], "device": str(dev)}
    for key in STAT_KEYS:
        out[key + "_per_step"] = [s[key] for s in stats]
    return out


if __name__ == "__main__":
    main()
