"""Training launcher (the counterpart of ``repro/launch/train.py``): one
device, or the HeteroPP pipeline with one process a stage.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_780m \\
        --steps 50 --batch 8 --seq 256 [--backend auto|einsum|kernel] \\
        [--device cuda|cpu] [--smoke] [--ckpt-dir DIR --ckpt-every N] \\
        [--pipeline-parallel N [--schedule 1f1b] [--microbatches B] \\
         | --plan plan.json | --search A:1,B:1] [--p2p device|host]

Runs on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises.  ``--backend`` picks the kernel
path: ``auto`` takes the CUDA kernels (``flash_attention``,
``ssd_scan``) on the card and the plain paths on the CPU; ``kernel``
forces them (and raises on the CPU).  Weights are random, drawn from
``--seed``; data is the ``SyntheticTokens`` stream of the JAX launcher.
Prints ``arch=… family=… params~…M devices=…`` and every
``--log-every`` steps ``step N loss=… lr=… gnorm=… TGS=…``, with the
same row in ``<run-dir>/metrics.jsonl``.  ``main`` also returns the
per-step losses and times to a caller in Python.

``--pipeline-parallel N`` trains through ``core.heteropp`` on N ranks,
one a physical stage, under ``--schedule`` (default 1f1b) with
``--microbatches`` microbatches (default N), the layers split evenly;
``--plan plan.json`` runs a saved HeteroAuto ``ParallelPlan``
(``ParallelPlan.to_dict`` JSON: its schedule, stages, non-uniform layer
split and per-stage recompute), and ``--search CHIP:N,...`` runs the
HeteroAuto search on that cluster first and trains the winner.  A plan
passes the copied static verifier first (``--no-verify-plan`` skips
it).  The launcher starts its own ranks (``launch.ranks.spawn``, a
``FileStore`` in the run directory), or runs one rank of a job
started outside it: a ``torchrun`` job when its environment names one
(the card is ``LOCAL_RANK``), or the process group its caller has
joined.  ``--p2p`` names the stage-to-stage
transport: ``device`` (NCCL, one card a rank; the default) or ``host``
(gloo through host memory: the CPU, or several ranks on one card).
Rank 0 prints the step lines and writes ``metrics.jsonl`` with ``"mode":
"pipeline"``.  Tensor and data parallelism (``--tensor-parallel``,
``--data-parallel``) and ``--trace`` are refused: they wait for ROADMAP
A8(d), A8(e) and A14.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .. import device as devices
from ..checkpointing.io import (checkpoint_step, load_checkpoint,
                                save_checkpoint)
from ..comm import p2p as P2P
from ..configs import canonical, get_config, get_smoke_config, list_configs
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
    ap.add_argument("--no-verify-plan", action="store_true",
                    help="skip the static plan verifier for --plan/--search")
    ap.add_argument("--p2p", default=None, choices=P2P.TRANSPORTS,
                    help="pipeline stage-to-stage transport: device (NCCL, "
                         "one card a rank; the default) or host (gloo "
                         "through host memory: the CPU, or ranks sharing a "
                         "card)")
    ap.add_argument("--tensor-parallel", type=int, default=0,
                    help="not ported yet (ROADMAP A8(d))")
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="not ported yet (ROADMAP A8(e))")
    ap.add_argument("--trace", action="store_true",
                    help="not ported yet (ROADMAP A14)")
    return ap.parse_args(argv)


def _refuse(args, pipeline: bool) -> None:
    """Flags the chosen path would not honour exit with a message."""
    unported = [(flag, item) for flag, on, item in (
        ("--tensor-parallel", args.tensor_parallel, "A8(d)"),
        ("--data-parallel", args.data_parallel, "A8(e)"),
        ("--trace", args.trace, "A14")) if on]
    if unported:
        raise SystemExit(
            "; ".join(f"{flag}: not ported to repro_torch yet (ROADMAP {item})"
                      for flag, item in unported)
            + ". The port's HeteroPP runs the pipe axis only")
    if not pipeline:
        given = [flag for flag, on in (
            ("--schedule", args.schedule), ("--microbatches", args.microbatches),
            ("--p2p", args.p2p), ("--no-verify-plan", args.no_verify_plan)) if on]
        if given:
            raise SystemExit(f"{' '.join(given)} only apply to the pipeline; "
                             "add --pipeline-parallel N, --plan or --search")
        return
    if args.plan and args.search:
        raise SystemExit("--plan and --search are mutually exclusive")
    if args.plan or args.search:
        src = "--plan" if args.plan else "--search"
        if args.schedule is not None:
            raise SystemExit(f"{src} uses the plan's schedule; drop "
                             f"--schedule {args.schedule}")
        if args.pipeline_parallel > 1:
            raise SystemExit(f"{src} sets the stage count from the plan; "
                             f"drop --pipeline-parallel")
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
                              backend=args.backend)
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
    losses, step_times = [], []
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
            "step_times_s": step_times, "tokens_per_step": tokens_per_step,
            "peak_mem_bytes": device_memory_highwater(dev), "state": state}


def _opt(args) -> AdamWConfig:
    return AdamWConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 5))


# ---------------------------------------------------------------------------
# the HeteroPP pipeline
# ---------------------------------------------------------------------------

def pipeline_spec(args, cfg):
    """The PipelineSpec to train, and the plan it came from (or None):
    from ``--plan``, a fresh ``--search``, or the even split of
    ``--pipeline-parallel``.  Plans pass the static verifier first."""
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
            return HP.from_plan(plan, microbatches=mb, execute_tp=True,
                                execute_dp=True, verify=False), plan
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
        r = heteroauto.search(groups, cfg, args.batch * args.seq, args.seq,
                              two_stage=False, dp_candidates=[1])
        if r.plan is None:
            raise SystemExit(f"--search {args.search}: no feasible plan for "
                             f"{cfg.name}")
        print(f"searched plan ({r.evaluated} configs, {r.search_time_s:.2f}s): "
              f"{r.plan.describe()} [{r.runtime}]")
        return _from_plan(r.plan)
    from ..core.schedules import get_schedule
    pp = args.pipeline_parallel
    sched = get_schedule(args.schedule or "1f1b")
    base, rem = divmod(cfg.num_layers, pp)
    phys = [base + (1 if i < rem else 0) for i in range(pp)]
    try:
        return HP.PipelineSpec(pp, HP.chunk_layer_counts(phys, sched),
                               microbatches=mb or pp, schedule=sched.name,
                               n_chunks=sched.n_chunks), None
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e)) from None


def run_pipeline(args, cfg, dev):
    """Train through the pipeline: checks, then one rank a stage (spawned
    here, or this process's rank of a job started outside the launcher).
    Returns rank 0's results: what the single-device path returns but the
    state, which stays in the ranks, and the tick program's exchanges;
    when spawned here also each rank's peak memory and exchanges, and the
    kernels' launches summed over the ranks."""
    from ..core.heteropp import pipeline_block_kind
    try:
        pipeline_block_kind(cfg)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    spec, plan = pipeline_spec(args, cfg)
    transport = args.p2p or "device"
    S = spec.num_stages
    env = os.environ
    torchrun = all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    try:
        P2P.check_transport(transport, dev, int(env.get("LOCAL_WORLD_SIZE", S))
                            if torchrun else S)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if spec.total_layers != cfg.num_layers:
        raise SystemExit(f"plan covers {spec.total_layers} layers but "
                         f"{cfg.name} has {cfg.num_layers}")
    if args.batch % spec.microbatches:
        raise SystemExit(f"--batch {args.batch} not divisible by "
                         f"{spec.microbatches} microbatches")
    print(f"arch={cfg.name} family={cfg.family} "
          f"params~{cfg.param_count() / 1e6:.1f}M devices={S} ({dev}, p2p "
          f"{transport})", flush=True)
    print(f"pipeline: stages={S} v={spec.n_chunks} "
          f"layers/global-stage={spec.layers_per_stage} "
          f"recompute={spec.recompute} microbatches={spec.microbatches} "
          f"schedule={spec.schedule}", flush=True)
    run_dir = args.run_dir or os.path.join("runs", cfg.name)
    os.makedirs(run_dir, exist_ok=True)
    job = (args, cfg, spec, plan.to_dict() if plan is not None else None,
           transport)
    if torchrun or torch.distributed.is_initialized():
        return _join_job(job, transport, S)
    # ranks on the CPU share its cores
    threads = max(1, torch.get_num_threads() // S) if dev.type == "cpu" else None
    outs = ranks.spawn(_pipeline_rank, S, job,
                       workdir=os.path.join(run_dir, "ranks"),
                       transport=transport, timeout=RANK_TIMEOUT_S, threads=threads)
    res = dict(outs[0])
    res["peak_mem_bytes_per_rank"] = [o["peak_mem_bytes"] for o in outs]
    per_rank = [o["peak_mem_bytes"] for o in outs if o["peak_mem_bytes"] is not None]
    res["peak_mem_bytes"] = max(per_rank) if per_rank else None
    res["launches"] = {k: sum(o["launches"][k] for o in outs) for k in res["launches"]}
    for key in ("p2p_s_per_step", "p2p_copy_s_per_step", "reduce_s_per_step"):
        res[key + "_per_rank"] = [o[key] for o in outs]
    return res


def _join_job(job, transport, S):
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
    if world != S:
        raise SystemExit(f"the job has {world} ranks for {S} stages")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if own:
        if transport == "device":
            torch.cuda.set_device(local_rank)
        ranks.init_group(rank, world, transport, "env://", RANK_TIMEOUT_S)
    elif dist.get_backend() != P2P.BACKENDS[transport]:
        raise SystemExit(f"the job's process group runs {dist.get_backend()}; "
                         f"--p2p {transport} needs {P2P.BACKENDS[transport]}")
    try:
        return _pipeline_rank(rank, world, *job, local_rank=local_rank)
    finally:
        if own:
            dist.destroy_process_group()


def _pipeline_rank(rank, world, args, cfg, spec, plan_dict, transport, *,
                   local_rank=None):
    """One stage's process: its share of the seeded weights, its train
    step, the same batches as every other rank.  Rank 0 prints and logs.
    Returns this rank's losses, step times, peak memory, kernel launches
    (counted from 0 in this process) and exchanges a step."""
    from ..core import heteropp as HP
    from ..models import model as M
    base = devices.resolve(args.device)
    dev = P2P.rank_device(base, rank if local_rank is None else local_rank, transport)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if args.backend != "einsum":
            kbuild.load()
    p2p = P2P.P2P(transport, dev)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                           device=dev)
    local = HP.local_stage_params(params, cfg, spec, rank)
    del params
    state = train_state_from(local, adamw.init_opt_state(local), 0)
    step_fn = HP.make_pipeline_train_step(cfg, spec, p2p, _opt(args),
                                          backend=args.backend)
    loader = make_loader(cfg, DataConfig(batch_size=args.batch, seq_len=args.seq,
                                         seed=1234 + args.seed), device=dev)
    b = spec.microbatches
    tokens_per_step = args.batch * args.seq
    meta = {"arch": cfg.name, "family": cfg.family, "mode": "pipeline",
            "devices": world, "stages": spec.num_stages, "n_chunks": spec.n_chunks,
            "layers_per_stage": list(spec.layers_per_stage),
            "recompute": list(spec.recompute), "schedule": spec.schedule,
            "microbatches": b, "batch": args.batch, "seq": args.seq,
            "backend": args.backend, "device": str(dev), "p2p": transport,
            "plan": plan_dict}
    logger = MetricsLogger(args.run_dir or os.path.join("runs", cfg.name),
                           meta=meta) if rank == 0 else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    losses, step_times, stats = [], [], []
    try:
        t0 = time.perf_counter()
        t_last, i_last = t0, 0
        for i in range(args.steps):
            toks = next(loader)["tokens"]
            toks = toks.reshape(b, args.batch // b, args.seq)
            t1 = time.perf_counter()
            state, m = step_fn(state, toks)
            losses.append(float(m["loss"]))
            devices.synchronize(dev)
            step_times.append(time.perf_counter() - t1)
            stats.append(dict(step_fn.stats))
            if logger is not None and ((i + 1) % args.log_every == 0 or i == 0):
                now = time.perf_counter()
                tps = tokens_per_step * (i + 1) / (now - t0)
                st = stats[-1]
                logger.log(step=i + 1, tokens_per_s=tps, tgs=tps / world,
                           step_time_s=(now - t_last) / (i + 1 - i_last),
                           peak_bytes_in_use=device_memory_highwater(dev),
                           loss=losses[-1], grad_norm=float(m["grad_norm"]),
                           lr=float(m["lr"]), ticks=st["ticks"],
                           p2p_bytes=st["p2p_bytes"], p2p_s=st["p2p_s"],
                           p2p_copy_s=st["p2p_copy_s"], reduce_s=st["reduce_s"])
                t_last, i_last = now, i + 1
                print(f"step {i + 1:5d} loss={losses[-1]:.4f} "
                      f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.2f} "
                      f"TGS={tps / world:.0f} p2p={st['p2p_s'] * 1e3 / st['ticks']:.2f} "
                      f"ms/tick", flush=True)
    finally:
        if logger is not None:
            logger.close()
    ticks = stats[-1]["ticks"] if stats else 0
    return {"arch": cfg.name, "num_layers": cfg.num_layers, "losses": losses,
            "step_times_s": step_times, "tokens_per_step": tokens_per_step,
            "peak_mem_bytes": device_memory_highwater(dev), "mode": "pipeline",
            "launches": {fn.__name__: fn.launches for fn in ops.KERNELS},
            "ticks": ticks, "p2p_bytes_per_step": [s["p2p_bytes"] for s in stats],
            "p2p_s_per_step": [s["p2p_s"] for s in stats],
            "p2p_copy_s_per_step": [s["p2p_copy_s"] for s in stats],
            "reduce_s_per_step": [s["reduce_s"] for s in stats],
            "rank": rank, "device": str(dev)}


if __name__ == "__main__":
    main()
