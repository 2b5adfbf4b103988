"""Training launcher, single device (the counterpart of the single-device
path of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_780m \\
        --steps 50 --batch 8 --seq 256 [--backend auto|einsum|kernel] \\
        [--device cuda|cpu] [--smoke] [--ckpt-dir DIR --ckpt-every N]

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

The pipeline flags of the JAX launcher (HeteroPP) are accepted and
refused: they wait for the HeteroPP slice of the port.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from .. import device as devices
from ..checkpointing.io import (checkpoint_step, load_checkpoint,
                                save_checkpoint)
from ..configs import canonical, get_config, get_smoke_config, list_configs
from ..data.pipeline import DataConfig, make_loader
from ..kernels import build as kbuild
from ..kernels.ops import BACKENDS
from ..obs.metrics import MetricsLogger
from ..obs.runtime import device_memory_highwater
from ..optim.adamw import AdamWConfig
from ..training.train_step import make_train_state, make_train_step


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
                    help="not ported yet (HeteroPP slice)")
    for flag in ("--tensor-parallel", "--data-parallel"):
        ap.add_argument(flag, type=int, default=0,
                        help="not ported yet (HeteroPP slice)")
    for flag in ("--plan", "--search"):
        ap.add_argument(flag, default=None, help="not ported yet (HeteroPP slice)")
    ap.add_argument("--trace", action="store_true",
                    help="not ported yet (HeteroPP slice)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    given = [flag for flag, on in (
        ("--pipeline-parallel", args.pipeline_parallel > 1),
        ("--plan", args.plan), ("--search", args.search),
        ("--tensor-parallel", args.tensor_parallel),
        ("--data-parallel", args.data_parallel), ("--trace", args.trace)) if on]
    if given:
        raise SystemExit(f"{' '.join(given)}: the pipeline runtime (HeteroPP) "
                         "is not ported to repro_torch yet; it waits for the "
                         "HeteroPP slice (ROADMAP)")
    dev = devices.resolve(args.device)
    name = canonical(args.arch)
    cfg = get_smoke_config(name) if args.smoke else get_config(name)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params~{cfg.param_count() / 1e6:.1f}M devices=1 ({dev})", flush=True)
    if dev.type == "cuda" and args.backend != "einsum":
        t0 = time.perf_counter()
        kbuild.load()                    # set-up, kept out of the step times
        print(f"kernels ready: {time.perf_counter() - t0:.1f} s")

    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 5))
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


if __name__ == "__main__":
    main()
