"""End-to-end training example (the counterpart of ``examples/train_e2e.py``,
deliverable b): train a ~100M-parameter model for a few hundred steps on
the synthetic structured stream with checkpointing and a resume check.
The default invocation is CPU-sized; ``--full-100m`` takes the
~100M-parameter variant the deliverable names.

    PYTHONPATH=src python -m repro_torch.examples.train_e2e --device cpu   # ~20M
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --full-100m --steps 300

Runs on the card unless ``--device cpu`` is given, and raises without
one.  Checkpoints go every 50 steps and at the end to ``--ckpt``, by
default a fresh temporary directory removed afterwards.  The resume
check restores the last checkpoint into a state of its own
(``abstract_train_state``: the port's step updates its state in place,
where the JAX step returns a new one), then takes one step on the live
state and one on the restored state from the same batch; the two losses
must agree to 1e-5.  :func:`run` returns the losses, the resume check's
pair, each step's seconds, tokens/s over them (checkpoints left out) and
the peak memory; a caller may give it the
initial ``state``, drawn from seed 0 otherwise.
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
import time

import torch

from .. import device as devices
from ..checkpointing.io import load_checkpoint, save_checkpoint
from ..data.pipeline import DataConfig, make_loader
from ..kernels import build as kbuild
from ..kernels.ops import BACKENDS
from ..models.config import ModelConfig
from ..obs.runtime import device_memory_highwater
from ..optim.adamw import AdamWConfig
from ..training.train_step import (abstract_train_state, make_train_state,
                                   make_train_step)

RESUME_ATOL = 1e-5
MIN_DROP = 0.5          # the loss drop over the run below which it warns
CKPT_EVERY = 50


def model_config(full: bool) -> ModelConfig:
    if full:  # ~100M params (GPT-small-ish llama)
        return ModelConfig(name="e2e-100m", family="dense", num_layers=12,
                           d_model=768, num_heads=12, num_kv_heads=4,
                           d_ff=2048, vocab_size=32000, dtype="float32")
    return ModelConfig(name="e2e-20m", family="dense", num_layers=6,
                       d_model=384, num_heads=6, num_kv_heads=2,
                       d_ff=1024, vocab_size=8192, dtype="float32")


def optimizer_config(steps: int) -> AdamWConfig:
    return AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=steps)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a fresh temporary one)")
    ap.add_argument("--device", default="cuda", choices=devices.DEVICES)
    ap.add_argument("--backend", default="auto", choices=BACKENDS)
    return ap.parse_args(argv)


def run(args, *, state=None) -> dict:
    dev = devices.resolve(args.device)
    if dev.type == "cuda" and args.backend != "einsum":
        kbuild.load()
    cfg = model_config(args.full_100m)
    print(f"{cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} tokens")

    if state is None:
        state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                                 device=dev)
    step = make_train_step(cfg, optimizer_config(args.steps), remat=True,
                           backend=args.backend)
    tokens = args.batch * args.seq
    losses, step_times = [], []
    with contextlib.ExitStack() as stack:
        ckpt = args.ckpt or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="repro_torch_e2e_"))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        loader = make_loader(cfg, DataConfig(batch_size=args.batch, seq_len=args.seq),
                             device=dev)
        try:
            t0 = time.perf_counter()
            for i in range(args.steps):
                batch = next(loader)
                t1 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))          # waits for the step
                step_times.append(time.perf_counter() - t1)
                if (i + 1) % 20 == 0:
                    tgs = tokens * (i + 1) / (time.perf_counter() - t0)
                    print(f"step {i + 1:4d} loss={losses[-1]:.4f} TGS={tgs:.0f}")
                if (i + 1) % CKPT_EVERY == 0:
                    save_checkpoint(ckpt, state, step=i + 1)
        finally:
            loader.close()
        peak = device_memory_highwater(dev)
        save_checkpoint(ckpt, state, step=args.steps)

        # resume check: the restored state reproduces the same loss
        restored = load_checkpoint(ckpt, abstract_train_state(cfg), device=dev)
    src2 = make_loader(cfg, DataConfig(batch_size=args.batch, seq_len=args.seq, seed=99),
                       device=dev)
    try:
        b = next(src2)
    finally:
        src2.close()
    _, m1 = step(state, b)
    _, m2 = step(restored, b)
    resume = (float(m1["loss"]), float(m2["loss"]))
    print(f"resume check: loss {resume[0]:.6f} == {resume[1]:.6f}")
    if abs(resume[0] - resume[1]) >= RESUME_ATOL:
        raise RuntimeError(f"resume check: the restored state's loss {resume[1]} is "
                           f"not the live state's {resume[0]}")

    drop = losses[0] - min(losses[-10:])
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} (drop {drop:.2f}) "
          f"{'OK' if drop > MIN_DROP else 'WARN: little learning'}")
    return {"name": cfg.name, "num_layers": cfg.num_layers, "losses": losses,
            "resume": resume, "drop": drop, "step_times_s": step_times,
            "tokens_per_s": tokens * args.steps / sum(step_times), "peak_mem_bytes": peak}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
