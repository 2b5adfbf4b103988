#!/usr/bin/env python
"""Loss curves of qwen1.5-0.5b's smoke model under fp32, bf16 and fp16 on
the CPU, in the JAX package or in the PyTorch port (one package a run:
the port's run imports no JAX), each regime's MRE against fp32, and the
share of the tied embedding's rows whose gradient on the first batch is
exactly zero.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/fp16_curves.py --package repro
    PYTHONPATH=src python tools/fp16_curves.py --package repro_torch \\
        [--vocab 151936] [--batch 4] [--seq 512] [--iters 50]

Each package trains from its own seed-0 weights on the ``SyntheticTokens``
stream (seed 1234), as its ``precision.align.train_loss_curve`` does.
``--vocab`` replaces the smoke vocabulary (512): at qwen1.5-0.5b's 151936
and 2048 tokens a batch, the logits' gradient p_j / N rounds to zero in
fp16 for every token absent from the batch (no loss scaling in either
package).  Prints one line a regime and a last JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

DTYPES = ("float32", "bfloat16", "float16")


def reference(cfg, args):
    import jax
    import jax.numpy as jnp
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.models import model as M
    from repro.precision import align

    batch = SyntheticTokens(cfg, DataConfig(batch_size=args.batch, seq_len=args.seq,
                                            seed=1234)).next_batch()

    def zero_rows(dtype):
        mcfg = dataclasses.replace(cfg, dtype=dtype)
        params = M.init_params(mcfg, jax.random.PRNGKey(0))
        grad = jax.grad(lambda p: M.loss_fn(p, mcfg, {k: jnp.asarray(v) for k, v in
                                                      batch.items()}, remat=False)[0])
        g = np.asarray(grad(params)["embed"]["tok"].astype(jnp.float32))
        return float((np.abs(g).max(-1) == 0).mean())

    curve = lambda dtype: align.train_loss_curve(cfg, dtype=dtype, iters=args.iters,
                                                 batch=args.batch, seq=args.seq)
    return curve, zero_rows, align.loss_mre


def port(cfg, args):
    import torch
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig
    from repro_torch.precision import align

    cfg = ModelConfig(**dataclasses.asdict(cfg))
    dev = torch.device("cpu")

    def zero_rows(dtype):
        mcfg = dataclasses.replace(cfg, dtype=dtype)
        params = M.init_params(mcfg, torch.Generator().manual_seed(0), device=dev)
        leaf = params["embed"]["tok"].requires_grad_()
        batch = next(make_loader(mcfg, DataConfig(batch_size=args.batch, seq_len=args.seq,
                                                  seed=1234), device=dev))
        loss, _ = M.loss_fn(params, mcfg, batch, remat=False)
        g = torch.autograd.grad(loss, leaf)[0]
        return float((g.abs().amax(-1) == 0).float().mean())

    curve = lambda dtype: align.train_loss_curve(cfg, dtype=dtype, iters=args.iters,
                                                 batch=args.batch, seq=args.seq,
                                                 device=dev)
    return curve, zero_rows, align.loss_mre


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("repro", "repro_torch"), required=True)
    ap.add_argument("--vocab", type=int, default=0, help="0: the smoke vocabulary")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if args.package == "repro":
        from repro.configs import get_smoke_config
    else:
        from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen1p5_0p5b")
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab_size=args.vocab)
    curve, zero_rows, loss_mre = (reference if args.package == "repro" else port)(cfg, args)
    curves, out = {}, {"package": args.package, "vocab": cfg.vocab_size,
                       "batch": args.batch, "seq": args.seq, "iters": args.iters}
    for dtype in DTYPES:
        t0 = time.perf_counter()
        curves[dtype] = curve(dtype)
        out[dtype] = {"first": float(curves[dtype][0]), "last": float(curves[dtype][-1]),
                      "mre": loss_mre(curves[dtype], curves["float32"]),
                      "zero_grad_rows": zero_rows(dtype)}
        print(f"{dtype:9s} {time.perf_counter() - t0:.1f} s  {json.dumps(out[dtype])}  "
              f"every 10th: {' '.join(f'{x:.4f}' for x in curves[dtype][::10])}",
              flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
