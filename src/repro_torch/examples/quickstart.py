"""Quickstart (the counterpart of ``examples/quickstart.py``): build a
model from the config registry, run a forward pass, take one training
step, and serve a few tokens, on an arch's smoke config.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--arch granite_8b] [--device cuda|cpu] [--backend auto|einsum|kernel]

Runs on the card unless ``--device cpu`` is given, and raises without
one.  ``--backend`` as the launchers': ``auto`` takes the CUDA kernels
on the card.  :func:`run` returns the forward's logits, the step's loss
and the served tokens; a caller may give it the weights (``params`` for
the forward and the serving, ``state`` for the step), which are drawn
from seed 0 otherwise.
"""
from __future__ import annotations

import argparse

import torch

from .. import device as devices
from ..configs import get_smoke_config, list_configs
from ..data.pipeline import DataConfig, SyntheticTokens
from ..kernels import build as kbuild
from ..kernels.ops import BACKENDS
from ..models import model as M
from ..training.train_step import make_train_state, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_8b", choices=list_configs())
    ap.add_argument("--device", default="cuda", choices=devices.DEVICES)
    ap.add_argument("--backend", default="auto", choices=BACKENDS)
    return ap.parse_args(argv)


def run(args, *, params=None, state=None) -> dict:
    dev = devices.resolve(args.device)
    if dev.type == "cuda" and args.backend != "einsum":
        kbuild.load()

    # 1. every assigned architecture is a config; smoke = reduced variant
    cfg = get_smoke_config(args.arch)
    print(f"{cfg.name}: family={cfg.family} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} params={cfg.param_count():,}")

    # 2. params are a nested dict of tensors, forward is a function
    if params is None:
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    src = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=64))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in src.next_batch().items()}
    with torch.no_grad():
        logits, _ = M.forward(params, cfg, batch, remat=False, backend=args.backend)
    print(f"forward: logits {tuple(logits.shape)}")

    # 3. one training step (AdamW, fp32 master weights); the step updates
    # the state in place
    if state is None:
        state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                                 device=dev)
    step = make_train_step(cfg, remat=False, backend=args.backend)
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    print(f"train step: loss={loss:.4f}")

    # 4. serve: prefill a prompt, decode 8 tokens greedily
    with torch.no_grad():
        prompt = {k: v[:, :32] if k == "tokens" else v for k, v in batch.items()}
        cache, lg, plen = M.prefill(params, cfg, prompt, cache_len=48, backend=args.backend)
        out = [torch.argmax(lg, -1).to(torch.int32)[:, None]]
        for i in range(7):
            lg, cache = M.decode_step(params, cfg, out[-1], cache, plen + i,
                                      backend=args.backend)
            out.append(torch.argmax(lg, -1).to(torch.int32)[:, None])
    tokens = torch.cat(out, 1)
    print("decoded:", tokens[0].tolist())
    return {"arch": cfg.name, "num_layers": cfg.num_layers, "logits": logits,
            "loss": loss, "tokens": tokens}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
