"""End-to-end serving example (the counterpart of
``examples/serve_batch.py``): batched requests with greedy decode against
a shared KV / SSM cache, on an arch's smoke config.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch \\
        [--arch mamba2_780m] [--requests 8] [--prompt-len 64] [--gen 48] \\
        [--device cuda|cpu] [--backend auto|einsum|kernel]

Runs on the card unless ``--device cpu`` is given, and raises without
one.  Prefill and decode are timed on the host's clock after a device
synchronise.  A vlm model's linear cache also holds its image prefix
(``launch.serve.serve_cache_len``), which the JAX example leaves out.
:func:`run` returns the prefill's logits, the generated tokens and the
times; a caller may give it the weights (``params``), drawn from seed 0
otherwise.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import device as devices
from ..configs import get_smoke_config, list_configs
from ..data.pipeline import DataConfig, SyntheticTokens
from ..kernels import build as kbuild
from ..kernels.ops import BACKENDS
from ..launch.serve import serve_cache_len
from ..models import model as M
from ..training import serve_step as SS


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_780m", choices=list_configs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--device", default="cuda", choices=devices.DEVICES)
    ap.add_argument("--backend", default="auto", choices=BACKENDS)
    return ap.parse_args(argv)


def run(args, *, params=None) -> dict:
    dev = devices.resolve(args.device)
    if dev.type == "cuda" and args.backend != "einsum":
        kbuild.load()
    cfg = get_smoke_config(args.arch)
    total = args.prompt_len + args.gen
    with torch.no_grad():
        if params is None:
            params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                   device=dev)
        src = SyntheticTokens(cfg, DataConfig(batch_size=args.requests,
                                              seq_len=args.prompt_len))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in src.next_batch().items()}

        decode, plan = SS.make_decode_step(cfg, total, backend=args.backend)
        print(f"{cfg.name}: {args.requests} requests, cache plan {plan}")

        devices.synchronize(dev)
        t0 = time.perf_counter()
        cache, logits, plen = M.prefill(params, cfg, batch,
                                        cache_len=serve_cache_len(cfg, plan, total),
                                        backend=args.backend)
        devices.synchronize(dev)
        t_prefill = time.perf_counter() - t0
        print(f"prefill {args.requests}x{args.prompt_len} tokens: "
              f"{t_prefill * 1e3:.0f} ms")

        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        outs = [tok]
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            _, tok, cache = decode(params, cache, tok, plen + i)
            outs.append(tok)
        devices.synchronize(dev)
        dt = time.perf_counter() - t0
    gen = torch.cat(outs, 1)
    tok_s = args.requests * args.gen / dt
    print(f"decoded {args.requests}x{args.gen} tokens in {dt * 1e3:.0f} ms "
          f"({tok_s:.0f} tok/s)")
    for r in range(min(args.requests, 3)):
        print(f"  request {r}: {gen[r, :12].tolist()}...")
    return {"arch": cfg.name, "num_layers": cfg.num_layers, "prefill_logits": logits,
            "tokens": gen, "prefill_s": t_prefill, "decode_s": dt,
            "decode_tok_per_s": tok_s}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
