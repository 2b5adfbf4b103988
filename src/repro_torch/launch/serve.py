"""Serving launcher: batched prefill + greedy decode loop (the
counterpart of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_8b \\
        --batch 4 --prompt-len 512 --gen 32 [--backend auto|einsum|kernel] \\
        [--device cuda|cpu] [--smoke]

Runs on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises; on the card a model whose shapes the
kernels would refuse exits naming the rule (``analysis.card_lint``)
before any weights are built.  ``--backend`` picks the attention
path for both prefill and decode: ``auto`` takes the CUDA kernels
(``flash_attention``, ``flash_decode``; ``ssd_scan`` in an ssm prefill)
on the card and the plain paths on the CPU; ``kernel`` forces the
kernels (and raises on the CPU).  An ssm model decodes with the
recurrent update (no kernel, no KV cache); a hybrid one (zamba2) takes
the recurrent update in its ssm layers and ``flash_decode`` in its
shared attention block.  A vlm model (paligemma) takes the batch's
``image_embeds`` (the stub frontend's P image tokens) as a bidirectional
prefix: its linear cache holds P + prompt + gen slots, and decode starts
at position P + prompt.
Weights are random, drawn from ``--seed``.  Decode reports per-step
p50/p95 latency and tokens/s; the same numbers land as histogram/gauge
rows in ``<run-dir>/metrics.jsonl``.  ``main`` also returns them, with
the generated tokens and the last logits, to a caller in Python.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from .. import device as devices
from ..analysis import card_lint
from ..configs import canonical, get_config, get_smoke_config, list_configs
from ..data.pipeline import DataConfig, SyntheticTokens
from ..kernels import build as kbuild
from ..kernels.ops import BACKENDS
from ..models import model as M
from ..obs.metrics import MetricsLogger, MetricsRegistry
from ..training import serve_step as SS
from ..tree import tree_map


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--backend", default="auto", choices=BACKENDS,
                    help="attention path: auto (CUDA kernels on the card, "
                         "plain PyTorch on the CPU), einsum, or kernel "
                         "(forced; raises on the CPU)")
    ap.add_argument("--device", default="cuda", choices=devices.DEVICES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--run-dir", default=None,
                    help="write decode latency histogram / tok-s rows to "
                         "<run-dir>/metrics.jsonl (default runs/<arch>)")
    ap.add_argument("--log-every", type=int, default=0,
                    help="also emit an interim decode histogram row "
                         "every N decode steps (0 = final row only)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = devices.resolve(args.device)
    name = canonical(args.arch)
    cfg = get_smoke_config(name) if args.smoke else get_config(name)
    card_lint.refuse_on_card(cfg, dev, args.backend, seq_len=args.prompt_len)
    total = args.prompt_len + args.gen
    print(f"serving {cfg.name}: batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} backend={args.backend} "
          f"device={dev}")

    with MetricsLogger(
            args.run_dir or os.path.join("runs", cfg.name),
            meta={"arch": cfg.name, "family": cfg.family, "mode": "serve",
                  "batch": args.batch, "prompt_len": args.prompt_len,
                  "gen": args.gen, "backend": args.backend,
                  "device": str(dev)}) as metrics:
        result = _serve(args, dev, cfg, total, metrics)
    print(f"generated[0][:16] = {result['tokens'][0, :16].tolist()}")
    return result


def serve_cache_len(cfg, plan, total):
    """The prefill's cache length: the plan's, at least the prompt and the
    generated tokens, and on a linear cache a vlm model's image prefix
    too, as ``training/serve_step.py::make_prefill_step`` sizes it.  The
    JAX launcher leaves the prefix out (ROADMAP C), so its update raises
    or clamps a decode position past the cache's end, and the port's
    linear cache would raise."""
    n = max(plan["cache_len"], total)
    return n if plan["ring"] else n + cfg.num_prefix_tokens


def _serve(args, dev, cfg, total, metrics):
    reg = MetricsRegistry()
    if dev.type == "cuda" and args.backend != "einsum":
        t0 = time.perf_counter()
        kbuild.load()                    # set-up, kept out of the prefill time
        print(f"kernels ready: {time.perf_counter() - t0:.1f} s")

    with torch.inference_mode():
        gen_rng = torch.Generator(device=dev).manual_seed(args.seed)
        params = M.init_params(cfg, gen_rng, device=dev)
        src = SyntheticTokens(cfg, DataConfig(batch_size=args.batch,
                                              seq_len=args.prompt_len))
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in src.next_batch().items()}
        decode, plan = SS.make_decode_step(cfg, total, backend=args.backend)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        devices.synchronize(dev)

        t0 = time.perf_counter()
        cache, logits, plen = M.prefill(params, cfg, batch,
                                        cache_len=serve_cache_len(cfg, plan, total),
                                        backend=args.backend)
        devices.synchronize(dev)
        t_prefill = time.perf_counter() - t0
        print(f"prefill: {t_prefill * 1e3:.1f} ms "
              f"({args.batch * args.prompt_len / t_prefill:.0f} tok/s)")
        reg.gauge("prefill_s").set(t_prefill)
        reg.gauge("prefill_tok_per_s").set(
            args.batch * args.prompt_len / t_prefill)
        prefill_logits = logits

        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out = [tok]
        # warm up outside the timed loop, then time every step on its own:
        # the mean hides exactly the tail the kernel work targets.  The
        # cache is written in place, so this call writes slot plen; that is
        # harmless because the first timed step writes the same K/V (same
        # token, same position, same cache prefix) to the same slot.
        # an ssm layer's recurrent state (ssm and hybrid models) advances
        # with every call, so their warm-up runs on a copy of the cache
        decode(params, tree_map(torch.clone, cache)
               if cfg.family in ("ssm", "hybrid") else cache, tok, plen)
        devices.synchronize(dev)
        decode_calls = 1
        hist = reg.histogram("decode_latency_s")
        pos = plen
        for i in range(args.gen - 1):
            t1 = time.perf_counter()
            logits, tok, cache = decode(params, cache, tok, pos)
            devices.synchronize(dev)
            hist.observe(time.perf_counter() - t1)
            decode_calls += 1
            out.append(tok)
            pos += 1
            if args.log_every and (i + 1) % args.log_every == 0:
                metrics.log_histogram("decode_latency_s", hist)
        gen = torch.cat(out, dim=1)

    result = {"arch": cfg.name, "vocab_size": cfg.vocab_size,
              "num_layers": cfg.num_layers, "prefill_s": t_prefill,
              "prefill_logits": prefill_logits, "last_logits": logits,
              "tokens": gen, "decode_calls": decode_calls}
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        reg.gauge("peak_mem_bytes").set(peak)
        result["peak_mem_bytes"] = peak
        print(f"peak memory: {peak / 2**30:.2f} GiB")
    if hist.count:
        s = hist.summary()
        p50, p95, tot = s["p50"], s["p95"], s["mean"] * s["count"]
        reg.gauge("decode_tok_per_s").set(
            args.batch * hist.count / max(tot, 1e-9))
        reg.gauge("decode_tok_per_s_p50").set(
            args.batch / max(p50, 1e-9))
        # the structured rows carry the numbers the summary line prints
        metrics.log_histogram("decode_latency_s", hist)
        metrics.log(**reg.snapshot())
        print(f"decode: {tot * 1e3:.1f} ms over {hist.count} steps — "
              f"p50={p50 * 1e3:.2f} ms p95={p95 * 1e3:.2f} ms "
              f"({args.batch * hist.count / max(tot, 1e-9):.0f} tok/s, "
              f"{args.batch / max(p50, 1e-9):.0f} tok/s @p50)")
        result.update(decode_p50_s=p50, decode_p95_s=p95,
                      decode_tok_per_s=args.batch * hist.count / max(tot, 1e-9))
    return result


if __name__ == "__main__":
    main()
