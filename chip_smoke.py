#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card.  Without one — or run from a directory that holds
this file and nothing else of the repo — it exits non-zero and prints no
result.  Phases, each of which fails the run by raising:

  1. environment: torch / CUDA versions, the card's name and power limit;
     TF32 off for matmuls and cuDNN.
  2. build: ``nvcc`` of every kernel source of the serving path, one
     process per source, all started together.
  3. kernels vs their plain PyTorch versions on the card, at the shapes
     the serving path gives them and at edge cases, in fp32 and bf16;
     timed with CUDA events beside one PyTorch library call and the
     card's bound for the same work.
  4. the main path: ``repro_torch.launch.serve`` serves granite-8b at
     full width and depth (36 layers, bf16) from seeded random weights,
     batch 4, prompt 512, 32 generated tokens; every attention call of
     prefill and decode must have launched a kernel (launch counts).
  5. kernel path vs plain path end to end: granite-8b at full width cut
     to 4 layers, prefill and 4 decode steps, ``--backend kernel`` vs
     ``--backend einsum`` in bf16.
  6. where the time goes: the same 36-layer model, warm prefill and
     decode steps timed untraced, then traced with ``torch.profiler``
     for device time by kernel and the device's idle share (tables in
     ``build/chip_smoke/profile_*.txt``).

Prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power
line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): bf16 tensor cores and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Tolerances of a kernel against its plain version on the same inputs.
# fp32: both do the same fp32 arithmetic, summed in another order (64-wide
# tiles, fused multiply-adds, an online softmax); that moves O(1) outputs
# by ~1e-6, so 1e-4 absolute holds with margin.
# bf16: both compute in fp32 and round the result to bf16 once; they can
# land one bf16 step apart, at most 2^-7 = 0.8% of the value, hence
# 1e-2 rel.  The largest error measured on an H100 over all bf16 cases
# was 1.95e-3, so 4e-3 abs gives it twice that margin: still about 5% of
# a typical output at the serving shape (~0.07), so a dropped key or a
# wrongly masked tile shows.
TOL = {"float32": (1e-4, 0.0), "bfloat16": (4e-3, 1e-2)}
# scaled_dot_product_attention (a yardstick for time only) rounds the
# probabilities to bf16 before the product with V, as the einsum path
# does; it sat 1.56e-2 from the plain version on an H100.
LIB_TOL = (3e-2, 2e-2)

# End to end in bf16, kernel path vs einsum path.  The einsum path rounds
# the scores and the probabilities to bf16 before the products (as the
# JAX einsum path does); the kernels keep them in fp32.  Each layer's
# attention output then differs by about a bf16 step, and four layers
# compound it; logits are O(1).  Bound the relative L2 error of the
# logits and their largest absolute error.
E2E_REL_L2 = 3e-2
E2E_MAX_ABS = 0.25
E2E_MIN_AGREE = 3                    # greedy tokens equal on >= 3 of 4 steps

FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FD_SOURCE = "src/repro_torch/kernels/csrc/flash_decode.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:31"
FD_REPLACES = "src/repro/kernels/flash_decode.py:49"

# (label, B, Sq, Sk, H, KV, hd, causal, window, q_offset)
FA_CASES = [
    ("ragged S=200, hd 64", 2, 200, 200, 4, 4, 64, True, 0, 0),
    ("GQA 8/2, hd 128", 2, 256, 256, 8, 2, 128, True, 0, 0),
    ("causal + window 96", 2, 320, 320, 8, 8, 128, True, 96, 0),
    ("q_offset 320", 1, 100, 420, 4, 2, 128, True, 0, 320),
    ("non-causal, ragged Sk", 2, 130, 150, 4, 4, 64, False, 0, 0),
    ("window 50, GQA, hd 64", 1, 300, 300, 8, 4, 64, True, 50, 0),
]
FA_SERVE = ("serving: B4 S512 H32 KV8 hd128", 4, 512, 512, 32, 8, 128, True, 0, 0)

# (label, B, KV, G, S, hd, pos, window, softcap, ring, q_scale)
FD_CASES = [
    ("linear pos 520", 4, 8, 4, 544, 128, 520, 0, 0.0, False, 1.0),
    ("ring + window 300", 4, 8, 4, 544, 128, 1000, 300, 0.0, True, 1.0),
    ("ring, unwritten slots", 4, 8, 4, 544, 128, 300, 0, 0.0, True, 1.0),
    ("softcap 50", 4, 8, 4, 544, 128, 543, 0, 50.0, False, 40.0),
    ("pages past pos masked", 4, 8, 4, 544, 128, 40, 0, 0.0, False, 1.0),
    ("pages before window masked", 4, 8, 4, 544, 128, 520, 100, 0.0, False, 1.0),
    ("hd 64, G 1", 2, 16, 1, 200, 64, 150, 0, 0.0, False, 1.0),
    ("G 9 (starcoder2 heads)", 2, 4, 9, 333, 128, 300, 0, 0.0, False, 1.0),
]
FD_SERVE = ("serving: B4 KV8 G4 hd128 S544", 4, 8, 4, 544, 128, 543, 0, 0.0, False, 1.0)

SERVE_ARGS = ["--arch", "granite_8b", "--batch", "4", "--prompt-len", "512",
              "--gen", "32", "--backend", "auto", "--device", "cuda"]


def log(msg=""):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(got, want, dtype_name, what, tol=None):
    atol, rtol = tol or TOL[dtype_name]
    g, w = got.float(), want.float()
    if not bool(g.isfinite().all()):
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} elements off; "
            f"max abs err {float(err.max()):.3e} (atol {atol}, rtol {rtol})")
    return float(err.max())


def time_ms(fn, iters, warmup=3):
    """Mean ms per call over ``iters`` calls, timed with CUDA events;
    ``fn(i)`` gets the call index (to rotate inputs)."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, warmup=2):
    """Device time per call (ms) of every kernel that ``iters`` calls of
    ``fn(i)`` launch, by kernel name, from ``torch.profiler``'s CUDA
    activity.  Unlike ``time_ms`` it leaves out the host's time between
    launches.  Empty where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3 / iters
    return out


def summed(times, part=""):
    """Sum of ``device_ms`` entries whose name contains ``part``; None
    (not measured) when the profiler gave no device time."""
    return sum(v for k, v in times.items() if part in k) if times else None


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def fa_inputs(case, dtype, gen):
    import torch
    _, B, Sq, Sk, H, KV, hd, *_ = case
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)
    return mk(B, Sq, H, hd), mk(B, Sk, KV, hd), mk(B, Sk, KV, hd)


def fd_inputs(case, dtype, gen, n_caches=1):
    import torch
    _, B, KV, G, S, hd, *_, q_scale = case
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda")
    q = (mk(B, KV * G, hd) * q_scale).to(dtype)
    caches = [(mk(B, KV, S, hd).to(dtype), mk(B, KV, S, hd).to(dtype))
              for _ in range(n_caches)]
    return q, caches


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    fa_err = fd_err = 0.0
    for case in FA_CASES + [FA_SERVE]:
        label, *_, causal, window, q_offset = case
        for dname, dt in dtypes.items():
            q, k, v = fa_inputs(case, dt, gen)
            got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset)
            e = compare(got, want, dname, f"flash_attention [{label}, {dname}]")
            log(f"  flash_attention {label:32s} {dname:9s} max_abs_err={e:.3e}")
            fa_err = max(fa_err, e) if dname == "bfloat16" else fa_err
    for case in FD_CASES + [FD_SERVE]:
        label, *_, pos, window, softcap, ring, _ = case
        for dname, dt in dtypes.items():
            q, [(k, v)] = fd_inputs(case, dt, gen)
            got = ops.flash_decode(q, k, v, pos, window=window,
                                   softcap=softcap, ring=ring)
            torch.cuda.synchronize()
            want = ref.decode_attention_ref(q, k, v, pos, window=window,
                                            softcap=softcap, ring=ring)
            e = compare(got, want, dname, f"flash_decode [{label}, {dname}]")
            log(f"  flash_decode    {label:32s} {dname:9s} max_abs_err={e:.3e}")
            fd_err = max(fd_err, e) if dname == "bfloat16" else fd_err

    # ---- times at the serving shapes, bf16 ----
    rows = {}
    _, B, Sq, Sk, H, KV, hd, causal, window, q_offset = FA_SERVE
    q, k, v = fa_inputs(FA_SERVE, torch.bfloat16, gen)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True).transpose(1, 2)
    lib_err = compare(lib, ref.flash_attention_ref(q, k, v), "bfloat16",
                      "scaled_dot_product_attention yardstick", tol=LIB_TOL)
    pairs = B * H * (Sq * (Sq + 1) // 2)         # causal, q_offset 0, no window
    b_ms, b_by = bound(4 * hd * pairs,
                       2 * (q.numel() * 2 + k.numel() + v.numel()))
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda", source=FA_SOURCE,
        replaces=FA_REPLACES, max_abs_err=fa_err, bound_ms=b_ms, bound_by=b_by,
        **timed(lambda i: ops.flash_attention(q, k, v),
                lambda i: ref.flash_attention_ref(q, k, v),
                lambda i: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True),
                "attn_fwd", iters=20))
    log(f"  scaled_dot_product_attention vs plain: max_abs_err={lib_err:.3e}")

    _, B, KV, G, S, hd, pos, window, softcap, ring, _ = FD_SERVE
    # eight caches (71 MB > the 50 MB L2) taken in turn, so every call
    # reads its cache from device memory, as each layer's decode does
    q, caches = fd_inputs(FD_SERVE, torch.bfloat16, gen, n_caches=8)
    live = int(ref.decode_valid(pos, S, device="cuda").sum())
    bias = ops.decode_bias(pos, S, device="cuda").view(1, 1, 1, S)
    q4 = q.view(B, KV * G, 1, hd)
    b_ms, b_by = bound(4 * B * KV * G * live * hd,
                       2 * 2 * B * KV * live * hd + 2 * 2 * q.numel() + 4 * S)
    n = len(caches)
    rows["flash_decode"] = dict(
        name="flash_decode", route="cuda", source=FD_SOURCE,
        replaces=FD_REPLACES, max_abs_err=fd_err, bound_ms=b_ms, bound_by=b_by,
        **timed(lambda i: ops.flash_decode(q, *caches[i % n], pos),
                lambda i: ref.decode_attention_ref(q, *caches[i % n], pos),
                lambda i: F.scaled_dot_product_attention(
                    q4, *caches[i % n], attn_mask=bias, enable_gqa=True),
                "decode_fwd", iters=200))
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    for r in rows.values():
        log(f"  {r['name']} per call, CUDA events: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms; "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        log(f"  {r['name']} per call, device time (profiler): kernel "
            f"{fmt(r['device_ms'])}, whole wrapper {fmt(r['wrapper_device_ms'])}, "
            f"plain {fmt(r['plain_device_ms'])}, library {fmt(r['library_device_ms'])}")
    return rows


def timed(kernel, plain, library, tag, iters):
    """Per-call times of a kernel's wrapper, its plain version and the
    library yardstick: CUDA events around back-to-back calls (what a
    caller waits for, host gaps included) and profiler device time (the
    kernel named ``tag`` alone, and everything each call launched)."""
    dev = device_ms(kernel, iters)
    return dict(
        ms=time_ms(kernel, iters), plain_ms=time_ms(plain, max(5, iters // 4)),
        library_ms=time_ms(library, iters),
        device_ms=summed(dev, tag), wrapper_device_ms=summed(dev),
        plain_device_ms=summed(device_ms(plain, 5)),
        library_device_ms=summed(device_ms(library, iters)))


def phase_main_path():
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    run_dir = os.path.join(ROOT, "build", "chip_smoke", "serve_granite_8b")
    ops.reset_launches()
    res = serve.main(SERVE_ARGS + ["--run-dir", run_dir])
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    L, calls = res["num_layers"], res["decode_calls"]
    if L != 36:
        raise AssertionError(f"granite-8b ran {L} layers, expected 36")
    if launches["flash_attention"] != L:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, expected {L}")
    if launches["flash_decode"] != L * calls:
        raise AssertionError(f"flash_decode launched {launches['flash_decode']} "
                             f"times, expected {L} x {calls} decode calls")
    for key in ("prefill_logits", "last_logits"):
        if not bool(res[key].float().isfinite().all()):
            raise AssertionError(f"{key} are not finite")
    toks = res["tokens"]
    if toks.shape != (4, 32) or int(toks.min()) < 0 \
            or int(toks.max()) >= res["vocab_size"]:
        raise AssertionError(f"tokens of shape {tuple(toks.shape)} "
                             f"outside [0, {res['vocab_size']})")
    log(f"  launches: {launches} over 1 prefill + {calls} decode calls")
    log(f"  prefill {res['prefill_s'] * 1e3:.2f} ms, decode p50 "
        f"{res['decode_p50_s'] * 1e3:.3f} ms p95 {res['decode_p95_s'] * 1e3:.3f} ms, "
        f"{res['decode_tok_per_s']:.1f} tok/s, peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB")
    del res
    torch.cuda.empty_cache()
    return launches


def phase_end_to_end():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("granite_8b"), num_layers=4)
    B, S, steps = 4, 512, 4
    with torch.inference_mode():
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
        toks = SyntheticTokens(cfg, DataConfig(batch_size=B, seq_len=S)).next_batch()
        batch = {"tokens": torch.from_numpy(toks["tokens"]).to(dev)}

        def check(lk, le, what):
            d = (lk.float() - le.float())
            rel = float(d.norm() / le.float().norm())
            mx = float(d.abs().max())
            if not bool(lk.float().isfinite().all()) or rel > E2E_REL_L2 \
                    or mx > E2E_MAX_ABS:
                raise AssertionError(f"{what}: kernel vs einsum rel L2 {rel:.3e} "
                                     f"(limit {E2E_REL_L2}), max abs {mx:.3e} "
                                     f"(limit {E2E_MAX_ABS})")
            log(f"  {what}: rel L2 {rel:.3e}, max abs {mx:.3e}")

        cache_e, le, plen = M.prefill(params, cfg, batch, S + steps, backend="einsum")
        cache_k, lk, _ = M.prefill(params, cfg, batch, S + steps, backend="kernel")
        check(lk, le, "prefill last logits")
        tok = torch.argmax(le, -1).to(torch.int32)[:, None]
        agree = 0
        for i in range(steps):
            le, _ = M.decode_step(params, cfg, tok, cache_e, plen + i, backend="einsum")
            lk, _ = M.decode_step(params, cfg, tok, cache_k, plen + i, backend="kernel")
            check(lk, le, f"decode step {i} logits")
            agree += int(torch.equal(le.argmax(-1), lk.argmax(-1)))
            tok = torch.argmax(le, -1).to(torch.int32)[:, None]
    if agree < E2E_MIN_AGREE:
        raise AssertionError(f"greedy tokens agree on {agree} of {steps} steps")
    log(f"  greedy tokens agree on {agree} of {steps} decode steps")


def phase_profile():
    """Where the time goes on the main path's model: granite-8b, 36
    layers, bf16, batch 4, prompt 512.  After a warm-up, one prefill and
    4 decode steps are timed on the host clock untraced, then again under
    ``torch.profiler`` for the device time by kernel (a separate traced
    run, so phase 4's serve numbers carry no tracing cost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    cfg = get_config("granite_8b")
    B, S, steps = 4, 512, 4
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with torch.inference_mode():
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
        toks = SyntheticTokens(cfg, DataConfig(batch_size=B, seq_len=S)).next_batch()
        batch = {"tokens": torch.from_numpy(toks["tokens"]).to(dev)}
        cache, logits, plen = M.prefill(params, cfg, batch, S + steps)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]

        def run(label):
            if label == "prefill":
                M.prefill(params, cfg, batch, S + steps)
            else:                     # each step writes its own slot in place
                for i in range(steps):
                    M.decode_step(params, cfg, tok, cache, plen + i)

        for label, n in (("prefill", 1), ("decode", steps)):
            run(label)                # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(label)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(label)
                torch.cuda.synchronize()
                traced = (time.perf_counter() - t0) * 1e3 / n
            by_name = {}
            for e in prof.key_averages():
                us = getattr(e, "self_device_time_total", 0) or 0
                if us > 0:
                    by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / n
            busy = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])
            with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
                for name, ms in top:
                    f.write(f"{ms:12.4f} ms  {name}\n")
            if not by_name:
                log(f"  {label}: {wall:.2f} ms a call untraced; device time "
                    "not measured (the profiler recorded none)")
                continue
            log(f"  {label}: {wall:.2f} ms a call untraced, {traced:.2f} ms traced; "
                f"device busy {busy:.2f} ms = {100 * busy / wall:.1f}% of the "
                f"untraced time (idle share {100 * (1 - busy / wall):.1f}%)")
            for name, ms in top[:6]:
                log(f"    {ms:9.4f} ms {100 * ms / busy:5.1f}%  {name[:90]}")
    del params, cache
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    log("== 1. environment")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    log(f"  nvidia-smi: {smi}")

    log("== 2. build")
    t0 = time.perf_counter()
    build.load()
    log(f"  built/loaded {list(build.ENTRY_POINTS)} in {time.perf_counter() - t0:.1f} s")
    for name, out in build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {line.strip()}")

    log("== 3. kernels vs plain versions")
    rows = phase_kernels()

    log("== 4. main path: serve granite-8b, 36 layers, bf16")
    launches = phase_main_path()

    log("== 5. kernel path vs einsum path, granite-8b width, 4 layers")
    phase_end_to_end()

    log("== 6. where the time goes: granite-8b, 36 layers, traced")
    phase_profile()

    kernels = []
    for name in ("flash_attention", "flash_decode"):
        r = dict(rows[name])
        r["launches"] = launches[name]
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms")})
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
