#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card.  Without one — or run from a directory that holds
this file and nothing else of the repo — it exits non-zero and prints no
result.  Phases, each of which fails the run by raising:

  1. environment: torch / CUDA versions, the card's name and power limit;
     TF32 off for matmuls and cuDNN.
  2. build: ``nvcc`` of every kernel source, one process per source, all
     started together.
  3. kernels vs their plain PyTorch versions on the card, at the shapes
     the main paths give them (``flash_attention`` also at the profiler's
     (1, 4096, 32/8, 128); zamba2's head_dim 80 and (h 80, n 64) too) and
     at edge cases, in fp32 and bf16, and the gradients of the three
     autograd Functions (``flash_attention``, ``ssd_scan``, ``rmsnorm``)
     against the gradients of plain versions written apart from the ones
     their backward passes recompute; timed with CUDA events and profiler
     device time beside one PyTorch library call (where there is one) and
     the card's bound for the same work.
  4. serving path: ``repro_torch.launch.serve`` serves granite-8b at full
     width and depth (36 layers, bf16) from seeded random weights, batch
     4, prompt 512, 32 generated tokens; every attention call of prefill
     and decode must have launched a kernel (launch counts).
  5. kernel path vs plain path end to end: granite-8b at full width cut
     to 4 layers, prefill and 4 decode steps, ``--backend kernel`` vs
     ``--backend einsum`` in bf16.
  6. where the time goes in serving: the same 36-layer model, warm
     prefill and decode steps timed untraced, then traced with
     ``torch.profiler`` (tables in ``build/chip_smoke/profile_*.txt``).
  7. training path: ``repro_torch.launch.train`` trains mamba2-780m at
     full width and depth (48 layers, bf16), batch 4 x seq 2048, 6 steps;
     the losses must be finite and fall, and every SSM layer must have
     launched ``ssd_scan`` in the forward and in the remat recompute.
  8. where the time goes in a warm mamba2-780m train step (profiler,
     table in ``build/chip_smoke/profile_train.txt``).
  9. kernel path vs plain path in training: mamba2-780m width cut to 4
     layers, 3 steps from the same weights and batches with
     ``--backend kernel`` and ``--backend einsum``, in fp32 (the CUDA-core
     ``ssd_scan``) and in bf16 (the tensor-core one).
 10. SSM serving: mamba2-780m, 48 layers, batch 4, prompt 512, 32 tokens;
     one ``ssd_scan`` per layer in the prefill.
 11. dense training through ``flash_attention``'s gradient: qwen1.5-0.5b
     at full size, batch 2 x seq 1024, 3 steps.
 12. the measured auto-profiler: ``repro_torch.core.profiler.
     measure_layer_profile`` times granite-8b at full width at seq 4096
     through ``flash_attention``, ``rmsnorm`` and ``flash_decode`` (launch
     counts), and the cost model and the schedule simulator price one
     plan with and without those times laid over one chip type.
 13. hybrid training path: ``repro_torch.launch.train`` trains
     zamba2-2.7b at full width and depth (54 ssm layers in 9 groups, each
     followed by the shared attention block; bf16), batch 4 x seq 2048, 4
     steps; the losses must be finite and fall, and each step must launch
     2 x 54 ``ssd_scan`` and 2 x 9 ``flash_attention`` (one checkpoint a
     group); then a warm step traced (``profile_train_hybrid.txt``).
 14. kernel path vs plain path, hybrid: zamba2 width cut to 12 layers (2
     groups of 6), training as phase 9 (fp32 and bf16, phase 9's limits)
     and prefill + 4 decode steps as phase 5 in fp32 and bf16 (phase 5's
     limits, or the plain path's own spread where it is wider:
     ``E2E_SPREAD``).
 15. hybrid serving: zamba2-2.7b, 54 layers, batch 4, prompt 512, 32
     tokens; the prefill launches 54 ``ssd_scan`` and 9
     ``flash_attention``, each decode call 9 ``flash_decode``.
 16. HeteroPP on one card: ``repro_torch.launch.train --plan`` on two
     ranks sharing the card (``--p2p host``: gloo through pinned host
     memory), each plan two stages on different chip types with a
     non-uniform split: (a) qwen1.5-0.5b at full size, layers 10 / 14,
     recompute on / off, 4 microbatches of 2 x 1024, 4 steps under 1f1b
     and again under zb_v (v 2: stage 0 hosts global stages 0 and 3),
     4 x (10 x 2 + 14) = 136 ``flash_attention`` a step over both ranks;
     (b) mamba2-780m at full size, 20 / 28, both recompute, 4
     microbatches of 1 x 2048, 2 steps, 4 x 48 x 2 = 384 ``ssd_scan`` a
     step; losses finite and falling; (c) both widths cut to 4 layers
     (1 / 3), every library schedule against the single-device loss and
     gradient in fp32 and bf16 at phase 9's limits, the single-chunk
     schedules' losses equal bit for bit and the chunked ones equal to
     them.

Prints one ``{"kernels": [...]}`` line (each kernel's ``launches`` summed
over the main paths that run it, phases 4, 7, 12, 13, 15 and 16, each
counted from 0; phase 16's in each rank's own process, summed over the
ranks), the ``nvidia-smi`` name/power line, and last ``{"ok": true,
"device": {...}}``.

    python3 chip_smoke.py --transports

needs two cards and runs phases 1, 2 and phase 16 (a)'s 1f1b run only,
with one card a rank, once through each stage-to-stage transport:
``--p2p device`` (NCCL, card to card) and ``--p2p host`` (gloo through
pinned host memory).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
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
# Phase 14 (zamba2 width, 12 layers): the einsum path moved only by its
# SSD chunk (the same fp32 sums in another order) lands 3.4e-2 to 8.8e-2
# rel L2 and up to 0.76 max abs from itself in bf16, and its greedy
# tokens agree with its own on 1 of 4 steps (measured on an H100, batch
# 4 x prompt 512): every flipped bf16 rounding is carried through 12
# layers, three times phase 5's depth, so phase 5's limits sit inside
# the plain path's own spread.  There each logit limit is the larger of
# phase 5's and E2E_SPREAD x that spread, measured in the same run at
# chunk / 2 and / 4 (the kernel path read 0.55-1.14x it; a wrong tile or
# mask moves the logits by O(1)), and the tokens are held to
# E2E_MIN_AGREE only where the einsum path meets it against itself.  In
# fp32, run beside it, the kernel path reads 1.1e-4 to 2.4e-4 and the
# spread 7.2e-5 to 1.9e-4, and phase 5's limits hold, tokens included.
# The multiple is phase 9's.
E2E_SPREAD = 3.5

# ssd_scan against ssd_ref: both read the same inputs (bf16 ones too) and
# compute in fp32, the kernel chunk by chunk and the reference position by
# position, so fp32's tolerance holds for both input types (as
# tests/test_kernels.py: rtol 1e-3, atol 1e-4).  The bf16 kernels hand
# their fp32 intermediates to the tensor cores as hi + lo bf16 pairs
# (about 16 significant bits), which keeps them inside it.
SSD_TOL = (1e-4, 1e-3)
# Gradients of an autograd Function against an independent plain
# version's: both differentiate fp32 math (flash_attention: against
# ``plain_attention`` below, written apart from ``ref``; ssd_scan: the
# chunked form against the sequential ``ref.ssd_ref``), so they agree to
# fp32 rounding, or to one bf16 step of the gradient; atol as a share of
# the largest entry.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# Training, kernel path vs einsum path in fp32 (phase 9): the SSD forward
# differs in summation order only (~1e-6 relative), and three AdamW steps
# keep that size: losses within 1e-4 relative, per-leaf gradient norms
# at step 1 within 1e-3 relative.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GNORM_RTOL = 1e-3
# The same in bf16 (phase 9's twin, the tensor-core ssd_scan): both paths
# compute the SSD in fp32 from bf16 inputs and differ by ~1e-5 relative
# there, but the block rounds the SSD output to bf16, so a difference
# that small flips some roundings by one bf16 step (0.4%), and layers and
# steps carry the flips on.  The losses, sums over every token, stay
# within 1e-3 relative.  A gradient norm can move far more, and by a
# different amount in each leaf: one whose gradient is a small residual
# of large terms (A_log, dt_bias) amplifies the flips.  The chunked path
# moves each leaf as much when only its chunk, its summation order,
# changes.  So each leaf is held to its own spread, measured in the same
# run: the kernel path's relative norm difference from the chunked path
# is at most 3.5x the larger of that leaf's differences at chunk / 2 and
# chunk / 4, or of 2e-3 where a leaf barely moves.  The CPU rehearsal
# (tests/test_torch_ssm.py::test_bf16_kernel_path_training_rehearsal,
# batch 1 x seq 512) puts the kernels' arithmetic at most 2.5x that
# yardstick on every leaf and one bf16 rounding of the fp32
# intermediates (no hi + lo split) at 5x on its worst leaf; 3.5 lies
# between.  A wrong tile or mask moves the SSD output by O(1) and the
# gradients by far more.
TRAIN_BF16_LOSS_RTOL = 1e-3
TRAIN_BF16_GNORM_SPREAD = 3.5
TRAIN_BF16_GNORM_FLOOR = 2e-3
TRAIN_BF16_CHUNK_DIVISORS = (2, 4)

FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FD_SOURCE = "src/repro_torch/kernels/csrc/flash_decode.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:31"
FD_REPLACES = "src/repro/kernels/flash_decode.py:49"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan.py:27"
RN_SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"
RN_REPLACES = "src/repro/kernels/rmsnorm.py:17"

# rmsnorm: (label, rows, d, misaligned x).  The profile's shape first
# (t_rmsnorm at seq 4096, d_model 4096); then row counts that are no
# multiple of any tile, d not a multiple of a 16-byte vector (an unaligned
# head and a scalar tail in every row but some), narrow rows (one warp a
# row), and x starting one element past a 16-byte boundary (scalar path).
RN_PROFILE = ("profile: 4096 x 4096", 4096, 4096, False)
RN_CASES = [
    ("37 x 1000", 37, 1000, False),
    ("37 x 1001", 37, 1001, False),
    ("129 x 4100", 129, 4100, False),
    ("3 x 20 (d < one vector of fp32 x 2)", 3, 20, False),
    ("300 x 14336 (more than 8 vectors a thread)", 300, 14336, False),
    ("65 x 2048, x misaligned", 65, 2048, True),
]
RN_GRAD = [("grad: 512 x 4096", 512, 4096, False), ("grad: 37 x 1001", 37, 1001, False)]

# Phase 12: the profiler at the main path's model, and the plan it prices:
# the A:4 + B:4 two-type plan of tests/test_dataparallel.py:351 at tp 1,
# granite-8b's 36 layers split 18 / 18 over two stages a type, dp 2.
# t_wgrad is t_bwd - t_dgrad, two means of ~50 ms calls on the host clock
# that differ by the weight-gradient GEMMs (a few ms); one call stalled by
# a busy host inflates one mean.  With 5 timed calls t_wgrad read 0.2 ms
# in one run (PERF.md); 20 keep a stall well inside the margin.
PROFILE_ARCH, PROFILE_SEQ, PROFILE_ITERS = "granite_8b", 4096, 20

# (label, b, S, h, p, g, n, chunk)
SSD_TRAIN = ("training: b4 S2048 h48 p64 g1 n128", 4, 2048, 48, 64, 1, 128, 256)
SSD_CASES = [
    ("prefill: b4 S512 h48 p64 g1 n128", 4, 512, 48, 64, 1, 128, 256),
    ("g 2, S = chunk 128, p32 n64", 2, 128, 8, 32, 2, 64, 128),
    ("smoke: S96 chunk 32, p32 n16", 2, 96, 4, 32, 1, 16, 32),
]
SSD_GRAD = ("grad: b1 S512 h48 p64 g1 n128", 1, 512, 48, 64, 1, 128, 256)
FA_GRAD = [
    ("grad: qwen B2 S1024 H16 hd64", 2, 1024, 1024, 16, 16, 64, True, 0, 0),
    ("grad: window 96, q_offset 64, GQA 8/2", 1, 256, 320, 8, 2, 128, True, 96, 64),
    ("grad: zamba2 heads B1 S512 H32 hd80", 1, 512, 512, 32, 32, 80, True, 0, 0),
]
# zamba2-2.7b's ssd_scan shapes: h 80 heads of p 64, state n 64
SSD_ZAMBA2 = [
    ("zamba2 training: b4 S2048 h80 p64 g1 n64", 4, 2048, 80, 64, 1, 64, 256),
    ("zamba2 prefill: b4 S512 h80 p64 g1 n64", 4, 512, 80, 64, 1, 64, 256),
]

TRAIN_ARGS = ["--arch", "mamba2_780m", "--batch", "4", "--seq", "2048",
              "--steps", "6", "--backend", "auto", "--device", "cuda",
              "--log-every", "1"]
SSM_SERVE_ARGS = ["--arch", "mamba2_780m", "--batch", "4", "--prompt-len", "512",
                  "--gen", "32", "--backend", "auto", "--device", "cuda"]
DENSE_TRAIN_ARGS = ["--arch", "qwen1p5_0p5b", "--batch", "2", "--seq", "1024",
                    "--steps", "3", "--backend", "auto", "--device", "cuda",
                    "--log-every", "1"]
HYBRID_TRAIN_ARGS = ["--arch", "zamba2_2p7b", "--batch", "4", "--seq", "2048",
                     "--steps", "4", "--backend", "auto", "--device", "cuda",
                     "--log-every", "1"]
HYBRID_SERVE_ARGS = ["--arch", "zamba2_2p7b", "--batch", "4", "--prompt-len", "512",
                     "--gen", "32", "--backend", "auto", "--device", "cuda"]
# Phase 14: zamba2 at full width cut to 2 groups of 6 ssm layers
HYBRID_CUT_LAYERS = 12

# (label, B, Sq, Sk, H, KV, hd, causal, window, q_offset)
FA_CASES = [
    ("ragged S=200, hd 64", 2, 200, 200, 4, 4, 64, True, 0, 0),
    ("GQA 8/2, hd 128", 2, 256, 256, 8, 2, 128, True, 0, 0),
    ("causal + window 96", 2, 320, 320, 8, 8, 128, True, 96, 0),
    ("q_offset 320", 1, 100, 420, 4, 2, 128, True, 0, 320),
    ("non-causal, ragged Sk", 2, 130, 150, 4, 4, 64, False, 0, 0),
    ("window 50, GQA, hd 64", 1, 300, 300, 8, 4, 64, True, 50, 0),
    ("ragged S=200, hd 80", 2, 200, 200, 4, 4, 80, True, 0, 0),
    ("window 96, GQA 8/4, hd 80", 2, 320, 320, 8, 4, 80, True, 96, 0),
]
FA_SERVE = ("serving: B4 S512 H32 KV8 hd128", 4, 512, 512, 32, 8, 128, True, 0, 0)
# t_attn of the profile (phase 12): granite-8b's heads at seq 4096
FA_PROFILE = ("profile: B1 S4096 H32 KV8 hd128", 1, 4096, 4096, 32, 8, 128, True, 0, 0)
# zamba2-2.7b's shared block: 32 heads of 2560 / 32 = 80, kv 32
FA_ZAMBA2 = [
    ("zamba2 prefill: B4 S512 H32 KV32 hd80", 4, 512, 512, 32, 32, 80, True, 0, 0),
    ("zamba2 training: B4 S2048 H32 KV32 hd80", 4, 2048, 2048, 32, 32, 80, True, 0, 0),
]

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
    ("hd 80, G 4", 4, 8, 4, 544, 80, 520, 0, 0.0, False, 1.0),
    ("hd 80, ring + window 300", 4, 8, 4, 544, 80, 1000, 300, 0.0, True, 1.0),
    ("hd 80, G 25 (the most at hd 80)", 2, 4, 25, 333, 80, 300, 0, 0.0, False, 1.0),
]
FD_SERVE = ("serving: B4 KV8 G4 hd128 S544", 4, 8, 4, 544, 128, 543, 0, 0.0, False, 1.0)
FD_ZAMBA2 = ("zamba2 decode: B4 KV32 G1 hd80 S544", 4, 32, 1, 544, 80, 543, 0, 0.0, False,
             1.0)

SERVE_ARGS = ["--arch", "granite_8b", "--batch", "4", "--prompt-len", "512",
              "--gen", "32", "--backend", "auto", "--device", "cuda"]

# Phase 16: HeteroPP on one card, two ranks sharing it through gloo
# ("--p2p host": NCCL refuses two ranks on one card).  Each plan is two
# stages on different chip types of core/chips.py with a non-uniform
# split, as HeteroAuto gives a heterogeneous cluster: (chip, layers,
# recompute) a stage.  b microbatches of batch / b rows each.
PP_ARGS = ["--backend", "auto", "--device", "cuda", "--log-every", "1"]
PP_QWEN = ("qwen1p5_0p5b", (("A", 10, True), ("B", 14, False)), 4,
           ["--batch", "8", "--seq", "1024", "--steps", "4"])
PP_MAMBA2 = ("mamba2_780m", (("A", 20, True), ("B", 28, True)), 4,
             ["--batch", "4", "--seq", "2048", "--steps", "2"])
# Phase 16 (c): both widths cut to 4 layers split 1 / 3, every schedule
# of the library, against the single-device loss and gradient on the
# same weights and microbatches, at phase 9's limits.  gpipe, 1f1b and
# zb_h1 run one tick program, so their losses must agree bit for bit,
# and the chunked schedules run the same layers on the same inputs, so
# theirs must equal them.
PP_PARITY_SCHEDULES = ("gpipe", "1f1b", "zb_h1", "interleaved", "interleaved3", "zb_v",
                       "wave")
PP_PARITY = [("qwen1p5_0p5b", 4, 2, 1024), ("mamba2_780m", 4, 1, 2048)]
PP_PARITY_SPLIT = (1, 3)
PP_PARITY_DTYPES = ("float32", "bfloat16")
# One hop's cost alone, at (a)'s and (b)'s activation shapes in bf16
PP_HOPS = [("qwen 2 x 1024 x 1024", (2, 1024, 1024)),
           ("mamba2 1 x 2048 x 1536", (1, 2048, 1536))]
PP_HOP_ITERS = 20


def log(msg=""):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(nvcc_output):
    """One line per compiled kernel from ``nvcc -Xptxas -v``: its
    (mangled) name, registers, spills and static shared memory."""
    lines, name, spills = [], None, ""
    for line in nvcc_output.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
            name, spills = None, ""
        elif "error" in line or "warning" in line:
            lines.append(line.strip())
    return lines


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


def kernel_name(signature):
    """A kernel's function name from the profiler's demangled signature."""
    m = re.search(r"(\w+)(?:<[^(]*>)?\(", signature)
    return m.group(1) if m else signature[:40]


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
    for case in FA_CASES + [FA_SERVE] + FA_ZAMBA2:
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
    for case in FD_CASES + [FD_SERVE, FD_ZAMBA2]:
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

    # ---- times at the serving shapes (and the profile's, and zamba2's), bf16 ----
    rows = {}
    fa_rows = {}
    for case in (FA_SERVE, FA_PROFILE, *FA_ZAMBA2):
        label, B, Sq, Sk, H, KV, hd, causal, window, q_offset = case
        q, k, v = fa_inputs(case, torch.bfloat16, gen)
        want = ref.flash_attention_ref(q, k, v)
        err = compare(ops.flash_attention(q, k, v), want, "bfloat16",
                      f"flash_attention [{label}, bfloat16]")
        fa_err = max(fa_err, err)
        log(f"  flash_attention {label:32s} bfloat16  max_abs_err={err:.3e}")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True).transpose(1, 2)
        lib_err = compare(lib, want, "bfloat16",
                          "scaled_dot_product_attention yardstick", tol=LIB_TOL)
        log(f"  scaled_dot_product_attention vs plain [{label}]: "
            f"max_abs_err={lib_err:.3e}")
        del lib, want
        pairs = B * H * (Sq * (Sq + 1) // 2)     # causal, q_offset 0, no window
        b_ms, b_by = bound(4 * hd * pairs,
                           2 * (q.numel() * 2 + k.numel() + v.numel()))
        fa_rows[label] = dict(
            name="flash_attention", route="cuda", source=FA_SOURCE,
            replaces=FA_REPLACES, bound_ms=b_ms, bound_by=b_by,
            **timed(lambda i: ops.flash_attention(q, k, v),
                    lambda i: ref.flash_attention_ref(q, k, v),
                    lambda i: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True),
                    "attn_fwd", iters=20))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    rows["flash_attention"] = dict(fa_rows[FA_SERVE[0]], max_abs_err=fa_err)

    fd_rows = {case[0]: fd_timed(case, gen, fd_err) for case in (FD_SERVE, FD_ZAMBA2)}
    rows["flash_decode"] = fd_rows[FD_SERVE[0]]
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    shown = list(fa_rows.items()) + list(fd_rows.items())
    for label, r in shown:
        log(f"  {r['name']} per call [{label}], CUDA events: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms; "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        log(f"  {r['name']} per call [{label}], device time (profiler): kernel "
            f"{fmt(r['device_ms'])}, whole wrapper {fmt(r['wrapper_device_ms'])}, "
            f"plain {fmt(r['plain_device_ms'])}, library {fmt(r['library_device_ms'])}")
    return rows


def fd_timed(case, gen, err):
    """``flash_decode``'s row of times at ``case`` (bf16), beside its
    plain version, ``scaled_dot_product_attention`` and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    _, B, KV, G, S, hd, pos, window, softcap, ring, _ = case
    # eight caches (71 MB at the granite shape, 178 MB at zamba2's: more
    # than the 50 MB L2) taken in turn, so every call reads its cache from
    # device memory, as each layer's decode does
    q, caches = fd_inputs(case, torch.bfloat16, gen, n_caches=8)
    live = int(ref.decode_valid(pos, S, device="cuda").sum())
    # the library call needs the mask as a bias; the kernel computes it
    bias = ops.decode_bias(pos, S, device="cuda").view(1, 1, 1, S)
    q4 = q.view(B, KV * G, 1, hd)
    b_ms, b_by = bound(4 * B * KV * G * live * hd,
                       2 * 2 * B * KV * live * hd + 2 * 2 * q.numel())
    n = len(caches)
    log(f"  flash_decode [{case[0]}] splits the {S}-slot cache "
        f"{ops.decode_splits(B * KV, S)} ways: "
        f"{B * KV * ops.decode_splits(B * KV, S)} blocks in pass 1")
    return dict(
        name="flash_decode", route="cuda", source=FD_SOURCE,
        replaces=FD_REPLACES, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timed(lambda i: ops.flash_decode(q, *caches[i % n], pos),
                lambda i: ref.decode_attention_ref(q, *caches[i % n], pos),
                lambda i: F.scaled_dot_product_attention(
                    q4, *caches[i % n], attn_mask=bias, enable_gqa=True),
                "decode_", iters=200))


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


def serve_and_check(args, run, layers, want):
    """One ``repro_torch.launch.serve`` run: the model must have
    ``layers`` layers, each kernel launch ``want(decode_calls)[name]``
    times, the logits be finite and the tokens in the vocabulary.
    Returns the launch counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    run_dir = os.path.join(ROOT, "build", "chip_smoke", run)
    ops.reset_launches()
    res = serve.main(args + ["--run-dir", run_dir])
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    L, calls = res["num_layers"], res["decode_calls"]
    if L != layers:
        raise AssertionError(f"{res['arch']} ran {L} layers, expected {layers}")
    for name, n in want(calls).items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times over 1 "
                                 f"prefill + {calls} decode calls, expected {n}")
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


def phase_main_path():
    """granite-8b: every attention call of the prefill and of each decode
    call launches a kernel."""
    L = 36
    return serve_and_check(SERVE_ARGS, "serve_granite_8b", L, lambda calls: {
        "flash_attention": L, "flash_decode": L * calls})


def serve_logits(params, cfg, batch, backend, steps, feed=None):
    """Prefill and ``steps`` decode steps: the logits of each (the
    prefill's last position first) and the tokens fed, ``feed`` or else
    the run's own greedy tokens."""
    import torch
    from repro_torch.models import model as M

    cache, lg, plen = M.prefill(params, cfg, batch, batch["tokens"].shape[1] + steps,
                                backend=backend)
    out, fed = [lg.float()], []
    for i in range(steps):
        tok = feed[i] if feed else torch.argmax(out[-1], -1).to(torch.int32)[:, None]
        lg, _ = M.decode_step(params, cfg, tok, cache, plen + i, backend=backend)
        out.append(lg.float())
        fed.append(tok)
    return out, fed


def phase_end_to_end(arch="granite_8b", layers=4, dtype="bfloat16"):
    """``arch`` at full width cut to ``layers`` layers: prefill and 4
    decode steps through the kernels against the einsum paths, both fed
    the einsum path's greedy tokens.  For a model with ssm layers each
    limit is the larger of phase 5's and E2E_SPREAD x the einsum path's
    own distance from itself at other chunks, measured on the same
    weights and tokens (see E2E_SPREAD)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype)
    B, S, steps = 4, 512, 4
    diff = lambda a, b: (float((a - b).norm() / b.norm()), float((a - b).abs().max()))
    with torch.inference_mode():
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
        toks = SyntheticTokens(cfg, DataConfig(batch_size=B, seq_len=S)).next_batch()
        batch = {"tokens": torch.from_numpy(toks["tokens"]).to(dev)}
        le, feed = serve_logits(params, cfg, batch, "einsum", steps)
        lk, _ = serve_logits(params, cfg, batch, "kernel", steps, feed)
        chunks = [cfg.ssm_chunk // k for k in TRAIN_BF16_CHUNK_DIVISORS] \
            if cfg.family in ("ssm", "hybrid") else []
        ys = [serve_logits(params, dataclasses.replace(cfg, ssm_chunk=c), batch,
                           "einsum", steps, feed)[0] for c in chunks]
    agree = lambda xs: sum(int(torch.equal(a.argmax(-1), b.argmax(-1)))
                           for a, b in zip(xs[1:], le[1:]))
    # a token criterion the plain path fails against itself judges nothing
    gated = min([steps] + [agree(y) for y in ys]) >= E2E_MIN_AGREE
    ok = True
    for i, (k, e) in enumerate(zip(lk, le)):
        what = "prefill last logits" if i == 0 else f"decode step {i - 1} logits"
        rel, mx = diff(k, e)
        own = [diff(y[i], e) for y in ys]
        lim_rel = max([E2E_REL_L2] + [E2E_SPREAD * r for r, _ in own])
        lim_mx = max([E2E_MAX_ABS] + [E2E_SPREAD * m for _, m in own])
        good = bool(k.isfinite().all()) and rel <= lim_rel and mx <= lim_mx
        ok = ok and good
        log(f"  {dtype} {what}: kernel vs einsum rel L2 {rel:.3e} (limit {lim_rel:.3e}), "
            f"max abs {mx:.3e} (limit {lim_mx:.3e})"
            + "".join(f"; einsum at chunk {c}: {r:.3e}, {m:.3e}"
                      for c, (r, m) in zip(chunks, own)) + ("" if good else "  OVER"))
    log(f"  {dtype} greedy tokens agree on {agree(lk)} of {steps} decode steps ("
        + (f"limit {E2E_MIN_AGREE}" if gated else "not held: the einsum path "
           f"agrees with itself on fewer than {E2E_MIN_AGREE}")
        + "".join(f"; einsum at chunk {c}: {agree(y)}" for c, y in zip(chunks, ys)) + ")")
    if not ok or (gated and agree(lk) < E2E_MIN_AGREE):
        raise AssertionError(f"serving ({dtype}): kernel path and einsum path disagree")
    del params
    torch.cuda.empty_cache()


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


def ssd_inputs(case, dtype, gen):
    import torch
    import torch.nn.functional as F
    _, b, S, h, p, g, n, _ = case
    mk = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    x = mk(b, S, h, p).to(dtype)
    dt = F.softplus(mk(b, S, h)) * 0.5
    A = -torch.exp(mk(h) * 0.3)
    Bm = (mk(b, S, g, n) * 0.3).to(dtype)
    Cm = (mk(b, S, g, n) * 0.3).to(dtype)
    return x, dt, A, Bm, Cm


def ssd_bound(case, x_bytes):
    """(bound ms, what bounds it) of one ssd_scan call: each input read
    once and each output written once; operations as the chunked form
    needs them, at the bf16 tensor-core peak: C·Bᵀ once per group and
    L·X per head over the lower triangle of each chunk (diagonal
    included), and the carried term and state update per head."""
    _, b, S, h, p, g, n, chunk = case
    nbytes = (x_bytes * b * S * (h * p + 2 * g * n)    # x, B, C
              + 4 * b * S * h + 4 * h                  # dt, A
              + 4 * b * S * h * p + 4 * b * h * p * n)  # y, final state
    tri = chunk * (chunk + 1)                  # 2 x the (i, j <= i) pairs
    flops = b * (S // chunk) * (g * tri * n + h * (tri * p + 4 * chunk * n * p))
    return bound(flops, nbytes)


def phase_ssd_kernel():
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    err = 0.0
    for case in [SSD_TRAIN] + SSD_CASES + SSD_ZAMBA2:
        label, *_, chunk = case
        for dname, dt_ in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x, dt, A, Bm, Cm = ssd_inputs(case, dt_, gen)
            y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
            torch.cuda.synchronize()
            yr, fr = ref.ssd_ref(x, dt, A, Bm, Cm)
            e = max(compare(y, yr, dname, f"ssd_scan y [{label}, {dname}]", tol=SSD_TOL),
                    compare(fin, fr, dname, f"ssd_scan state [{label}, {dname}]",
                            tol=SSD_TOL))
            log(f"  ssd_scan        {label:36s} {dname:9s} max_abs_err={e:.3e} "
                f"(|y| <= {float(yr.abs().max()):.2f})")
            err = max(err, e)
    # B and C as column slices of one tensor, read in place (the model's layout)
    label, b, S, h, p, g, n, chunk = SSD_CASES[0]
    x, dt, A, _, _ = ssd_inputs(SSD_CASES[0], torch.bfloat16, gen)
    BC = torch.randn(b, S, 2 * g * n, generator=gen, device="cuda").to(torch.bfloat16) * 0.3
    Bm, Cm = BC[..., :g * n].view(b, S, g, n), BC[..., g * n:].view(b, S, g, n)
    y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    yr, fr = ref.ssd_ref(x, dt, A, Bm, Cm)
    e = max(compare(y, yr, "bfloat16", "ssd_scan, strided B/C", tol=SSD_TOL),
            compare(fin, fr, "bfloat16", "ssd_scan state, strided B/C", tol=SSD_TOL))
    log(f"  ssd_scan        {'B/C column slices of one tensor':36s} bfloat16  "
        f"max_abs_err={e:.3e}")

    # per call at the prefill shape, and the row's times at the training
    # shape, bf16 x/B/C as in the model
    label, *_, chunk = SSD_CASES[0]
    x, dt, A, Bm, Cm = ssd_inputs(SSD_CASES[0], torch.bfloat16, gen)
    pre = lambda i: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    pre_ms, pre_dev = time_ms(pre, 20), device_ms(pre, 20)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    log(f"  ssd_scan per call [{label}, bf16], CUDA events: kernel {pre_ms:.4f} ms; "
        f"device time {fmt(summed(pre_dev, 'ssd_fwd'))}; "
        f"bound {ssd_bound(SSD_CASES[0], 2)[0]:.4f} ms")
    rows = [ssd_timed(case, gen, err) for case in [SSD_TRAIN] + SSD_ZAMBA2]
    return rows[0]


def ssd_timed(case, gen, err):
    """``ssd_scan``'s row of times at ``case`` (bf16 x/B/C as in the
    model), beside the plain ``ssd_ref`` and the bound, with the device
    time split over its kernels."""
    from repro_torch.kernels import ops, ref
    import torch

    label, *_, chunk = case
    x, dt, A, Bm, Cm = ssd_inputs(case, torch.bfloat16, gen)
    b_ms, b_by = ssd_bound(case, 2)
    kern = lambda i: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    plain = lambda i: ref.ssd_ref(x, dt, A, Bm, Cm)
    dev = device_ms(kern, 10)
    row = dict(name="ssd_scan", route="cuda", source=SSD_SOURCE,
               replaces=SSD_REPLACES, max_abs_err=err, bound_ms=b_ms,
               bound_by=b_by, ms=time_ms(kern, 10), plain_ms=time_ms(plain, 2, warmup=1),
               library_ms=None, device_ms=summed(dev, "ssd_fwd"),
               wrapper_device_ms=summed(dev))
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    log(f"  ssd_scan per call [{label}, bf16], CUDA events: kernel {row['ms']:.4f} ms, "
        f"plain ssd_ref {row['plain_ms']:.4f} ms, no single PyTorch call; bound "
        f"{b_ms:.4f} ms ({b_by}); device time {fmt(row['device_ms'])} "
        f"(whole wrapper {fmt(row['wrapper_device_ms'])}): "
        + ", ".join(f"{kernel_name(k)} {v:.4f} ms" for k, v in dev.items()))
    return row


def rn_inputs(case, dtype, scale_dtype, gen):
    import torch
    _, rows, d, misaligned = case
    buf = torch.randn(rows * d + 1, generator=gen, device="cuda").to(dtype)
    x = buf[1:].view(rows, d) if misaligned else buf[:-1].view(rows, d)
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(scale_dtype)
    return x, scale


def phase_rmsnorm_kernel():
    """``rmsnorm`` against ``ref.rmsnorm_ref`` on the card, x in fp32 and
    bf16 with the scale in either, and its row of times at the profile's
    shape (bf16 x and bf16 scale, as the profiler times it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    err = 0.0
    for case in [RN_PROFILE] + RN_CASES:
        label = case[0]
        for dname, dt in dtypes.items():
            for sname, st in dtypes.items():
                x, scale = rn_inputs(case, dt, st, gen)
                got = ops.rmsnorm(x, scale)
                torch.cuda.synchronize()
                e = compare(got, ref.rmsnorm_ref(x, scale), dname,
                            f"rmsnorm [{label}, x {dname}, scale {sname}]")
                log(f"  rmsnorm         {label:44s} x {dname:9s} scale {sname:9s} "
                    f"max_abs_err={e:.3e}")
                err = max(err, e) if dname == "bfloat16" else err
    x, _ = rn_inputs(RN_PROFILE, torch.float32, torch.float32, gen)
    try:
        ops.rmsnorm(x.t(), torch.ones(x.shape[0], device="cuda"))
    except ValueError as e:
        log(f"  rmsnorm refuses a non-contiguous x: {e}")
    else:
        raise AssertionError("rmsnorm took a non-contiguous x")

    _, rows, d, _ = RN_PROFILE
    # three inputs taken in turn (200 MB with the outputs, > the 50 MB L2),
    # so every call reads x from device memory
    xs = [rn_inputs(RN_PROFILE, torch.bfloat16, torch.bfloat16, gen)[0] for _ in range(3)]
    scale = torch.ones(d, dtype=torch.bfloat16, device="cuda")
    lib = F.rms_norm(xs[0], (d,), scale, 1e-6)
    lib_err = float((lib.float() - ref.rmsnorm_ref(xs[0], scale).float()).abs().max())
    b_ms, b_by = bound(4 * rows * d, 2 * 2 * rows * d + 2 * d)
    n = len(xs)
    row = dict(name="rmsnorm", route="cuda", source=RN_SOURCE, replaces=RN_REPLACES,
               max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               **timed(lambda i: ops.rmsnorm(xs[i % n], scale),
                       lambda i: ref.rmsnorm_ref(xs[i % n], scale),
                       lambda i: F.rms_norm(xs[i % n], (d,), scale, 1e-6),
                       "rmsnorm_fwd", iters=200))
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    log(f"  torch.nn.functional.rms_norm vs plain: max_abs_err={lib_err:.3e} "
        "(a yardstick for time only)")
    log(f"  rmsnorm per call [4096 x 4096 bf16], CUDA events: kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms; "
        f"bound {b_ms:.4f} ms ({b_by})")
    log(f"  rmsnorm per call, device time (profiler): kernel {fmt(row['device_ms'])}, "
        f"whole wrapper {fmt(row['wrapper_device_ms'])}, plain "
        f"{fmt(row['plain_device_ms'])}, library {fmt(row['library_device_ms'])}")
    return row


def plain_rmsnorm(x, scale, eps=1e-6):
    """RMSNorm written apart from ``ref.rmsnorm_ref`` (the function
    ``rmsnorm``'s backward differentiates): the root mean square from a
    vector norm, fp32 math."""
    import torch
    xf = x.float()
    rms = torch.linalg.vector_norm(xf, dim=-1, keepdim=True) / math.sqrt(x.shape[-1])
    return (xf / torch.sqrt(rms * rms + eps) * scale.float()).to(x.dtype)


def grad_compare(got, want, dtype_name, what):
    import torch
    worst = 0.0
    for g, w in zip(got, want):
        if g is None or not bool(g.float().isfinite().all()):
            raise AssertionError(f"{what}: a gradient is missing or not finite")
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        if err > GRAD_TOL[dtype_name] * max(scale, 1e-6):
            raise AssertionError(f"{what}: max abs err {err:.3e} over a largest "
                                 f"entry of {scale:.3e} (tol {GRAD_TOL[dtype_name]})")
        worst = max(worst, err / max(scale, 1e-6))
    return worst


def plain_attention(q, k, v, causal, window, q_offset):
    """Softmax attention written apart from ``ref.flash_attention_ref``
    (the function ``flash_attention``'s backward differentiates), so a
    wrong mask or head mapping in that backward shows: GQA by
    ``repeat_interleave``, the mask from explicit positions, fp32 math."""
    import torch
    r = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(r, dim=2).float(), v.repeat_interleave(r, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(q.shape[-1])
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= qpos - kpos < window
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).to(q.dtype)


def phase_grads():
    """The gradients of the two autograd Functions (kernel forward,
    recomputed plain backward) against autograd through plain versions
    written apart from the ones their backward passes differentiate, on
    the same inputs."""
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    for case in FA_GRAD:
        label, *_, causal, window, q_offset = case
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        for dname, dt_ in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v = [t.requires_grad_() for t in fa_inputs(case, dt_, gen)]
            go = torch.randn(q.shape, generator=gen, device="cuda").to(dt_)
            out = ops.flash_attention(q, k, v, **kw)
            if out.grad_fn is None:
                raise AssertionError("flash_attention: the output has no grad_fn")
            got = torch.autograd.grad(out, (q, k, v), go)
            want = torch.autograd.grad(plain_attention(q, k, v, **kw), (q, k, v), go)
            e = grad_compare(got, want, dname, f"flash_attention grad [{label}, {dname}]")
            log(f"  flash_attention grad {label:38s} {dname:9s} "
                f"worst err / max = {e:.3e}")
    for case in RN_GRAD:
        label = case[0]
        for dname, dt_ in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x, scale = [t.requires_grad_() for t in
                        rn_inputs(case, dt_, torch.float32, gen)]
            go = torch.randn(x.shape, generator=gen, device="cuda").to(dt_)
            out = ops.rmsnorm(x, scale)
            if out.grad_fn is None:
                raise AssertionError("rmsnorm: the output has no grad_fn")
            got = torch.autograd.grad(out, (x, scale), go)
            want = torch.autograd.grad(plain_rmsnorm(x, scale), (x, scale), go)
            e = grad_compare(got, want, dname, f"rmsnorm grad [{label}, {dname}]")
            log(f"  rmsnorm grad         {label:38s} {dname:9s} "
                f"worst err / max = {e:.3e}")
    label, *_, chunk = SSD_GRAD
    x, dt, A, Bm, Cm = [t.requires_grad_() for t in
                        ssd_inputs(SSD_GRAD, torch.float32, gen)]
    ins = (x, dt, A, Bm, Cm)
    y, fin = ops.ssd_scan(*ins, chunk=chunk)
    gy = torch.randn(y.shape, generator=gen, device="cuda")
    gf = torch.randn(fin.shape, generator=gen, device="cuda")
    got = torch.autograd.grad((y, fin), ins, (gy, gf))
    yr, fr = ref.ssd_ref(*ins)
    want = torch.autograd.grad((yr, fr), ins, (gy, gf))
    e = grad_compare(got, want, "float32", f"ssd_scan grad [{label}]")
    log(f"  ssd_scan grad        {label:38s} float32   worst err / max = {e:.3e}")


def train_and_check(args, run, layers, per_step):
    """One ``repro_torch.launch.train`` run: the model must have
    ``layers`` layers, its losses be finite and fall, and each kernel in
    ``per_step`` launch that many times a step.  Returns (launches, the
    final train state)."""
    import statistics

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    run_dir = os.path.join(ROOT, "build", "chip_smoke", run)
    ops.reset_launches()
    res = train.main(args + ["--run-dir", run_dir])
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    L, losses, times = res["num_layers"], res["losses"], res["step_times_s"]
    steps = len(losses)
    if L != layers:
        raise AssertionError(f"{res['arch']} trained {L} layers, expected {layers}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses} are not finite and falling")
    for name, n in per_step.items():
        if launches[name] != n * steps:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{steps} steps, expected {n} a step")
    p50 = statistics.median(times[1:])
    log(f"  losses: {', '.join(f'{x:.4f}' for x in losses)}")
    log(f"  launches: {launches} over {steps} steps = " + ", ".join(
        f"{launches[name] // steps} {name}" for name in per_step) + " a step")
    log(f"  step time p50 over steps 2-{steps}: {p50 * 1e3:.1f} ms "
        f"(all: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms); "
        f"{res['tokens_per_step'] / p50:.0f} tok/s; peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB")
    return launches, res["state"]


def phase_train():
    """mamba2-780m: each layer's forward launches ssd_scan once, and the
    remat recompute of the layer in the backward once more; the backward
    itself differentiates the chunked form and launches none."""
    return train_and_check(TRAIN_ARGS, "train_mamba2_780m", 48, {"ssd_scan": 2 * 48})


def phase_hybrid_train():
    """zamba2-2.7b: one checkpoint a group of 6 ssm layers and the shared
    block (nothing checkpointed inside it), so each group's kernels run
    in the forward and once more in the backward's recompute: 2 x 54
    ``ssd_scan`` and 2 x 9 ``flash_attention`` a step."""
    return train_and_check(HYBRID_TRAIN_ARGS, "train_zamba2_2p7b", 54,
                           {"ssd_scan": 2 * 54, "flash_attention": 2 * 9})


def bf16_gnorm_rows(names, got, want, yardsticks):
    """Phase 9's bf16 gradient check, leaf by leaf: (name, the kernel
    path's relative norm difference from the chunked path, the leaf's own
    spread: the largest relative difference of the chunked path at the
    other chunks, ``yardsticks``, and the leaf's limit)."""
    rel = lambda a, b: abs(a - b) / max(b, 1e-12)
    rows = []
    for i, name in enumerate(names):
        spread = max(rel(y[i], want[i]) for y in yardsticks)
        rows.append((name, rel(got[i], want[i]), spread,
                     TRAIN_BF16_GNORM_SPREAD * max(spread, TRAIN_BF16_GNORM_FLOOR)))
    return rows


def phase_train_kernel_vs_plain(dtype="float32", arch="mamba2_780m", layers=4):
    """``arch`` at full width cut to ``layers`` layers: the kernel path
    against the einsum (chunked) path, three steps from the same weights
    and batches, in fp32 (the CUDA-core kernels) or bf16 (the tensor-core
    ones; each leaf's gradient held to the einsum path's own spread at
    other chunks)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_step import make_train_state, make_train_step
    from repro_torch.tree import flatten

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype)
    B, S, steps = 4, 2048, 3
    opt = AdamWConfig(lr=3e-4, total_steps=steps, warmup_steps=5)

    def run(cfg, backend, steps):
        state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                                 device=dev)
        loader = make_loader(cfg, DataConfig(batch_size=B, seq_len=S, seed=1234),
                             device=dev)
        batch = next(loader)
        flat = flatten(state.params)
        loss, _ = M.loss_fn(state.params, cfg, batch, backend=backend)
        norms = [float(g.float().norm())
                 for g in torch.autograd.grad(loss, list(flat.values()))]
        step = make_train_step(cfg, opt, backend=backend)
        losses = []
        for i in range(steps):
            state, m = step(state, batch if i == 0 else next(loader))
            losses.append(float(m["loss"]))
        del state, loader, batch
        torch.cuda.empty_cache()
        return list(flat), norms, losses

    (names, nk, lk), (_, ne, le) = run(cfg, "kernel", steps), run(cfg, "einsum", steps)
    rel = max(abs(a - b) / b for a, b in zip(lk, le))
    loss_rtol = TRAIN_LOSS_RTOL if dtype == "float32" else TRAIN_BF16_LOSS_RTOL
    log(f"  {dtype}: losses kernel {', '.join(f'{x:.6f}' for x in lk)}; "
        f"einsum {', '.join(f'{x:.6f}' for x in le)}; worst rel diff {rel:.2e} "
        f"(limit {loss_rtol})")
    if dtype == "float32":
        worst = max(abs(a - b) / max(b, 1e-12) for a, b in zip(nk, ne))
        log(f"  {dtype}: step-1 gradients: worst relative per-leaf norm difference "
            f"{worst:.2e} over {len(nk)} leaves (limit {TRAIN_GNORM_RTOL:.0e})")
        grads_ok = worst <= TRAIN_GNORM_RTOL
    else:
        chunks = [cfg.ssm_chunk // k for k in TRAIN_BF16_CHUNK_DIVISORS]
        rows = bf16_gnorm_rows(names, nk, ne, [
            run(dataclasses.replace(cfg, ssm_chunk=c), "einsum", 0)[1] for c in chunks])
        log(f"  {dtype}: step-1 gradients, per leaf: relative norm difference, "
            f"the chunked path's own spread at chunk {' and '.join(map(str, chunks))}, "
            f"limit = {TRAIN_BF16_GNORM_SPREAD} x max(spread, "
            f"{TRAIN_BF16_GNORM_FLOOR:.0e})")
        for name, d, spread, limit in rows:
            log(f"    {name:30s} {d:.2e}  spread {spread:.2e}  limit {limit:.2e}"
                + ("  OVER" if d > limit else ""))
        grads_ok = all(d <= limit for _, d, _, limit in rows)
    if not all(map(math.isfinite, lk + nk)) or rel > loss_rtol or not grads_ok:
        raise AssertionError(f"training ({dtype}): kernel path and einsum path disagree")
    torch.cuda.empty_cache()


def phase_ssm_serve():
    """mamba2-780m: one ``ssd_scan`` a layer in the prefill; decode takes
    the recurrent update."""
    serve_and_check(SSM_SERVE_ARGS, "serve_mamba2_780m", 48,
                    lambda calls: {"ssd_scan": 48})


def phase_hybrid_serve():
    """zamba2-2.7b: one ``ssd_scan`` a layer and one ``flash_attention``
    a group (the shared block) in the prefill; one ``flash_decode`` a
    group in each decode call."""
    L, G = 54, 9
    return serve_and_check(HYBRID_SERVE_ARGS, "serve_zamba2_2p7b", L, lambda calls: {
        "ssd_scan": L, "flash_attention": G, "flash_decode": G * calls,
        "rmsnorm": 0})


def phase_dense_train():
    """qwen1.5-0.5b: each layer's forward and its remat recompute launch
    ``flash_attention``; the gradient reaches the attention weights."""
    import torch

    _, state = train_and_check(DENSE_TRAIN_ARGS, "train_qwen1p5_0p5b", 24,
                               {"flash_attention": 2 * 24})
    if not float(state.opt_state["m"]["blocks"]["attn"]["wq"].abs().max()) > 0:
        raise AssertionError("no gradient reached the attention weights")
    del state
    torch.cuda.empty_cache()


def phase_train_profile(state, args, out_name):
    """Where the time goes in a warm train step of the model and batch of
    ``args`` (the state its training phase left): one step timed
    untraced, one traced with the CPU activity too, so the backward
    ranges (``ssd_scan.backward``, ``flash_attention.backward``) get
    their device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_step import make_train_step

    flag = lambda name: args[args.index(name) + 1]
    dev = torch.device("cuda")
    cfg = get_config(flag("--arch"))
    step = make_train_step(cfg, AdamWConfig(lr=3e-4, total_steps=10, warmup_steps=5))
    loader = make_loader(cfg, DataConfig(batch_size=int(flag("--batch")),
                                         seq_len=int(flag("--seq")), seed=99),
                         device=dev)
    state, _ = step(state, next(loader))              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, next(loader))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    batch = next(loader)
    ranges = ("ssd_scan.backward", "flash_attention.backward")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    kernels, bwd = {}, {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if e.key in ranges:
            # the named range: its span on the device, over its kernels
            bwd[e.key] = dev_us / 1e3
        elif dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            # with CPU activity on, an operator's row repeats its kernels'
            # device time: sum the kernels' own rows only
            kernels[e.key] = kernels.get(e.key, 0.0) + dev_us / 1e3
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    with open(os.path.join(out_dir, out_name), "w") as f:
        for name, ms in top:
            f.write(f"{ms:12.4f} ms  {name}\n")
    if not kernels:
        log(f"  train step: {wall:.1f} ms untraced; device time not measured "
            "(the profiler recorded none)")
        return
    busy = sum(kernels.values())
    pct = lambda v: f"{v:.1f} ms ({100 * v / busy:.1f}%)"
    ssd = sum(v for k, v in kernels.items() if "ssd_fwd" in k)
    attn = sum(v for k, v in kernels.items() if "attn_fwd" in k)
    gemm = sum(v for k, v in kernels.items()
               if any(t in k.lower() for t in ("gemm", "cutlass", "xmma", "nvjet")))
    log(f"  train step: {wall:.1f} ms untraced, {traced:.1f} ms traced; device busy "
        f"{busy:.1f} ms = {100 * busy / wall:.1f}% of the untraced step "
        f"(idle share {100 * (1 - busy / wall):.1f}%)")
    log(f"    ssd_scan kernels (ssd_fwd*: three a call in bf16) {pct(ssd)}; "
        f"flash_attention kernel (attn_fwd*) {pct(attn)}; "
        + "; ".join(f"{r} (its plain recompute included) "
                    + (pct(bwd[r]) if r in bwd else "not measured") for r in ranges)
        + f"; every other kernel {busy - ssd - attn - sum(bwd.values()):.1f} ms; "
        f"GEMMs anywhere (the backward's included) {pct(gemm)}")
    for name, ms in top[:8]:
        log(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}%  {name[:90]}")
    del state
    torch.cuda.empty_cache()


def phase_profiler():
    """The measured auto-profiler on the card: granite-8b at full width at
    seq 4096 through the kernels, then one plan priced with and without
    the card's times laid over chip type A."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import chips, cost_model, profiler, schedule
    from repro_torch.kernels import ops

    cfg = get_config(PROFILE_ARCH)
    ops.reset_launches()
    t0 = time.perf_counter()
    meas = profiler.measure_layer_profile(cfg, PROFILE_SEQ, iters=PROFILE_ITERS,
                                          backend="kernel")
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    torch.cuda.empty_cache()
    log(f"  measure_layer_profile({cfg.name}, {PROFILE_SEQ}, iters={PROFILE_ITERS}, "
        f"backend='kernel') in {wall:.1f} s: " + json.dumps(meas))
    log(f"  launches: {launches}")
    times = {k: v for k, v in meas.items() if k != "backend"}
    bad = [k for k, v in times.items() if not (math.isfinite(v) and v > 0)]
    if bad or meas["backend"] != "kernel":
        raise AssertionError(f"profile fields {bad} are not finite and > 0, or the "
                             f"backend is {meas['backend']!r}: {meas}")
    calls = PROFILE_ITERS + 1                    # one warm call, then the timed ones
    want = {"rmsnorm": calls,
            # block forward, forward + full backward, forward + dgrad, attention
            "flash_attention": 4 * calls,
            "flash_decode": cfg.num_layers * calls,   # every layer of each decode step
            "ssd_scan": 0}
    if launches != want:
        raise AssertionError(f"profiler launches {launches}, expected {want}")

    analytic = profiler.analytic_layer_profile(chips.CHIPS["A"], cfg, 1, PROFILE_SEQ)
    log(f"  chip A's analytic layer at tp 1 (the profile it replaces): "
        f"t_fwd {analytic.t_fwd:.6f} s, t_bwd {analytic.t_bwd:.6f} s, "
        f"wgrad_frac {analytic.wgrad_frac:.4f}")
    group = lambda name: chips.ChipGroup(chips.CHIPS[name], 4)
    half = cfg.num_layers // 2
    plan = cost_model.ParallelPlan(
        [cost_model.StagePlan(group("A"), 1, 2, half, False),
         cost_model.StagePlan(group("B"), 1, 2, cfg.num_layers - half, False)],
        dp=2, microbatches=4)
    log(f"  plan {plan.describe()}: the card's profile laid over chip type A "
        "only to show that measured numbers reach the ranker; this is not a "
        "plan for an H100 cluster")
    gbs = plan.batch_seqs * PROFILE_SEQ
    measured = {"A": meas}
    base = cost_model.evaluate(plan, cfg, PROFILE_SEQ, gbs)
    over = cost_model.evaluate(plan, cfg, PROFILE_SEQ, gbs, measured=measured)
    sim0 = schedule.simulate_plan(plan, cfg, PROFILE_SEQ)
    sim1 = schedule.simulate_plan(plan, cfg, PROFILE_SEQ, measured=measured)
    for label, c, r in (("analytic", base, sim0), ("measured on A", over, sim1)):
        log(f"  {label:14s} evaluate: iter_time {c.iter_time:.6f} s, tgs {c.tgs:.3f}, "
            f"t_comp {[round(t, 6) for t in c.t_comp]}, bubble {c.bubble_frac:.4f}, "
            f"feasible {c.feasible}; simulate_plan makespan {r.makespan:.6f} s")
    if not (math.isfinite(over.iter_time) and over.iter_time != base.iter_time
            and sim1.makespan != sim0.makespan):
        raise AssertionError("the measured profile did not reach evaluate and "
                             "simulate_plan")
    return launches


def pp_plan(stages, microbatches, schedule):
    """A ``ParallelPlan`` JSON (``to_dict``) of one-chip stages."""
    return {"dp": 1, "microbatches": microbatches, "schedule": schedule,
            "stages": [{"chip": chip, "count": 1, "label": "", "tp": 1, "pp": 1,
                        "layers": layers, "recompute": rec}
                       for chip, layers, rec in stages]}


def pipeline_and_check(arch, stages, microbatches, args, schedule, kernel,
                       transport="host"):
    """``repro_torch.launch.train --plan`` on two ranks (sharing the card
    under ``--p2p host`` on one card; one card a rank otherwise): the
    losses must be finite and fall, and ``kernel`` launch b x
    sum_s L_s x (2 if recompute[s] else 1) times a step, summed over the
    ranks (each counts from 0 in its own process).  Returns the
    launches."""
    import statistics

    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    run = f"pipeline_{arch}_{schedule}_{transport}"
    out_dir = os.path.join(ROOT, "build", "chip_smoke", run)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "plan.json")
    with open(path, "w") as f:
        json.dump(pp_plan(stages, microbatches, schedule), f)
    torch.cuda.empty_cache()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = train.main(["--arch", arch, "--plan", path, "--run-dir", out_dir,
                      "--p2p", transport] + args + PP_ARGS)
    wall = time.perf_counter() - t0
    launches, losses, times = res["launches"], res["losses"], res["step_times_s"]
    steps = len(losses)
    per_step = microbatches * sum(L * (2 if rec else 1) for _, L, rec in stages)
    if res["num_layers"] != sum(L for _, L, _ in stages):
        raise AssertionError(f"{arch} trained {res['num_layers']} layers")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses} are not finite and falling")
    if launches[kernel] != per_step * steps:
        raise AssertionError(f"{kernel} launched {launches[kernel]} times in {steps} "
                             f"steps over the ranks, expected {per_step} a step")
    p50 = statistics.median(times[1:]) if steps > 1 else times[0]
    ticks = res["ticks"]
    p2p_b = res["p2p_bytes_per_step"][-1]
    steady = lambda xs: statistics.median(xs[1:] or xs)
    p2p_s, copy_s = steady(res["p2p_s_per_step"]), steady(res["p2p_copy_s_per_step"])
    log(f"  {schedule}: losses {', '.join(f'{x:.4f}' for x in losses)}")
    log(f"  {schedule}: launches over both ranks {launches} in {steps} steps = "
        f"{launches[kernel] // steps} {kernel} a step (expected {per_step})")
    log(f"  {schedule}: step p50{' over steps 2-' + str(steps) if steps > 1 else ''} "
        f"{p50 * 1e3:.1f} ms (all: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms); "
        f"{res['tokens_per_step'] / p50:.0f} tok/s; {ticks} ticks a step; rank 0's "
        f"P2P {p2p_b / ticks / 2**20:.2f} MiB and {p2p_s * 1e3 / ticks:.2f} ms a tick "
        f"({p2p_s * 1e3:.1f} ms a step, forward and backward, waits for the peer "
        f"included; host staging copies {copy_s * 1e3 / ticks:.2f} ms a tick); peak "
        f"memory by rank "
        + ", ".join(f"{b / 2**30:.2f}" for b in res["peak_mem_bytes_per_rank"])
        + f" GiB; {wall:.1f} s with the ranks' start")
    log(f"  {schedule}: exchanges a step by rank (wall, waits included / of it host "
        f"staging copies), and all-reduces a step (the token count, the loss, the "
        f"replicated leaves' gradients): " + "; ".join(
            f"rank {r}: {steady(a) * 1e3:.1f} / {steady(c) * 1e3:.1f} ms, reduce "
            f"{steady(d) * 1e3:.1f} ms"
            for r, (a, c, d) in enumerate(zip(res["p2p_s_per_step_per_rank"],
                                              res["p2p_copy_s_per_step_per_rank"],
                                              res["reduce_s_per_step_per_rank"]))))
    return launches


def _parity_rank(rank, world, device, cases, microbatches, phys, schedules):
    """Phase 16 (c) on one rank: for each (arch, layers, mb, seq) case and
    dtype, the pipeline's loss and its gradient's squared norm per leaf
    in fp64 (block leaves over this rank's slots, the replicated ones on
    rank 0 only) under every schedule."""
    import torch
    from repro_torch.comm.p2p import P2P
    from repro_torch.core import heteropp as HP
    from repro_torch.core.schedules import get_schedule
    from repro_torch.kernels import build
    from repro_torch.tree import flatten

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        build.load()
    p2p = P2P("host", dev)
    out = {}
    for arch, layers, mb, seq in cases:
        for dtype in PP_PARITY_DTYPES:
            cfg, params, tokens = parity_inputs(arch, layers, dtype, mb, seq,
                                                microbatches, dev)
            for name in schedules:
                sched = get_schedule(name)
                spec = HP.PipelineSpec(world, HP.chunk_layer_counts(phys, sched),
                                       microbatches, schedule=name,
                                       n_chunks=sched.n_chunks)
                local = HP.local_stage_params(params, cfg, spec, rank)
                for t in flatten(local).values():
                    t.requires_grad_()
                loss, grads = HP.make_pipeline_loss(cfg, spec, p2p)(local, tokens)
                sq = {k: float(torch.sum(torch.square(g.double())))
                      for k, g in flatten(grads).items()
                      if k.startswith("blocks/") or rank == 0}
                out[f"{arch} {dtype} {name}"] = {"loss": float(loss), "sq": sq}
                del local, grads
            del params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    # one hop alone: both ranks exchange one activation each way, the
    # tick's exchange with no compute around it
    for label, shape in PP_HOPS:
        x = torch.randn(shape, device=dev).to(torch.bfloat16)
        for _ in range(3):
            p2p.ppermute([(x, [(0, 1), (1, 0)])], x)
        torch.distributed.barrier()
        p2p.reset_counts()
        for _ in range(PP_HOP_ITERS):
            p2p.ppermute([(x, [(0, 1), (1, 0)])], x)
        out[f"hop {label}"] = {"ms": p2p.seconds / PP_HOP_ITERS * 1e3,
                               "copy_ms": p2p.copy_seconds / PP_HOP_ITERS * 1e3,
                               "mib": x.numel() * x.element_size() / 2 ** 20}
    return out


def parity_inputs(arch, layers, dtype, mb, seq, microbatches, dev):
    """The cut config, its seeded weights and ``microbatches`` batches of
    (mb, seq) tokens, the same in every process on one card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    loader = make_loader(cfg, DataConfig(batch_size=mb * microbatches, seq_len=seq,
                                         seed=1234), device=dev)
    return cfg, params, next(loader)["tokens"].reshape(microbatches, mb, seq)


def phase_pipeline_parity(device="cuda:0", microbatches=4):
    """Phase 16 (c): the pipeline (two ranks on the card, one spawn for
    every case) against the single-device ``loss_fn`` and its gradient,
    in fp32 and bf16."""
    import torch
    from repro_torch.launch import ranks
    from repro_torch.models import model as M
    from repro_torch.tree import flatten

    dev = torch.device(device)
    t0 = time.perf_counter()
    res = ranks.spawn(_parity_rank, 2, (device, PP_PARITY, microbatches,
                                        PP_PARITY_SPLIT, PP_PARITY_SCHEDULES),
                      workdir=os.path.join(ROOT, "build", "chip_smoke", "parity"),
                      transport="host", timeout=600)
    log(f"  (c) parity: both ranks done in {time.perf_counter() - t0:.1f} s with "
        "their start")
    for label, _ in PP_HOPS:
        log(f"  one hop alone, {label} bf16 ({res[0]['hop ' + label]['mib']:.2f} MiB each "
            f"way, --p2p host), mean of {PP_HOP_ITERS}: " + "; ".join(
                f"rank {r}: {o['hop ' + label]['ms']:.3f} ms, of which host staging "
                f"copies {o['hop ' + label]['copy_ms']:.3f} ms" for r, o in enumerate(res)))
    for arch, layers, mb, seq in PP_PARITY:
        log(f"  (c) {arch} width, {layers} layers split "
            f"{' / '.join(map(str, PP_PARITY_SPLIT))}, {microbatches} microbatches "
            f"of {mb} x {seq}")
        for dtype in PP_PARITY_DTYPES:
            cfg, params, tokens = parity_inputs(arch, layers, dtype, mb, seq,
                                                microbatches, dev)
            flat = flatten(params)
            for t in flat.values():
                t.requires_grad_()
            loss, _ = M.loss_fn(params, cfg, {"tokens": tokens.reshape(-1, seq)})
            norms = {k: float(g.double().norm())
                     for k, g in zip(flat, torch.autograd.grad(loss, list(flat.values())))}
            want = float(loss.detach())
            del params, flat
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            runs = {name: [r[f"{arch} {dtype} {name}"] for r in res]
                    for name in PP_PARITY_SCHEDULES}
            losses = {name: rs[0]["loss"] for name, rs in runs.items()}
            if len({r["loss"] for rs in runs.values() for r in rs}) != 1:
                raise AssertionError(f"pipeline losses differ between schedules or "
                                     f"ranks: {losses}")
            rel = abs(losses["1f1b"] - want) / abs(want)
            loss_rtol = TRAIN_LOSS_RTOL if dtype == "float32" else TRAIN_BF16_LOSS_RTOL
            log(f"  {dtype}: pipeline loss {losses['1f1b']:.7f}, the same bit for bit "
                f"under {', '.join(PP_PARITY_SCHEDULES)}; single device {want:.7f}; "
                f"rel diff {rel:.2e} (limit {loss_rtol})")
            worst = {}
            for name, rs in runs.items():
                got = {k: math.sqrt(sum(r["sq"].get(k, 0.0) for r in rs)) for k in norms}
                worst[name] = max((abs(got[k] - norms[k]) / max(norms[k], 1e-12), k)
                                  for k in norms)
            log(f"  {dtype}: worst relative per-leaf gradient norm difference over "
                f"{len(norms)} leaves: " + ", ".join(f"{k} {v:.2e} ({leaf})"
                                                     for k, (v, leaf) in worst.items())
                + (f" (limit {TRAIN_GNORM_RTOL:.0e})" if dtype == "float32"
                   else " (reported, not held in bf16)"))
            if not math.isfinite(rel) or rel > loss_rtol or (
                    dtype == "float32"
                    and max(v for v, _ in worst.values()) > TRAIN_GNORM_RTOL):
                raise AssertionError(f"pipeline ({arch}, {dtype}) and the single "
                                     "device disagree")


def phase_pipeline(device="cuda:0"):
    """Phase 16: HeteroPP on one card: (a) qwen1.5-0.5b from the 10 / 14
    plan under 1f1b and zb_v, (b) mamba2-780m from the 20 / 28 plan, (c)
    parity at 4 layers.  Returns the launches of (a) and (b)."""
    arch, stages, b, args = PP_QWEN
    launches = {}
    for schedule in ("1f1b", "zb_v"):
        got = pipeline_and_check(arch, stages, b, args, schedule, "flash_attention")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    arch, stages, b, args = PP_MAMBA2
    got = pipeline_and_check(arch, stages, b, args, "1f1b", "ssd_scan")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    phase_pipeline_parity(device)
    return launches

def phase_transports():
    """``--transports``: phase 16 (a)'s qwen1.5-0.5b plan under 1f1b with
    one card a rank, through NCCL and through gloo with host staging."""
    arch, stages, b, args = PP_QWEN
    for transport in ("device", "host"):
        log(f"  --p2p {transport}:")
        pipeline_and_check(arch, stages, b, args, "1f1b", "flash_attention", transport)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    transports = sys.argv[1:] == ["--transports"]
    if sys.argv[1:] and not transports:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    if transports and torch.cuda.device_count() < 2:
        print("chip_smoke --transports needs two cards", file=sys.stderr)
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
        for line in ptxas_summary(out):
            log(f"  [{name}] {line}")

    if transports:
        log("== 16 (a) by transport: qwen1.5-0.5b 10 / 14, 1f1b, one card a rank")
        phase_transports()
        print(smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    log("== 3. kernels vs plain versions")
    rows = phase_kernels()
    rows["ssd_scan"] = phase_ssd_kernel()
    rows["rmsnorm"] = phase_rmsnorm_kernel()
    phase_grads()

    log("== 4. serving path: serve granite-8b, 36 layers, bf16")
    launches = phase_main_path()

    log("== 5. kernel path vs einsum path, granite-8b width, 4 layers")
    phase_end_to_end()

    log("== 6. where the time goes: granite-8b, 36 layers, traced")
    phase_profile()

    log("== 7. training path: train mamba2-780m, 48 layers, bf16, b4 x S2048")
    train_launches, state = phase_train()
    launches["ssd_scan"] = train_launches["ssd_scan"]

    log("== 8. where the time goes: a warm mamba2-780m train step, traced")
    phase_train_profile(state, TRAIN_ARGS, "profile_train.txt")
    del state

    log("== 9. training, kernel path vs einsum path: mamba2-780m width, 4 layers, "
        "fp32 and bf16")
    phase_train_kernel_vs_plain("float32")
    phase_train_kernel_vs_plain("bfloat16")

    log("== 10. SSM serving: mamba2-780m, 48 layers, bf16")
    phase_ssm_serve()

    log("== 11. dense training through flash_attention: qwen1.5-0.5b, b2 x S1024")
    phase_dense_train()

    log("== 12. the measured auto-profiler: granite-8b at full width, seq 4096")
    launches["rmsnorm"] = phase_profiler()["rmsnorm"]

    log("== 13. hybrid training path: train zamba2-2.7b, 54 layers, bf16, b4 x S2048")
    hybrid_launches, state = phase_hybrid_train()
    log("  where the time goes: a warm zamba2-2.7b train step, traced")
    phase_train_profile(state, HYBRID_TRAIN_ARGS, "profile_train_hybrid.txt")
    del state

    log(f"== 14. kernel path vs einsum path, hybrid: zamba2 width, "
        f"{HYBRID_CUT_LAYERS} layers; training and serving in fp32 and bf16")
    phase_train_kernel_vs_plain("float32", "zamba2_2p7b", HYBRID_CUT_LAYERS)
    phase_train_kernel_vs_plain("bfloat16", "zamba2_2p7b", HYBRID_CUT_LAYERS)
    for dtype in ("float32", "bfloat16"):
        phase_end_to_end("zamba2_2p7b", HYBRID_CUT_LAYERS, dtype)

    log("== 15. hybrid serving: serve zamba2-2.7b, 54 layers, bf16")
    serve_launches = phase_hybrid_serve()
    for name in ("flash_attention", "flash_decode", "ssd_scan"):
        launches[name] += hybrid_launches[name] + serve_launches[name]

    log("== 16. HeteroPP on one card: 2 ranks, --p2p host; qwen1.5-0.5b 10 / 14 "
        "(1f1b, zb_v), mamba2-780m 20 / 28, parity at 4 layers")
    pipeline_launches = phase_pipeline()
    for name in ("flash_attention", "ssd_scan"):
        launches[name] += pipeline_launches[name]

    kernels = []
    for name in ("flash_attention", "flash_decode", "ssd_scan", "rmsnorm"):
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
