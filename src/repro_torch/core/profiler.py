"""Auto-profiler: layer-wise per-chip time and memory profiles.

The paper profiles each chip on real hardware (``t^fwd_{s_tp,i}``,
``t^bwd``, ``t^recomp``, ``t^update_{s_dp,s_tp,i}`` plus layer memory with
and without recomputation — §4.3.2).  Without the vendor hardware we build
the same profile *analytically* from a roofline model of each chip
(flops / TP-collective bytes / NIC bytes), with per-chip ``mfu`` calibrated
so the homogeneous baselines reproduce Table 6.  The profile OBJECT has the
same shape either way, so HeteroAuto is agnostic to its provenance — on a
real cluster, ``measure_layer_profile`` (below) fills the same fields from
wall-clock timings of the real model.

The analytic half is a copy of the JAX package's ``core/profiler.py``,
held equal to it by ``tests/test_torch_profiler.py``.  The measured half
times the port's model and CUDA kernels on the card, with two departures
from the reference, which replaces the model with ``reduced(cfg)`` and
caps the sequence at 256 tokens before it times anything (its
``profiler.py:225,229``) and so prices a full layer with the time of a
256-wide block of at most 256 tokens: here the caller chooses the config
and the length, and the function times what it is given.  The CPU tests
pass a reduced config and a short sequence, as the reference does for
itself.
"""
from __future__ import annotations

import dataclasses
import functools
import statistics
import time
from typing import Dict, Optional

import torch

from .chips import ChipSpec
from ..models.config import ModelConfig
from ..tree import tree_leaves, tree_map

BYTES_ACT = 2          # bf16 activations
# saved activation bytes per token per layer without recomputation
# (attn qkv/scores/out + mlp intermediates, Megatron-style accounting;
# 34·S·d·bytes is the classic no-flash-attention Megatron figure, which is
# the right regime for 2024-era heterogeneous vendor chips)
ACT_FACTOR = 34
# with recomputation only the layer-boundary activation is kept
ACT_BOUNDARY = 2


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """Per-(chip, model, tp) profile for ONE transformer layer and ONE
    microbatch (= 1 sequence of ``seq_len`` tokens, per the paper's
    micro-batch-size-1 regime)."""
    t_fwd: float
    t_bwd: float
    t_recomp: float
    tp_comm: float               # per-microbatch TP collective time (fwd)
    layer_param_bytes: float     # per chip (already / tp)
    act_bytes: float             # saved per microbatch w/o recompute (/ tp)
    act_boundary_bytes: float    # saved per microbatch w/ recompute
    # fraction of t_bwd that is WEIGHT gradient, from the layer's analytic
    # op mix: every parameter matmul backward splits 1:1 into dgrad+wgrad,
    # attention score/PV ops are weight-free (pure dgrad), and the TP
    # collectives ride the activation-gradient (dgrad) path.  Feeds the
    # backward-split schedules (zb_h1/zb_v) per stage.
    wgrad_frac: float = 0.5


@functools.lru_cache(maxsize=512)
def score_flops_per_token(cfg: ModelConfig) -> float:
    """Attention score + PV matmul FLOPs per token per layer — the ops
    with NO weight operand, whose backward is pure dgrad."""
    return 2 * 2 * (cfg.max_seq_len / 2) * cfg.num_heads * cfg.head_dim


@functools.lru_cache(maxsize=512)
def layer_flops_per_token(cfg: ModelConfig) -> float:
    """Forward FLOPs per token per layer (matmuls, incl. causal attention)."""
    d = cfg.d_model
    attn = 2 * d * (cfg.num_heads + cfg.num_kv_heads * 2 + cfg.num_heads) * cfg.head_dim
    attn += score_flops_per_token(cfg)               # scores+PV, causal
    if cfg.is_moe:
        ff = 2 * (3 if cfg.mlp in ("swiglu", "geglu", "glu") else 2) * \
            d * cfg.d_ff * cfg.experts_per_token
        ff += 2 * d * cfg.num_experts   # router
    else:
        ff = 2 * (3 if cfg.mlp in ("swiglu", "geglu", "glu") else 2) * d * cfg.d_ff
    return attn + ff


@functools.lru_cache(maxsize=512)
def layer_param_count(cfg: ModelConfig) -> float:
    d = cfg.d_model
    attn = d * (2 * cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    if cfg.is_moe:
        ff = cfg.num_experts * (3 if cfg.mlp in ("swiglu", "geglu", "glu")
                                else 2) * d * cfg.d_ff
    else:
        ff = (3 if cfg.mlp in ("swiglu", "geglu", "glu") else 2) * d * cfg.d_ff
    return attn + ff


@functools.lru_cache(maxsize=4096)
def _analytic_layer_profile_cached(chip: ChipSpec, cfg_key: str, tp: int,
                                   seq_len: int, fl_fwd: float,
                                   fl_score: float, params: float,
                                   d_model: int) -> LayerProfile:
    t_fwd_compute = fl_fwd / (tp * chip.peak_flops * chip.mfu)
    ar_bytes = 2 * seq_len * d_model * BYTES_ACT * 2 * (tp - 1) / max(tp, 1)
    tp_comm = ar_bytes / chip.intra_node_bw if tp > 1 else 0.0
    # backward op mix: each parameter matmul (flops P = fl_fwd − fl_score)
    # contributes one dgrad and one wgrad matmul, the weight-free score
    # ops (fl_score) two dgrad matmuls, collectives ride dgrad
    t_bwd = 2 * t_fwd_compute + 2 * tp_comm
    t_wgrad = (fl_fwd - fl_score) / (tp * chip.peak_flops * chip.mfu)
    return LayerProfile(
        t_fwd=t_fwd_compute + tp_comm,
        t_bwd=t_bwd,
        t_recomp=t_fwd_compute + tp_comm,
        tp_comm=tp_comm,
        layer_param_bytes=params * 2 / tp,
        act_bytes=ACT_FACTOR * seq_len * d_model * BYTES_ACT / tp,
        act_boundary_bytes=ACT_BOUNDARY * seq_len * d_model * BYTES_ACT,
        wgrad_frac=t_wgrad / t_bwd if t_bwd > 0 else 0.5,
    )


def analytic_layer_profile(chip: ChipSpec, cfg: ModelConfig, tp: int,
                           seq_len: int) -> LayerProfile:
    """The analytic stand-in for the paper's hardware auto-profiler
    (memoized — the search calls this millions of times)."""
    return _analytic_layer_profile_cached(
        chip, cfg.name, tp, seq_len, layer_flops_per_token(cfg) * seq_len,
        score_flops_per_token(cfg) * seq_len,
        layer_param_count(cfg), cfg.d_model)




OPT_STEP_TIME = 1e-4


def optimizer_step_time(chip: ChipSpec) -> float:
    """Pure per-stage optimizer step (fused AdamW over the local shard —
    memory-bound, tiny next to a microbatch of compute).  Grad-sync cost
    is priced SEPARATELY: either by the legacy constant-overlap
    heuristic (:func:`update_time`) or by the schedule-derived
    exposed-sync term (``cost_model.evaluate`` /
    ``schedule.plan_sync_events`` — DESIGN.md §10)."""
    return OPT_STEP_TIME


def update_time(chip: ChipSpec, cfg: ModelConfig, tp: int, dp: int,
                layers: float, *, overlap: float = 0.7) -> float:
    """LEGACY: per-stage optimizer step + the non-overlapped part of grad
    sync behind a fixed ``overlap`` fraction (ZeRO-1 reduce-scatter +
    all-gather over the DP group crosses nodes).  The hand-waved
    constant this hides is exactly what the schedule-aware overlap
    subsystem (DESIGN.md §10) replaces: ``cost_model.evaluate`` now
    derives the exposed fraction from the schedule's wgrad-tail windows
    and the per-bucket ``dataparallel.grad_sync`` byte accounting, and
    only falls back here when called with an explicit
    ``sync_overlap=`` (e.g. the Table 6 homogeneous baselines, whose
    measured frameworks overlap sync inside the last backward at finer
    granularity than the stage-level bucket rule can see)."""
    if dp <= 1:
        return OPT_STEP_TIME
    grad_bytes = layers * layer_param_count(cfg) * 2 / tp
    sync = 2 * grad_bytes * (dp - 1) / dp / chip.nic_bw
    return sync * (1.0 - overlap) + OPT_STEP_TIME


def offload_time(chip: ChipSpec, cfg: ModelConfig, tp: int,
                 layers: float, deficit_bytes: float) -> float:
    """Chip D's CPU-offload mode: the memory deficit must cross PCIe twice
    per microbatch (out + in), bounded by the optimizer-state working set."""
    if deficit_bytes <= 0:
        return 0.0
    return 2 * deficit_bytes / chip.pcie_bw


# ---------------------------------------------------------------------------
# measured profiles (real-hardware path of the same auto-profiler API)
# ---------------------------------------------------------------------------

MEASURED_TIME_FIELDS = ("t_fwd", "t_bwd", "t_recomp", "tp_comm",
                        "wgrad_frac")


def apply_measured(prof: LayerProfile,
                   meas: Optional[Dict[str, float]]) -> LayerProfile:
    """Overlay wall-clock measured fields from
    :func:`measure_layer_profile` onto an analytic :class:`LayerProfile`
    — the single ``measured=`` preference point shared by
    ``cost_model.evaluate`` and ``schedule.plan_to_schedule_inputs``, so
    searched plans are ranked on the kernels that actually execute
    whenever a chip has been profiled for real.  Fields absent from
    ``meas`` keep their analytic values (memory accounting is always
    analytic: byte counts are exact)."""
    if not meas:
        return prof
    fields = {k: meas[k] for k in MEASURED_TIME_FIELDS if k in meas}
    return dataclasses.replace(prof, **fields) if fields else prof


def measure_layer_profile(cfg: ModelConfig, seq_len: int, *, iters: int = 3,
                          backend: str = "auto",
                          device=None) -> Dict[str, float]:
    """Wall-clock layer profile of the port's model on ``device`` (the
    card unless ``"cpu"`` is asked for), for ``cfg`` at ``seq_len``
    tokens exactly as given.

    ``backend`` selects the EXECUTING kernel path — ``"kernel"`` times
    the CUDA kernels (``flash_attention`` in the block and alone,
    ``rmsnorm``, ``ssd_scan``, and ``flash_decode`` in the decode step),
    ``"einsum"`` the plain PyTorch paths, ``"auto"`` whatever the model
    would really run there (``kernels.ops.preferred_backend``).  The
    dict's ``"backend"`` is the resolved name.

    Timed, each the median of ``iters`` calls after one warm call, each
    call followed by a device synchronize (only the launches would be
    timed without it), so that a stall of the host does not count: one
    block forward (``t_fwd``, also ``t_recomp``); forward plus the
    gradient with respect to the block's parameters and its input
    (``t_bwd``, as the reference's ``jax.grad`` of both); and from
    ``iters`` pairs of backward passes run on one retained graph (the
    pair's order alternating, each timed on the device's clock where
    there is one, its launches queued behind a sleep of the device so
    that the host's launch cadence stays out of it), ``t_dgrad``, the median of the input-only backward,
    and ``t_wgrad``, the median of each pair's full backward less its
    input-only one, clamped to [0, ``t_bwd``]: both from the same
    passes, so that a stall of the host in another measurement cannot
    drive ``t_dgrad`` to 0 or below (the reference takes ``t_wgrad =
    max(t_bwd − t_dgrad, 0)`` from two means of forward plus backward,
    its ``t_dgrad`` the forward and the input-only backward); and
    ``wgrad_frac`` = ``t_wgrad / t_bwd`` clamped to [0.05, 0.95], as in
    the reference.
    Then attention, rmsnorm and (ssm/hybrid configs) the SSD scan alone
    at ``seq_len``, and one single-token decode step of the whole model
    against a cache of ``min(max(seq_len, 32), 1024)`` slots
    (``t_decode``).

    As in the reference, the timed block is a ``moe`` one for a MoE
    config and a dense one for every other, an ssm config included (an
    audio config's dense block applies no RoPE, as every block of that
    family; its decode step is a whole whisper decode step, the
    cross-attention against a zero cross cache).
    ``plan_to_schedule_inputs`` / ``cost_model.evaluate``
    prefer every measured field over the analytic one via
    :func:`apply_measured`."""
    from .. import device as devices
    from ..kernels import ops as kops
    from ..models import layers, transformer as tfm

    dev = devices.resolve(device)
    probe = torch.empty(0, device=dev)
    backend = kops.resolve_backend(backend, probe)
    if backend == "auto":
        backend = kops.preferred_backend(probe)
    gen = torch.Generator(device=dev).manual_seed(0)
    kind = "dense" if not cfg.is_moe else "moe"
    blk = tfm.init_block(cfg, kind, layers.dtype_of(cfg), generator=gen,
                         device=dev)
    x = torch.randn((1, seq_len, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)

    def once(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        devices.synchronize(dev)
        return time.perf_counter() - t0

    def timed(fn, *args):
        once(fn, *args)                           # warm
        return statistics.median(once(fn, *args) for _ in range(iters))

    def block(p, x):
        return tfm.block_forward(p, cfg, x, kind, backend=backend)[0]

    @torch.no_grad()
    def fwd(p, x):
        return block(p, x)

    def grad(p, x, wrt):
        return torch.autograd.grad(block(p, x).float().sum(), wrt)

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def span(fn, *args, hold=0):
        # one call's time on the device's own clock where it has one, its
        # launches queued behind ``hold`` cycles of a sleeping device: the
        # host's clock adds the jitter of a shared CPU to the difference,
        # and so does the device's where it waits on the host's launches
        # (a small block's backward, whose weight-gradient products then
        # hide in the host's cadence)
        if dev.type != "cuda":
            return once(fn, *args)
        start, end = events()
        devices.synchronize(dev)
        torch.cuda._sleep(hold)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def holding(fn, *args):
        # the sleep that outlasts the host's launches of ``fn``: twice its
        # slower warm call's launch time on the host, plus 1 ms, in cycles
        # of the sleep kernel as this device runs them (none on the CPU,
        # warmed by one call)
        if dev.type != "cuda":
            fn(*args)
            return 0
        launch = []
        for _ in range(2):
            t0 = time.perf_counter()
            fn(*args)
            launch.append(time.perf_counter() - t0)
            devices.synchronize(dev)
        probe = 10_000_000
        start, end = events()
        start.record()
        torch.cuda._sleep(probe)
        end.record()
        end.synchronize()
        rate = probe / (start.elapsed_time(end) / 1e3)
        return int(rate * (2 * max(launch) + 1e-3))

    t_fwd = timed(fwd, blk, x)
    pg = tree_map(lambda t: t.detach().requires_grad_(), blk)
    xg = x.detach().requires_grad_()
    full = tree_leaves(pg) + [xg]
    t_bwd = timed(grad, pg, xg, full)
    # wgrad time is the FULL backward minus the dgrad-only one, both run
    # on one retained graph: the forward, the same in both, stays out of
    # the difference, and the dgrad-only backward skips the weights'
    # products (autograd computes only what its inputs need).  A block's
    # wgrad is a few percent of its backward (a moe block's ~3%), below the
    # spread of two whole steps, so the median is taken of each pair's
    # difference, the pair's order alternating so that neither pass always
    # runs first.  Clamped, as noise can still push it past either end.
    # t_dgrad is the input-only backward of the same pairs
    y = block(pg, xg).float().sum()
    back = lambda wrt: torch.autograd.grad(y, wrt, retain_graph=True)
    hold = holding(back, full)                    # warm
    back([xg])
    diffs, dgrads = [], []
    for i in range(iters):
        if i % 2:
            d = span(back, [xg], hold=hold)
            b = span(back, full, hold=hold)
        else:
            b = span(back, full, hold=hold)
            d = span(back, [xg], hold=hold)
        diffs.append(b - d)
        dgrads.append(d)
    t_wgrad = min(max(statistics.median(diffs), 0.0), t_bwd)
    t_dgrad = statistics.median(dgrads)
    del y, back
    frac = t_wgrad / t_bwd if t_bwd > 0 else 0.5

    prof = {"t_fwd": t_fwd, "t_bwd": t_bwd, "t_recomp": t_fwd,
            "t_dgrad": t_dgrad, "t_wgrad": t_wgrad,
            "wgrad_frac": min(max(frac, 0.05), 0.95),
            "backend": backend}
    del blk, pg, x, xg
    prof.update(_measure_kernel_times(cfg, seq_len, backend, timed, dev))
    prof["t_decode"] = _measure_decode_step(cfg, seq_len, backend, timed, dev)
    return prof


@torch.no_grad()
def _measure_kernel_times(cfg: ModelConfig, S: int, backend: str, timed,
                          dev: torch.device) -> Dict[str, float]:
    """Per-kernel wall times on the requested backend: attention,
    rmsnorm, and (for SSM/hybrid archs) the SSD scan.  These are the
    hot-path primitives the CUDA kernels replace; per-kernel deltas
    localize where a chip's measured profile diverges from the
    analytic roofline."""
    import torch.nn.functional as F
    from ..kernels import ops as kops
    from ..models import attention as attn_lib, layers

    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *shape, dtype=torch.float32: torch.randn(
        shape, generator=gen, device=dev, dtype=dtype)
    out: Dict[str, float] = {}

    H, hd = cfg.num_heads, cfg.head_dim
    q, k, v = (randn(1, S, H, hd, dtype=torch.bfloat16) for _ in range(3))
    pos = torch.arange(S, device=dev)
    if backend == "kernel":
        attn = lambda q, k, v: kops.flash_attention(q, k, v)
    else:
        attn = lambda q, k, v: attn_lib.attend(q, k, v, q_pos=pos, k_pos=pos,
                                               backend="einsum")
    out["t_attn"] = timed(attn, q, k, v)
    del q, k, v

    xr = randn(S, cfg.d_model, dtype=torch.bfloat16)
    sc = torch.ones((cfg.d_model,), dtype=torch.bfloat16, device=dev)
    if backend == "kernel":
        rn = lambda x, s: kops.rmsnorm(x, s)
    else:
        rn = lambda x, s: layers.apply_norm({"scale": s}, x, "rmsnorm")
    out["t_rmsnorm"] = timed(rn, xr, sc)

    if cfg.family in ("ssm", "hybrid"):
        from ..models.ssm import ssd_chunked
        nh, p = cfg.ssm_nheads, cfg.ssm_headdim
        g, n = cfg.ssm_ngroups, cfg.ssm_state
        xs = randn(1, S, nh, p)
        dt = F.softplus(randn(1, S, nh)) * 0.5
        A = -torch.exp(randn(nh) * 0.3)
        Bm = randn(1, S, g, n) * 0.3
        Cm = randn(1, S, g, n) * 0.3
        chunk = min(cfg.ssm_chunk, S)
        if backend == "kernel":
            ssd = lambda *a: kops.ssd_scan(*a, chunk=chunk)[0]
        else:
            ssd = lambda *a: ssd_chunked(*a, chunk)[0]
        out["t_ssd"] = timed(ssd, xs, dt, A, Bm, Cm)
    return out


@torch.no_grad()
def _measure_decode_step(cfg: ModelConfig, seq_len: int, backend: str, timed,
                         dev: torch.device) -> float:
    """One single-token decode step (the whole model against a cache) on
    the requested backend — the serving hot path."""
    from ..models import model as M
    from ..training import serve_step as SS

    cache_len = min(max(int(seq_len), 32), 1024)
    step, _plan = SS.make_decode_step(cfg, cache_len, backend=backend)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    cache = SS.init_serve_cache(cfg, 1, cache_len, device=dev)
    tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    return timed(lambda p, c, t: step(p, c, t, cache_len - 1)[1],
                 params, cache, tok)
