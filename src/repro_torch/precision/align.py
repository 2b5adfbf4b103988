"""Bottom-up precision alignment pipeline (DiTorch §3.1.2, Fig. 5, Table 1;
the counterpart of ``repro/precision/align.py``).

Stage 1 — operator-level: every op in the standard suite is executed under
each chip backend and compared against the fp32 reference; ops whose error
exceeds the per-op tolerance are flagged.

Stage 2 — model-level: a model is trained for N iterations under each
backend on the SAME deterministic data stream; the Mean Relative Error of
the loss trajectory vs the reference must satisfy the paper's criterion

    MRE = (1/n) Σ |y_i − ŷ_i| / y_i  <  1.5%.

Every entry point runs on the card unless the caller passes
``device="cpu"``.  The fp32 regime is IEEE fp32: TF32 is turned off for
the harness's duration and the flags are restored afterwards
(``ieee_fp32``).  cuBLAS's reduced-precision reductions for fp16 and
bf16 products belong to the card's regime and stay at PyTorch's
defaults; ``regime_flags`` reports them beside the results.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import backends as B
from .. import device as device_lib
from ..data.pipeline import DataConfig, make_loader
from ..models.config import ModelConfig
from ..optim import adamw
from ..training.train_step import make_train_state, make_train_step, train_state_from
from ..tree import tree_map

MRE_CRITERION = 0.015


@dataclasses.dataclass
class OpReport:
    op: str
    backend: str
    max_rel_err: float
    passed: bool


@contextlib.contextmanager
def ieee_fp32():
    """fp32 products in IEEE fp32 (no TF32) inside the block, whatever
    the flags were; they are restored on the way out."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def regime_flags() -> Dict[str, object]:
    """The matmul flags that shape a regime's numerics on the card."""
    m = torch.backends.cuda.matmul
    return {"allow_tf32": m.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "allow_fp16_reduced_precision_reduction":
                m.allow_fp16_reduced_precision_reduction,
            "allow_bf16_reduced_precision_reduction":
                m.allow_bf16_reduced_precision_reduction}


def operator_sweep(tolerance: float = 0.1, seed: int = 0, *, device=None
                   ) -> List[OpReport]:
    """Stage 1: per-operator precision vs the fp32 reference backend.
    Each op draws its inputs once (a generator seeded with ``seed``) and
    every backend computes on those inputs."""
    dev = device_lib.resolve(device)
    ref_be = B.BACKENDS["a100_ref"]
    reports = []
    with ieee_fp32(), torch.no_grad():
        for op_name, probe in B.OPS.items():
            ins = probe.draw(torch.Generator(device=dev).manual_seed(seed), dev)
            ref = probe.body(ref_be, *ins).double()
            # error relative to the tensor's scale (RMS floor): near-zero
            # entries of a matmul output would otherwise blow up the ratio
            rms = float(ref.square().mean().sqrt())
            scale = ref.abs().clamp_min(max(rms, 1e-6))
            for be_name, be in B.BACKENDS.items():
                if be_name == "a100_ref":
                    continue
                out = probe.body(be, *ins).double()
                err = float(((out - ref).abs() / scale).max())
                reports.append(OpReport(op_name, be_name, err, err < tolerance))
    return reports


def loss_mre(losses: np.ndarray, ref_losses: np.ndarray) -> float:
    return float(np.mean(np.abs(losses - ref_losses) /
                         np.maximum(np.abs(ref_losses), 1e-9)))


def train_loss_curve(cfg: ModelConfig, *, dtype: str, iters: int = 50,
                     seed: int = 0, batch: int = 4, seq: int = 64, device=None,
                     params=None, times: Optional[list] = None) -> np.ndarray:
    """Train the model under one numerics regime on the deterministic
    stream; returns the loss trajectory.  The model is ``cfg`` in
    ``dtype``, its weights drawn from ``seed`` or, when ``params`` is
    given, those (e.g. the JAX package's, through ``repro_torch.bridge``;
    their leaves keep their dtypes).  ``times``, a list, gets each step's
    seconds on the host clock (the loss read, which waits for the device,
    included)."""
    dev = device_lib.resolve(device)
    mcfg = dataclasses.replace(cfg, dtype=dtype)
    with ieee_fp32():
        if params is None:
            state = make_train_state(mcfg, torch.Generator(device=dev).manual_seed(seed),
                                     device=dev)
        else:
            params = tree_map(lambda t: t.to(dev), params)
            state = train_state_from(params, adamw.init_opt_state(params), 0)
        step = make_train_step(mcfg, remat=False)
        src = make_loader(mcfg, DataConfig(batch_size=batch, seq_len=seq, seed=1234),
                          device=dev)
        losses = []
        for _ in range(iters):
            t0 = time.perf_counter()
            state, m = step(state, next(src))
            losses.append(float(m["loss"]))
            if times is not None:
                times.append(time.perf_counter() - t0)
    return np.asarray(losses)


def model_level_alignment(cfg: ModelConfig, *, iters: int = 50,
                          dtypes: Optional[List[str]] = None, device=None,
                          **curve_kw) -> Dict[str, float]:
    """Stage 2: MRE of loss trajectories of each chip regime vs fp32 ref.
    ``curve_kw`` (seed, batch, seq) goes to every ``train_loss_curve``."""
    dtypes = dtypes or ["bfloat16", "float16"]
    ref = train_loss_curve(cfg, dtype="float32", iters=iters, device=device, **curve_kw)
    out = {}
    for dt in dtypes:
        cur = train_loss_curve(cfg, dtype=dt, iters=iters, device=device, **curve_kw)
        out[dt] = loss_mre(cur, ref)
    return out
