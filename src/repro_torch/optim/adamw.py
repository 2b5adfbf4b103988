"""AdamW with fp32 master weights (mixed-precision training): the
counterpart of ``repro/optim/adamw.py``.

The JAX optimizer is a pure transform that returns new trees; here the
master weights, moments and model parameters are updated IN PLACE
(``torch.no_grad``), which saves a second copy of the 12 bytes per
parameter of state, and the same (mutated) trees are returned.  All
arithmetic is elementwise fp32 on the parameters' device, in the JAX
order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..tree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup over ``warmup_steps``, then cosine decay to
    ``min_lr_ratio · lr`` at ``total_steps``; fp32 as in JAX."""
    s = _f32(step)
    warm = cfg.lr * (s + 1.0) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return float(warm if step < cfg.warmup_steps else cfg.lr * cos)


def init_opt_state(params: PyTree) -> PyTree:
    """fp32 master copy and zero first / second moments."""
    return {
        "master": tree_map(lambda p: p.detach().float().clone(), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
    }


def global_norm(tree: PyTree) -> torch.Tensor:
    """fp32 L2 norm over every leaf, as a 0-d tensor (no host sync)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply_update(opt_cfg: AdamWConfig, opt_state: PyTree, grads: PyTree,
                 step: int, params: PyTree, *, grad_norm=None):
    """Clip by the global norm, AdamW with bias correction, decoupled
    weight decay on every leaf (as the JAX optimizer applies it), then
    cast the master weights into ``params``.  Returns (params, opt_state,
    metrics) — the same trees, updated in place."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(opt_cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if opt_cfg.grad_clip > 0 else 1.0
    lr = lr_at(opt_cfg, step)
    b1, b2 = opt_cfg.b1, opt_cfg.b2
    bc1 = float(1 - _f32(b1) ** (step + 1))
    bc2 = float(1 - _f32(b2) ** (step + 1))

    def upd(master, m, v, g, p):
        g = g.float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(torch.square(g), alpha=1 - b2)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + opt_cfg.eps)
        if opt_cfg.weight_decay:
            delta = delta + opt_cfg.weight_decay * master
        master.sub_(lr * delta)
        p.copy_(master)

    tree_map(upd, opt_state["master"], opt_state["m"], opt_state["v"], grads,
             params)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
