"""Training step: loss -> grads -> AdamW update (the counterpart of
``repro/training/train_step.py`` on one device).

``TrainState`` holds the same three things as the JAX one (params,
optimizer state, step), with the step a Python int.  The parameters are
leaf tensors with ``requires_grad``; gradients come from
``torch.autograd.grad`` (nothing accumulates in ``.grad``), and the
update writes the new values into the same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..models import layers
from ..models import model as M
from ..models.config import ModelConfig
from ..optim import adamw
from ..tree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass
class TrainState:
    params: PyTree
    opt_state: PyTree
    step: int


def make_train_state(cfg: ModelConfig, generator: torch.Generator, *,
                     device) -> TrainState:
    params = M.init_params(cfg, generator, device=device)
    return train_state_from(params, adamw.init_opt_state(params), 0)


def abstract_train_state(cfg: ModelConfig) -> TrainState:
    """The state's names, shapes and dtypes on the meta device, nothing
    allocated: the counterpart of the JAX package's ``jax.eval_shape`` of
    ``make_train_state`` (its step is the int 0)."""
    params = M.abstract_params(cfg)
    return TrainState(params, adamw.init_opt_state(params), 0)


def train_state_from(params: PyTree, opt_state: PyTree, step: int) -> TrainState:
    """A state whose parameters are gradient leaves."""
    params = tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), params)
    return TrainState(params, opt_state, int(step))


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[adamw.AdamWConfig] = None,
                    *, remat: bool = True, remat_policy=None, backend: str = "auto",
                    accum_steps: int = 1, accum_dtype: str = "float32"):
    """``accum_steps`` > 1 splits the batch into that many microbatches
    along dim 0, run one after another, with the gradients summed in
    ``accum_dtype`` and averaged.  ``remat_policy`` (None or ``"dots"``)
    as ``models.model.loss_fn``'s.  Returns ``train_step(state, batch) ->
    (state, metrics)``; the metrics are 0-d tensors (reading one waits
    for the device)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    acc_dt = layers.DTYPES[accum_dtype]

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        loss, metrics = M.loss_fn(params, cfg, batch, remat=remat,
                                  remat_policy=remat_policy, backend=backend)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), metrics, tree_map(lambda _: next(it), params)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if accum_steps == 1:
            loss, metrics, grads = grads_of(state.params, batch)
        else:
            mbs = [{k: v.chunk(accum_steps, dim=0)[i] for k, v in batch.items()}
                   for i in range(accum_steps)]
            grads, loss, ms = None, 0.0, []
            for mb in mbs:
                l, m, g = grads_of(state.params, mb)
                g = tree_map(lambda t: t.to(acc_dt), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                loss = loss + l
                ms.append(m)
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
            metrics = {k: torch.stack([m[k].detach() for m in ms]).mean()
                       for k in ms[0]}
        _, _, opt_metrics = adamw.apply_update(
            opt_cfg, state.opt_state, grads, state.step, state.params)
        out = {"loss": loss, **{k: v.detach() for k, v in metrics.items()},
               **opt_metrics}
        state.step += 1
        return state, out

    return train_step


def make_eval_step(cfg: ModelConfig, *, backend: str = "auto"):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = M.loss_fn(params, cfg, batch, remat=False,
                                      backend=backend)
        return {"loss": loss, **metrics}
    return eval_step
