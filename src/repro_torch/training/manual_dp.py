"""Manual-collective data parallelism: ZeRO-1 with one reduce-scatter and
one all-gather per parameter per step (the counterpart of
``repro/training/manual_dp.py``).

Under plain GSPMD (``sharding.spmd``) FSDP-sharded weight gradients are
reduced across the data axis once per microbatch per layer.  This is the
textbook ZeRO-1 schedule instead:

  1. each data rank accumulates LOCAL gradients over its microbatches
     (no cross-data traffic),
  2. one reduce-scatter per parameter at step end, over the data ranks,
     at the leaf's ``_scatter_dim`` (a mean over them where it has none),
  3. the optimizer updates only the rank's shard of (master, m, v),
  4. one all-gather over the data ranks rebuilds the parameter.

Parameters are placed by the rules with ``fsdp=False`` (sharded over the
model axis only; replicated over data), and master / m / v are also
sharded over the data axes at ``_scatter_dim``, so each rank's optimizer
bytes equal the JAX package's (``state_specs``).  At model > 1 the
blocks run the sharded step's member shares of every family
(``spmd.Gather`` over the model axis alone).  The loss is each data
rank's ``loss_fn`` on its own rows, averaged over the ranks, as in the
JAX package (a moe model's load-balance loss is each rank's own, where
GSPMD's is the global batch's).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.dataparallel.grad_sync import replica_grad_norm, zero1_scatter_dim
from ..models import model as M
from ..models.config import ModelConfig
from ..optim import adamw
from ..sharding import rules, spmd
from ..tree import flatten
from .train_step import TrainState

# inside the manual-DP region the batch is already local: "batch" rules are
# identity; model-axis rules stay active
MANUAL_RULES = {
    "batch": None, "seq": None, "seq_model": "model", "model": "model",
    "heads": "model", "expert": "model", "data_only": None, "none": None,
}


def _scatter_dim(shape: Tuple[int, ...], dp: int) -> Optional[int]:
    """First dim divisible by the data-parallel degree (ZeRO-1 shard dim)."""
    return zero1_scatter_dim(shape, dp)


def state_specs(cfg: ModelConfig, mesh) -> Tuple[TrainState, Dict[str, Optional[int]]]:
    """(the state's specs, each leaf's ``_scatter_dim``): parameters by the
    rules with ``fsdp=False``; master / m / v the same with the data axes
    added at the scatter dim (after the model axis where both shard it)."""
    da = rules.data_axes(mesh)
    dp = 1
    for a in da:
        dp *= mesh.shape[a]
    params_shape = M.abstract_params(cfg)
    pspecs = rules.tree_param_specs(params_shape, mesh, fsdp=False)
    dims = {p: _scatter_dim(tuple(t.shape), dp) for p, t in flatten(params_shape).items()}
    flat_p = flatten(pspecs)

    def opt_spec(path):
        parts, dim = list(flat_p[path]), dims[path]
        if dim is not None:
            parts[dim] = rules.entry_axes(parts[dim]) + da
        return rules.spec_of(*parts)

    ospecs = spmd._unflatten({p: opt_spec(p) for p in sorted(flat_p)})
    return (TrainState(params=pspecs, opt_state={"master": ospecs, "m": ospecs, "v": ospecs},
                       step=()), dims)


def make_manual_dp_train_step(cfg: ModelConfig, layout: "spmd.Layout",
                              opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                              accum_steps: int = 1, accum_dtype: str = "float32",
                              remat: bool = True, remat_policy=None,
                              backend: str = "auto", read_metrics: bool = True):
    """Returns (train_step, state_specs).  ``train_step(state, batch)``
    takes this rank's blocks (``spmd.init_state(cfg, layout, state_specs,
    ...)``) and its rows of the batch (``spmd.local_rows``) and keeps the
    sharded step's contract (``accum_dtype``, ``read_metrics`` and
    ``remat_policy`` as there), with the data-parallel reduction done by hand: one
    reduce-scatter + one all-gather per parameter per step.
    ``train_step.stats`` holds the step's collectives by axis and the
    parts computed whole (``spmd.whole_parts``)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    specs, dims = state_specs(cfg, layout.mesh)
    pspecs = flatten(specs.params)
    ospecs = flatten(specs.opt_state["master"])
    shapes = {p: tuple(t.shape) for p, t in flatten(M.abstract_params(cfg)).items()}
    gather = spmd.Gather(cfg, layout, pspecs, shapes, data=False)
    names = sorted(pspecs)
    shard_specs = [ospecs[p] for p in names]
    dp, comm = layout.data, layout.grid.dp
    for p in names:
        if dims[p] is not None:
            layout.block_slices(ospecs[p], shapes[p])    # raises where a block is uneven

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        layout.reset_counts()
        grads, vec, metric_names = spmd.grads_and_metrics(
            cfg, state, batch, gather, accum_steps=accum_steps, remat=remat,
            remat_policy=remat_policy, accum_dtype=accum_dtype, backend=backend,
            scale=1.0)
        with torch.no_grad():
            if comm is not None:
                comm.all_reduce_(vec).div_(dp)
            # one reduce-scatter per parameter (a mean where it has no dim)
            shards = []
            for p, g in zip(names, grads):
                g = g.contiguous()
                if comm is None:
                    shards.append(g.clone())
                elif dims[p] is None:
                    shards.append(comm.all_reduce_(g.clone()).div_(dp))
                else:
                    shards.append(comm.reduce_scatter_(g, dims[p]).div_(dp))
            # the global norm from the shards, each counted once
            gnorm = replica_grad_norm(shards, shard_specs, dict(layout.mesh.shape),
                                      layout.grid.world.all_reduce_)
            # shard-local AdamW, then one all-gather per parameter
            flat_params = flatten(state.params)
            new = {p: torch.empty(g.shape, dtype=flat_params[p].dtype, device=g.device)
                   for p, g in zip(names, shards)}
            gtree = spmd._unflatten(dict(zip(names, shards)))
            _, _, opt_m = adamw.apply_update(opt_cfg, state.opt_state, gtree, state.step,
                                             spmd._unflatten(new), grad_norm=gnorm)
            for p in names:
                if comm is None or dims[p] is None:
                    flat_params[p].copy_(new[p])
                else:
                    comm.all_gather_(flat_params[p], new[p], dims[p])
        state.step += 1
        train_step.stats = dict(layout.counts(), whole=dict(gather.whole))
        return state, spmd.read_out(metric_names, vec, opt_m, read_metrics)

    train_step.stats = {}
    train_step.specs = specs
    train_step.whole = dict(gather.whole)
    return train_step, specs


def optimizer_bytes(cfg: ModelConfig, layout: "spmd.Layout") -> int:
    """The closed form of a rank's optimizer bytes (fp32 master, m and v):
    each leaf's 12 bytes a parameter over its blocks under ``_scatter_dim``."""
    specs, _ = state_specs(cfg, layout.mesh)
    return sum(spmd.block_bytes(cfg, layout, specs)[k] for k in ("master", "m", "v"))
