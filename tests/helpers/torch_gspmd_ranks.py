"""Rank functions for ``tests/test_torch_gspmd.py``: the port's sharded
train step (``repro_torch.sharding.spmd``), its ZeRO-1 twin
(``repro_torch.training.manual_dp``) and the launcher's grid path, run by
``repro_torch.launch.ranks.spawn`` on gloo CPU ranks.  This module
imports nothing of JAX, so the ranks start quickly; the test holds what
they return against the JAX package."""
from __future__ import annotations

import os
from unittest import mock

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpointing.io import CheckpointReader, save_checkpoint
from repro_torch.comm.p2p import P2P
from repro_torch.launch import train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.sharding import spmd
from repro_torch.training import manual_dp
from repro_torch.training.train_step import train_state_from
from repro_torch.tree import flatten, tree_leaves

CPU = torch.device("cpu")


def _layout(model, data):
    mesh, grid = make_local_mesh(model=model, data=data, transport="host", device=CPU)
    return spmd.Layout(mesh, grid)


def _blocks_of(tree, layout, specs):
    """This rank's blocks of the state whose parameters are ``tree`` (numpy,
    the JAX package's) and whose optimizer state is fresh."""
    params = bridge.params_from_numpy(tree, CPU)
    full = train_state_from(params, adamw.init_opt_state(params), 0)
    flat = flatten({"0": full.params, "1": full.opt_state, "2": torch.tensor(0)})
    return spmd.shard_state(flat.__getitem__, layout, specs, device=CPU)


def _step(cfg, layout, opt, accum, mode):
    if mode == "manual":
        step, specs = manual_dp.make_manual_dp_train_step(cfg, layout, opt,
                                                          accum_steps=accum)
        return step, specs
    step = spmd.make_train_step(cfg, layout, opt, accum_steps=accum)
    return step, step.specs


class _FirstGrads:
    """``adamw.apply_update`` that keeps the gradient blocks of its first
    call (the step's reduced gradient on this rank's blocks)."""

    def __init__(self):
        self.grads, self.update = None, adamw.apply_update

    def __call__(self, cfg, opt_state, grads, *args, **kw):
        if self.grads is None:
            self.grads = flatten(grads)
        return self.update(cfg, opt_state, grads, *args, **kw)


def train_cases(rank, world, cases, opt_fields):
    """Each case ``(name, cfg fields, params tree, batches, model, data,
    accum, mode)``: a grid of that shape, the state cut from the tree,
    one step a batch.  Returns per case the metrics of each step, the
    whole parameters after the first step and the whole gradient that
    step applied (rank 0), the rank's persistent bytes with their closed
    form and its optimizer bytes, its grid coordinate (d, k), and the
    last step's collectives (bytes and calls by axis and kind)."""
    opt = adamw.AdamWConfig(**opt_fields)
    out = {}
    for name, fields, tree, batches, model, data, accum, mode in cases:
        cfg = ModelConfig(**fields)
        layout = _layout(model, data)
        step, specs = _step(cfg, layout, opt, accum, mode)
        state = _blocks_of(tree, layout, specs)
        rows = spmd.local_rows(len(batches[0]["tokens"]), layout, accum).numpy()
        metrics, params1, grads1 = [], None, None
        first = _FirstGrads()
        for i, b in enumerate(batches):
            local = {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in b.items()}
            with mock.patch.object(adamw, "apply_update", first):
                state, m = step(state, local)
            metrics.append(m)
            if i == 0:
                full = spmd.full_state(state, layout, specs).params
                gspecs = flatten(specs.opt_state["master"])
                with torch.no_grad():
                    grads = {p: layout.gather(g, gspecs[p]) for p, g in first.grads.items()}
                params1, grads1 = (flatten(full), grads) if rank == 0 else (None, None)
        out[name] = {"metrics": metrics, "params1": params1, "grads1": grads1,
                     "state_bytes": spmd.state_bytes(state),
                     "block_bytes": sum(spmd.block_bytes(cfg, layout, specs).values()),
                     "opt_bytes": sum(t.numel() * t.element_size()
                                      for t in tree_leaves(state.opt_state)),
                     "coord": (layout.grid.d, layout.grid.k), "stats": step.stats}
    return out


def init_blocks(rank, world, cases):
    """Each case ``(name, cfg fields, model, data, mode, seed)``: this
    rank's blocks from ``spmd.init_state`` (the seeded single-device
    initialisation cut leaf by leaf), flattened, with the rank's grid
    coordinates and its persistent bytes and their closed form."""
    out = {}
    for name, fields, model, data, mode, seed in cases:
        cfg = ModelConfig(**fields)
        layout = _layout(model, data)
        specs = manual_dp.state_specs(cfg, layout.mesh)[0] if mode == "manual" \
            else spmd.state_specs(cfg, layout.mesh)
        state = spmd.init_state(cfg, layout, specs, torch.Generator().manual_seed(seed),
                                device=CPU)
        out[name] = {"params": flatten(state.params),
                     "opt": {k: flatten(state.opt_state[k]) for k in ("master", "m", "v")},
                     "coord": (layout.grid.d, layout.grid.k),
                     "state_bytes": spmd.state_bytes(state),
                     "block_bytes": sum(spmd.block_bytes(cfg, layout, specs).values())}
    return out


def checkpoint_case(rank, world, fields, tree, batches, opt_fields, ckpt_dir):
    """One step on the 2 x 2 grid from the tree, a single-device
    checkpoint written from it (rank 0), then the next batch's loss on
    the 2 x 2 grid itself and on a (4, 1) grid resumed from the
    checkpoint."""
    cfg, opt = ModelConfig(**fields), adamw.AdamWConfig(**opt_fields)
    rows = lambda layout: spmd.local_rows(len(batches[0]["tokens"]), layout).numpy()
    local = lambda b, layout: {k: torch.from_numpy(np.ascontiguousarray(v[rows(layout)]))
                               for k, v in b.items()}
    layout = _layout(2, 2)
    step = spmd.make_train_step(cfg, layout, opt)
    state = _blocks_of(tree, layout, step.specs)
    state, _ = step(state, local(batches[0], layout))
    full = spmd.full_state(state, layout, step.specs)
    if rank == 0:
        save_checkpoint(ckpt_dir, full, step=1)
    torch.distributed.barrier()
    _, m_grid = step(state, local(batches[1], layout))
    layout4 = _layout(1, 4)
    step4 = spmd.make_train_step(cfg, layout4, opt)
    with CheckpointReader(ckpt_dir) as read:
        resumed = spmd.shard_state(read, layout4, step4.specs, device=CPU)
    at = resumed.step
    _, m4 = step4(resumed, local(batches[1], layout4))
    return {"grid": m_grid["loss"], "grid41": m4["loss"], "step": at}


def launcher(rank, world, argv, fields):
    """``repro_torch.launch.train.main(argv)`` in this rank (the launcher
    joins the ranks' process group), its smoke config replaced by the
    fp32 ``fields``."""
    cfg = ModelConfig(**fields)
    with mock.patch.object(train, "get_smoke_config", lambda name: cfg):
        res = train.main(argv)
    return {k: res[k] for k in ("losses", "mode", "state_bytes", "block_bytes", "grid",
                                "stats")} | {"files": sorted(os.listdir(argv[argv.index(
                                    "--run-dir") + 1]))}


def member_tensor(rank, members, dim, dtype):
    """Rank ``rank``'s seeded tensor for a reduce-scatter of ``members``
    members along ``dim`` (two rows of each member's slice there)."""
    shape = [3, 5]
    shape[dim] = 2 * members
    g = torch.Generator().manual_seed(100 * members + 10 * dim + rank)
    return torch.randn(shape, generator=g).mul_(1 + rank).to(dtype)


def reduce_scatter_case(rank, world):
    """``P2P.reduce_scatter_`` on the host transport at every member count
    from 3 to ``world`` (ranks 0..n-1 in a group of their own; the world
    at n = ``world``): this rank's slice of each ``member_tensor`` sum,
    fp32 and bf16, along dims 0 and 1, by ``"n/dtype/dim"``."""
    groups = {n: torch.distributed.new_group(list(range(n))) for n in range(3, world)}
    out = {}
    for n in range(3, world + 1):
        if rank >= n:
            continue
        comm = P2P("host", CPU, groups.get(n))
        for dtype in (torch.float32, torch.bfloat16):
            for dim in (0, 1):
                t = member_tensor(rank, n, dim, dtype)
                out[f"{n}/{dtype}/{dim}"] = comm.reduce_scatter_(t, dim)
    return out


def run_all(rank, world, jobs):
    """Each ``(name, function name, args)`` of ``jobs`` in turn, on the
    same ranks; their results by name."""
    return {name: globals()[fn](rank, world, *args) for name, fn, args in jobs}
