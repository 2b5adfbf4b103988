"""Rank functions for the port's multi-rank pipeline tests
(``tests/test_torch_heteropp.py``), run by
``repro_torch.launch.ranks.spawn`` on gloo CPU ranks.  This module
imports nothing of JAX, so the ranks start quickly; the test holds what
they return against the JAX package."""
from __future__ import annotations

import dataclasses
from unittest import mock

import torch
import torch.distributed

from repro_torch import bridge
from repro_torch.comm.p2p import P2P
from repro_torch.configs import get_smoke_config
from repro_torch.core import heteropp as HP
from repro_torch.core.schedules import get_schedule
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.training.train_step import train_state_from
from repro_torch.tree import tree_map

CPU = torch.device("cpu")


def schedule_spec(name, phys, b, recompute=()):
    sched = get_schedule(name)
    return HP.PipelineSpec(len(phys), HP.chunk_layer_counts(phys, sched), b,
                           tuple(recompute), schedule=sched.name,
                           n_chunks=sched.n_chunks)


def _state(params, cfg, spec, rank):
    local = HP.local_stage_params(params, cfg, spec, rank)
    return train_state_from(local, adamw.init_opt_state(local), 0)


def loss_and_grads(rank, world, cfg_fields, tree, tokens, phys, schedules,
                   recompute=(), train_opt=None):
    """For each schedule: the pipeline loss and this rank's gradient tree
    (and, with ``train_opt`` a dict of ``AdamWConfig`` fields, the rank's
    parameters after one train step under the first schedule)."""
    cfg = ModelConfig(**cfg_fields)
    params = bridge.params_from_numpy(tree, CPU)
    toks = torch.from_numpy(tokens)
    p2p = P2P("host", CPU)
    out = {}
    for name in schedules:
        spec = schedule_spec(name, phys, toks.shape[0], recompute)
        state = _state(params, cfg, spec, rank)
        loss_fn = HP.make_pipeline_loss(cfg, spec, p2p)
        loss, grads = loss_fn(state.params, toks)
        out[name] = {"loss": float(loss), "grads": grads,
                     "ticks": loss_fn.stats["ticks"],
                     "p2p_bytes": loss_fn.stats["p2p_bytes"]}
    if train_opt is not None:
        spec = schedule_spec(schedules[0], phys, toks.shape[0], recompute)
        state = _state(params, cfg, spec, rank)
        step = HP.make_pipeline_train_step(cfg, spec, p2p,
                                           adamw.AdamWConfig(**train_opt))
        state, m = step(state, toks)
        out["train"] = {"params": tree_map(lambda t: t.detach(), state.params),
                        "m": state.opt_state["m"], "master": state.opt_state["master"],
                        "loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"])}
    return out


def fp32_smoke_config(name):
    """The smoke config in float32, where the pipeline and the single
    device agree to 1e-5 (in bfloat16 three steps drift by rounding)."""
    return dataclasses.replace(get_smoke_config(name), dtype="float32")


def launcher_rank(rank, world, argv):
    """One rank of a job started outside the launcher: ``train.main`` in a
    process that has joined the process group already, on the fp32 smoke
    config."""
    from repro_torch.launch import train
    with mock.patch.object(train, "get_smoke_config", fp32_smoke_config):
        res = train.main(argv)
    return {"losses": res["losses"], "mode": res["mode"], "rank": res["rank"]}


def failing_rank(rank, world):
    """Rank 1 raises; rank 0 waits for it in a barrier."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.barrier()
    return rank
