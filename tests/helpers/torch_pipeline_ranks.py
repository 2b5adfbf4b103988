"""Rank functions for the port's multi-rank pipeline tests
(``tests/test_torch_heteropp.py``, ``tests/test_torch_heteropp_grid.py``,
``tests/test_torch_heteropp_hetero.py``, ``tests/test_torch_obs.py``), run by
``repro_torch.launch.ranks.spawn`` on gloo CPU ranks.  This module
imports nothing of JAX, so the ranks start quickly; the test holds what
they return against the JAX package."""
from __future__ import annotations

import dataclasses
from unittest import mock

import torch
import torch.distributed

from repro_torch import bridge
from repro_torch.comm.p2p import Grid
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
    grid = Grid.build("host", CPU, pipe=world)
    out = {}
    for name in schedules:
        spec = schedule_spec(name, phys, toks.shape[0], recompute)
        state = _state(params, cfg, spec, rank)
        loss_fn = HP.make_pipeline_loss(cfg, spec, grid)
        loss, grads = loss_fn(state.params, toks)
        grads = HP.make_grad_sync(spec, grid, "psum")(
            grads, HP.zero1_dims(state.params, spec, "psum"))
        out[name] = {"loss": float(loss), "grads": grads,
                     "ticks": loss_fn.stats["ticks"],
                     "p2p_bytes": loss_fn.stats["p2p_bytes"]}
    if train_opt is not None:
        spec = schedule_spec(schedules[0], phys, toks.shape[0], recompute)
        state = _state(params, cfg, spec, rank)
        step = HP.make_pipeline_train_step(cfg, spec, grid,
                                           adamw.AdamWConfig(**train_opt))
        state, m = step(state, toks)
        out["train"] = {"params": tree_map(lambda t: t.detach(), state.params),
                        "m": state.opt_state["m"], "master": state.opt_state["master"],
                        "loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"])}
    return out


# the dp sync modes of the grid tests: (grad_sync, bucket_bytes); the
# wide buckets hold every leaf of a smoke config's group together
SYNC_MODES = {"psum": ("psum", 0), "psum_bucketed": ("psum", 200_000),
              "psum_bucketed_wide": ("psum", 4_000_000),
              "reduce_scatter": ("reduce_scatter", 0)}


def grid_cases(rank, world, jobs):
    """For each job ``(grid_shape, cases, train_opt)``, on a (dp, pipe, tp)
    grid of ``world`` ranks (every job's grid is built first, in one order
    on every rank), for each case (a dict of ``cfg`` fields, numpy
    ``tree``, ``tokens`` (D·b, mb, S), ``phys`` split and sync ``modes``)
    and each mode: the pipeline loss and this rank's gradient tree after
    the dp sync (ZeRO-1 slices under ``reduce_scatter``) with its ZeRO-1
    dims (-1: whole); with ``train_opt`` (``AdamWConfig`` fields) also
    the rank's parameters, first moment, master weights and metrics after
    one train step.  A case with a ``domain`` (its uneven batch domain)
    carries its tokens in the tight layout, Σ allocations microbatches;
    under ``psum`` it also runs them in the padded layout, and again with
    the pad slots overwritten (``padded``, ``clobbered``: loss and
    gradient).  Returns one list of case results a job."""
    grids = [Grid.build("host", CPU, dp=D, pipe=S, tp=T) for (D, S, T), _, _ in jobs]
    return [[_grid_case(grid, case, train_opt) for case in cases]
            for grid, (_, cases, train_opt) in zip(grids, jobs)]


def _grid_case(grid, case, train_opt):
    D, S, T = grid.D, grid.S, grid.T
    cfg = ModelConfig(**case["cfg"])
    params = bridge.params_from_numpy(case["tree"], CPU)
    toks = torch.from_numpy(case["tokens"])
    domain = tuple(case.get("domain") or ())
    res = {"grid": [grid.d, grid.s, grid.k]}
    for mode in case["modes"]:
        grad_sync, bucket = SYNC_MODES[mode]
        spec = HP.PipelineSpec(S, tuple(case["phys"]),
                               max(domain) if domain else toks.shape[0] // D,
                               tensor_parallel=T, data_parallel=D, bucket_bytes=bucket,
                               batch_domain=domain)
        local = HP.local_stage_params(params, cfg, spec, grid.s, grid.k)
        state = train_state_from(local, HP.stage_opt_state(local, spec, grid, grad_sync), 0)
        loss_fn = HP.make_pipeline_loss(cfg, spec, grid)
        loss, grads = loss_fn(state.params, toks)
        ticks = loss_fn.stats["ticks"]
        dims = HP.zero1_dims(state.params, spec, grad_sync)
        grads = HP.make_grad_sync(spec, grid, grad_sync)(grads, dims)
        r = {"loss": float(loss), "grads": grads, "ticks": ticks,
             "dims": tree_map(lambda d: -1 if d is None else d, dims)}
        if domain and mode == "psum":
            padded = HP.prepare_domain_tokens(spec, toks)
            pad = torch.tensor([j >= a for a in domain for j in range(max(domain))])
            clobbered = padded.clone()
            clobbered[pad] = (padded[pad] + 7) % cfg.vocab_size
            for name, t in (("padded", padded), ("clobbered", clobbered)):
                loss_p, grads_p = loss_fn(state.params, t)
                r[name] = {"loss": float(loss_p), "grads": HP.make_grad_sync(
                    spec, grid, grad_sync)(grads_p, dims)}
        if train_opt is not None:
            step = HP.make_pipeline_train_step(cfg, spec, grid,
                                               adamw.AdamWConfig(**train_opt),
                                               grad_sync=grad_sync)
            state, m = step(state, toks)
            r["train"] = {"params": tree_map(lambda t: t.detach(), state.params),
                          "m": state.opt_state["m"], "master": state.opt_state["master"],
                          "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        res[mode] = r
    return res


def grouped_cases(rank, world, layouts, cases, train_opt):
    """On the grouped layout of each ``stage_tp`` in ``layouts`` (Σ tp_s =
    ``world``; every layout is built first, in one order on every rank),
    for each case (``cfg`` fields, numpy ``tree``, ``tokens`` (b, mb, S),
    ``phys`` split) and each reshard strategy of ``case["strategies"]``:
    the pipeline loss, this rank's gradient tree after the sync, and with
    ``train_opt`` (``AdamWConfig`` fields) the rank's parameters, first
    moment and metrics after one train step.  Then the reshard alone on
    each layout: a (2, 3, width) activation, 100·rank + column on stage 0's
    members, moved to stage 1 and back under each strategy, with the bytes
    this rank sent and gathered.  Returns one dict a layout, keyed
    ``"<case> <strategy>"``."""
    from repro_torch.core import resharding as RS
    grids = [Grid.grouped("host", CPU, st) for st in layouts]
    out = []
    for st, grid in zip(layouts, grids):
        res = {"grid": [grid.s, grid.k]}
        for i, case in enumerate(cases):
            cfg = ModelConfig(**case["cfg"])
            params = bridge.params_from_numpy(case["tree"], CPU)
            toks = torch.from_numpy(case["tokens"])
            for strategy in case["strategies"]:
                spec = HP.PipelineSpec(len(st), tuple(case["phys"]), toks.shape[0],
                                       stage_tp=tuple(st), reshard=(strategy,))
                state = train_state_from(
                    HP.local_stage_params(params, cfg, spec, grid.s, grid.k), None, 0)
                state.opt_state = HP.stage_opt_state(state.params, spec, grid, "psum")
                loss_fn = HP.make_pipeline_loss(cfg, spec, grid)
                loss, grads = loss_fn(state.params, toks)
                grads = HP.make_grad_sync(spec, grid, "psum")(
                    grads, HP.zero1_dims(state.params, spec, "psum"))
                r = {"loss": float(loss), "grads": grads, "stats": dict(loss_fn.stats)}
                if train_opt is not None:
                    step = HP.make_pipeline_train_step(cfg, spec, grid,
                                                       adamw.AdamWConfig(**train_opt))
                    state, m = step(state, toks)
                    r["train"] = {"params": tree_map(lambda t: t.detach(), state.params),
                                  "m": state.opt_state["m"], "loss": float(m["loss"]),
                                  "grad_norm": float(m["grad_norm"])}
                res[f"{i} {strategy}"] = r
        width = 6
        like = torch.empty(2, 3, width)
        src, dst = grid.stage_ranks(0), grid.stage_ranks(1)
        for strategy in ("sr_ag", "naive"):
            b = RS.Boundary(src, dst, strategy)
            x = (100.0 * rank + torch.arange(width).float()).expand(2, 3, width) \
                if rank in src else None
            grid.boundary.reset_counts()
            if grid.tp is not None:
                grid.tp.reset_counts()
            there = RS.reshard(x, grid.boundary, b, gather=grid.tp, like=like)
            back = RS.reshard(there, grid.boundary, b.reversed(), gather=grid.tp, like=like)
            res[f"reshard {strategy}"] = {
                "there": there, "back": back, "bytes": grid.boundary.bytes_sent,
                "gathered": grid.tp.gather_bytes if grid.tp is not None else 0}
        out.append(res)
    return out


def subgroup_collectives(rank, world):
    """On the (dp 1, pipe 2, tp 2) and (dp 2, pipe 2, tp 1) grids of four
    ranks: what each rank receives when the members of its pipe group
    swap their global ranks (``P2P.ppermute`` names peers by group rank),
    and a reduce-scatter and an fp32 and a bf16 all-gather on dim 1 over
    its tp or dp group."""
    out = {}
    for shape in ((1, 2, 2), (2, 2, 1)):
        D, S, T = shape
        grid = Grid.build("host", CPU, dp=D, pipe=S, tp=T)
        x = torch.full((3,), float(rank))
        got, = grid.pipe.ppermute([(x, [(0, 1), (1, 0)])], x)
        other = grid.tp if T > 1 else grid.dp
        t = torch.arange(8.0).reshape(2, 4) + 10 * rank
        part = other.reduce_scatter_(t, 1)
        full = torch.empty(2, 4)
        other.all_gather_(full, part * 0 + other.rank, 1)
        half = torch.empty(2, 4, dtype=torch.bfloat16)
        other.all_gather_(half, (part * 0 + other.rank + 0.5).bfloat16(), 1)
        out[str(shape)] = {"got": got, "part": part, "gathered": full,
                           "gathered_bf16": half, "group": other.global_ranks}
    return out


def trace_cases(rank, world, grid_shape, cases):
    """On a (dp, pipe, tp) grid of ``world`` ranks, for each case (``cfg``
    fields, numpy ``tree``, ``tokens``, ``phys`` split, ``schedule``, an
    optional uneven batch ``domain``): ``obs.runtime.trace_pipeline``'s
    trace (None off rank 0); with ``clock_parity`` also the loss and this
    rank's gradient tree of ``make_pipeline_loss`` without a clock and
    with the fenced one, on the same parameters and tokens."""
    from repro_torch.obs.runtime import fenced_clock, trace_pipeline
    from repro_torch.tree import flatten
    D, S, T = grid_shape
    grid = Grid.build("host", CPU, dp=D, pipe=S, tp=T)
    out = []
    for case in cases:
        cfg = ModelConfig(**case["cfg"])
        params = bridge.params_from_numpy(case["tree"], CPU)
        toks = torch.from_numpy(case["tokens"])
        sched = get_schedule(case["schedule"])
        domain = tuple(case.get("domain") or ())
        spec = HP.PipelineSpec(S, HP.chunk_layer_counts(case["phys"], sched),
                               max(domain) if domain else toks.shape[0] // D,
                               schedule=sched.name, n_chunks=sched.n_chunks,
                               tensor_parallel=T, data_parallel=D, batch_domain=domain)
        local = HP.local_stage_params(params, cfg, spec, grid.s, grid.k)
        for t in flatten(local).values():
            t.requires_grad_()
        r = {"trace": trace_pipeline(cfg, spec, grid, local, toks)}
        if case.get("clock_parity"):
            for name, clock in (("untraced", None), ("traced", fenced_clock(CPU))):
                loss, grads = HP.make_pipeline_loss(cfg, spec, grid, clock=clock)(local, toks)
                r[name] = {"loss": loss, "grads": grads}
        out.append(r)
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
