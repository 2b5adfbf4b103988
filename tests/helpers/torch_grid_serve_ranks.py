"""Rank functions for ``tests/test_torch_grid_serve.py``: the port's
sharded serve steps (``repro_torch.sharding.spmd.make_prefill_step`` /
``make_decode_step``) on gloo CPU ranks started by
``repro_torch.launch.ranks.spawn``.  This module imports nothing of JAX,
so the ranks start quickly; the test holds what they return against the
JAX package's single-device serve steps."""
from __future__ import annotations

import torch

from repro_torch import bridge
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import spmd

CPU = torch.device("cpu")


def serve_cases(rank, world, cases):
    """Each case ``(name, cfg fields, params tree, batch, model, data,
    cache_len, seq_len, steps)``: a grid of that shape, the weights cut
    from the tree, a prefill of the rank's rows of ``batch`` and
    ``steps`` decode steps, each fed the last step's tokens.  Returns per
    case the rank's grid coordinate (d, k), its rows, the prefill's and
    each decode step's logits and tokens of those rows, its cache blocks
    after the last step with their bytes and closed form, and each
    step's collectives."""
    out = {}
    for name, fields, tree, batch, model, data, cache_len, seq_len, steps in cases:
        cfg = ModelConfig(**fields)
        mesh, grid = make_local_mesh(model=model, data=data, transport="host", device=CPU)
        layout = spmd.Layout(mesh, grid)
        B = batch["tokens"].shape[0]
        rows = spmd.local_rows(B, layout, serving=True)
        mine = {k: torch.from_numpy(v)[rows] for k, v in batch.items()}
        prefill = spmd.make_prefill_step(cfg, layout, cache_len, batch=B)
        params = spmd.tree_blocks(bridge.params_from_numpy(tree, CPU), layout, prefill.specs)
        logits, tok, cache = prefill(params, mine)
        res = {"coord": (grid.d, grid.k), "rows": rows, "logits": [logits], "tokens": [tok],
               "stats": [prefill.stats]}
        pos = mine["tokens"].shape[1] + cfg.num_prefix_tokens
        decode = spmd.make_decode_step(cfg, layout, seq_len, batch=B)
        for i in range(steps):
            logits, tok, cache = decode(params, cache, tok, pos + i)
            res["logits"].append(logits)
            res["tokens"].append(tok)
            res["stats"].append(decode.stats)
        res["cache"] = spmd.cache_leaves(cache)
        res["cache_bytes"] = spmd.cache_bytes(cache)
        res["cache_block_bytes"] = spmd.cache_block_bytes(cfg, layout, B, decode.plan[
            "cache_len"] or 1)
        out[name] = res
    return out


def reblock_cases(rank, world, cases):
    """Each case ``(name, shape, from spec, to spec, seed)`` on the (data
    2, model 2) grid: the rank's ``from`` block of a seeded whole leaf
    moved to its ``to`` block (``spmd.Layout.reblock``) and back.
    Returns per case the rank's grid coordinate, both results and the
    collectives of each move."""
    mesh, grid = make_local_mesh(model=2, data=2, transport="host", device=CPU)
    layout = spmd.Layout(mesh, grid)
    out = {}
    for name, shape, src, dst, seed in cases:
        whole = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
        layout.reset_counts()
        there = layout.reblock(layout.block(whole, src), src, dst, shape)
        stats = [layout.counts()]
        layout.reset_counts()
        back = layout.reblock(there, dst, src, shape)
        stats.append(layout.counts())
        out[name] = {"coord": (grid.d, grid.k), "there": there, "back": back,
                     "stats": stats}
    return out


def run_all(rank, world, jobs):
    """Each ``(name, function name, args)`` of ``jobs`` in turn, on the
    same ranks; their results by name."""
    return {name: globals()[fn](rank, world, *args) for name, fn, args in jobs}
