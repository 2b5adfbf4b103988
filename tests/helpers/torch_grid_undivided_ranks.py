"""Rank functions for ``tests/test_torch_grid_undivided.py``: the port's
grid at a model axis that does not divide a block's count, its train
step (``torch_gspmd_ranks.train_cases``) and its serve steps
(``torch_grid_serve_ranks.serve_cases``) on the same gloo ranks, started
by ``repro_torch.launch.ranks.spawn``.  This module imports nothing of
JAX; the test holds what the ranks return against the JAX package."""
from __future__ import annotations

import torch_grid_serve_ranks as S
import torch_gspmd_ranks as T

FUNCTIONS = {"train_cases": T.train_cases, "serve_cases": S.serve_cases}


def run_all(rank, world, jobs):
    """Each ``(name, function name, args)`` of ``jobs`` in turn, on the
    same ranks; their results by name."""
    return {name: FUNCTIONS[fn](rank, world, *args) for name, fn, args in jobs}
