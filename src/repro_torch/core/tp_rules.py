"""Tensor-parallel placement of a HeteroPP stage's block parameters: the
torch copy of the JAX package's ``sharding/rules.py`` tp rules
(``TP_COLUMN_PARAMS``, ``TP_ROW_PARAMS``, ``tp_body_dim`` and
``tp_local_slice``), held equal to them by ``tests/test_torch_planning.py``.

Megatron convention inside one decoder block: QKV projections and the
MLP up/gate projections are COLUMN-parallel (output dim sharded, no
collective needed — heads / ff slices stay local), the output
projections ``wo`` are ROW-parallel (input dim sharded; an all-reduce
over the tp group rebuilds the full activation before the residual add).
Norm scales, per-head qk-norms, and everything else stay replicated.

``tp_local_slice`` takes no padding width (the JAX package's ``pad_tp``):
the port's grouped runtime holds each stage's true tp_s shard, where the
JAX package pads a narrower shard with zeros to the widest one (ROADMAP
C, phantom shards).
"""
from __future__ import annotations

from typing import Optional

import torch

TP_COLUMN_PARAMS = frozenset({"wq", "wk", "wv", "bq", "bk", "bv",
                              "wi", "wg"})
TP_ROW_PARAMS = frozenset({"wo"})


def tp_body_dim(path: str, body_ndim: int) -> Optional[int]:
    """Which body dim (stacked-layer dims stripped) of a block parameter
    the tp axis shards, or None for replicated.  Only the 2-D matmul
    weights and 1-D qkv biases of dense blocks participate; MoE expert
    weights (3-D bodies) and SSM params are replicated — the runtime
    refuses tp > 1 for those block kinds."""
    name = path.split("/")[-1]
    if body_ndim == 2 and name in TP_COLUMN_PARAMS:
        return 1
    if body_ndim == 1 and name in TP_COLUMN_PARAMS:
        return 0
    if body_ndim == 2 and name in TP_ROW_PARAMS:
        return 0
    return None


def tp_local_slice(path: str, body: torch.Tensor, rank: int, tp: int, *,
                   stacked: int = 1) -> torch.Tensor:
    """Slice a stage's stacked block leaf (``stacked`` leading layer dims:
    1 for ``(L, ...)``, 2 for a chunked ``(v, Lc, ...)``) down to tp
    member ``rank``'s Megatron shard, as a new tensor.  Replicated leaves
    (norm scales, qk-norms) come back as they are."""
    d = tp_body_dim(path, body.ndim - stacked)
    if d is None:
        return body
    dim = stacked + d
    full = body.shape[dim]
    if full % tp:
        raise ValueError(f"{path}: dim {dim} of {tuple(body.shape)} does not "
                         f"divide tensor_parallel={tp}")
    w = full // tp
    return body.narrow(dim, rank * w, w).clone()
