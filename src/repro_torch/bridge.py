"""Weight bridge: a nested dict of numpy arrays with the JAX package's
parameter names and layouts (``jax.tree.map(np.asarray, params)``) →
the port's nested dict of tensors, same names, same layouts.

Only the type changes.  bf16 arrays arrive as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` rejects; they cross bit-exactly as their raw
16 bits (viewed as int16, then ``.view(torch.bfloat16)``).  A JAX
``TrainState`` (params, opt_state, step) crosses the same way into the
port's ``TrainState``.  Tests use the bridge; the launchers never import
it.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

PyTree = Any


def tensor_from_numpy(arr, device, dtype: Optional[torch.dtype] = None):
    arr = np.array(arr, copy=True, order="C")    # owned and writable
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    t = t.to(device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def params_from_numpy(tree: PyTree, device, dtype: Optional[torch.dtype] = None) -> PyTree:
    """Convert every leaf; ``dtype`` casts floating leaves when given.  A
    tuple (a whisper serve cache's cross (k, v) pair) stays a tuple."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(params_from_numpy(v, device, dtype) for v in tree)
    return tensor_from_numpy(tree, device, dtype)


def train_state_from_numpy(params, opt_state, step, device):
    """A JAX ``TrainState``'s parts as numpy trees (``jax.tree.map(
    np.asarray, ...)``) and its step -> the port's ``TrainState``."""
    from .training.train_step import train_state_from
    return train_state_from(params_from_numpy(params, device),
                            params_from_numpy(opt_state, device), int(step))


def cache_blocks_from_numpy(tree: PyTree, layout, specs, device) -> PyTree:
    """A JAX serve cache as numpy (``jax.tree.map(np.asarray, cache)``)
    cut into one rank's blocks under the copied cache rules
    (``sharding.spmd.cache_specs``: a flat dict of specs by path), as the
    grid's serve steps hold it, so that a test compares blocks."""
    from .sharding import spmd
    return spmd.tree_blocks(params_from_numpy(tree, device), layout, specs)
