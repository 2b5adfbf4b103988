"""Numpy checkpoints in the JAX package's format (the counterpart of
``repro/checkpointing/io.py``): a directory of ``shard-*.npz`` files and
an ``index.json`` mapping each flattened path to (file, key, shape,
dtype).

A ``TrainState`` flattens as the JAX ``TrainState`` pytree does:
``0/<param path>``, ``1/{master,m,v}/<param path>``, and ``2`` for the
int32 step.  bf16 leaves are stored as their raw bytes (uint8, a
trailing dimension of 2) with dtype ``"bfloat16"``, as the JAX writer
stores ``ml_dtypes`` arrays, so either package loads the other's
checkpoints.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..training.train_step import TrainState, train_state_from
from ..tree import flatten

PyTree = Any

_SHARD_BYTES = 1 << 30  # 1 GiB per shard file


def _as_tree(state) -> PyTree:
    if isinstance(state, TrainState):
        return {"0": state.params, "1": state.opt_state,
                "2": torch.tensor(state.step, dtype=torch.int32)}
    return state


def _to_numpy(t: torch.Tensor):
    """(array to store, dtype name of the index)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        raw = t.view(torch.int16).numpy().view(np.uint8)
        return raw.reshape(*t.shape, -1), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, entry) -> torch.Tensor:
    if entry["dtype"] == "bfloat16":
        bits = np.ascontiguousarray(arr).reshape(-1).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).reshape(entry["shape"])
    return torch.from_numpy(np.array(arr, copy=True)).reshape(entry["shape"])


def save_checkpoint(path: str, state, *, step: Optional[int] = None):
    os.makedirs(path, exist_ok=True)
    flat = flatten(_as_tree(state))
    index: Dict[str, Any] = {"step": step, "entries": {}}
    shard_id, shard_bytes, buf = 0, 0, {}

    def flush():
        nonlocal shard_id, shard_bytes, buf
        if buf:
            np.savez(os.path.join(path, f"shard-{shard_id:05d}.npz"), **buf)
            shard_id += 1
            shard_bytes, buf = 0, {}

    for i, (name, leaf) in enumerate(sorted(flat.items())):
        arr, dtype = _to_numpy(leaf)
        key = f"a{i}"
        index["entries"][name] = {
            "file": f"shard-{shard_id:05d}.npz", "key": key,
            "shape": list(leaf.shape), "dtype": dtype}
        buf[key] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= _SHARD_BYTES:
            flush()
    flush()
    with open(os.path.join(path, "index.json"), "w") as f:
        json.dump(index, f, indent=1)


class CheckpointReader:
    """One leaf at a time from a checkpoint directory: ``reader(name)`` is
    the stored leaf ``name`` (a flattened path) as a CPU tensor in its
    stored dtype; each shard file is opened once.  ``step`` is the
    index's step.  Close it (or use it as a context manager) when done."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
        self.entries, self.step = index["entries"], index["step"]
        self._files: Dict[str, Any] = {}

    def __call__(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        if e["file"] not in self._files:
            self._files[e["file"]] = np.load(os.path.join(self.path, e["file"]))
        return _from_numpy(self._files[e["file"]][e["key"]], e)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_checkpoint(path: str, target, *, device=None):
    """Restore into the structure of ``target`` (a ``TrainState`` or a
    nested dict of tensors; values ignored), on ``device`` (default:
    each target leaf's device).  Shapes must match; the stored dtype is
    kept."""
    flat_t = flatten(_as_tree(target))
    with CheckpointReader(path) as read:
        missing = sorted(set(flat_t) - set(read.entries))
        if missing:
            raise KeyError(f"{path}: no entries for {missing[:5]}")

        def get(name, leaf):
            t = read(name)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{name}: checkpoint {tuple(t.shape)} vs "
                                 f"target {tuple(leaf.shape)}")
            return t.to(device if device is not None else leaf.device)

        restored = _unflatten(_as_tree(target),
                              {n: get(n, leaf) for n, leaf in flat_t.items()})
    if isinstance(target, TrainState):
        return train_state_from(restored["0"], restored["1"], int(restored["2"]))
    return restored


def _unflatten(tree: PyTree, flat: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/") for k, v in tree.items()}
    return flat[prefix[:-1]]


def checkpoint_step(path: str) -> Optional[int]:
    try:
        with open(os.path.join(path, "index.json")) as f:
            return json.load(f)["step"]
    except (FileNotFoundError, KeyError):
        return None
