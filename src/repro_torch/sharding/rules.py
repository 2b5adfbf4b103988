"""Parameter / optimizer-state / batch / cache sharding rules: the torch
copy of ``repro/sharding/rules.py``, held equal to it on every config at
full size by ``tests/test_torch_sharding.py``.

A spec is a plain tuple with one entry per dim: None, an axis name, or a
tuple of axis names (major to minor), normalised as ``PartitionSpec``
normalises its entries (a one-name tuple is the name, an empty one
None).  A mesh is anything with ``axis_names`` and a ``shape`` mapping
axis -> size (``launch.mesh.Mesh``); the rules read nothing else.

Rules are name- and shape-based with a divisibility-aware fallback: if a
dim is not divisible by the mesh axes assigned to it, axes are dropped
(never an error), which is what lets one rule set cover ten
architectures whose head / expert / vocab counts vary wildly.

Scheme (2D "FSDP x TP"):
  * big matmul weights: one dim over ``model`` (TP), another over ``data``
    (FSDP) when divisible;
  * stacked layer params have a leading layer dim -> never sharded;
  * MoE expert weights: experts over ``model``, d_ff over ``data``;
  * embeddings / lm head: vocab over ``model``, d_model over ``data``;
  * optimizer state inherits the param spec.

The Megatron placement of a pipeline stage's block leaves
(``TP_COLUMN_PARAMS``, ``TP_ROW_PARAMS``, ``tp_body_dim``,
``tp_local_slice``, ``stage_block_specs``) lives here too;
``core/tp_rules.py`` re-exports it for its callers.  ``tp_local_slice``
takes no padding width (the JAX package's ``pad_tp``): the port's
grouped runtime holds each stage's true tp_s shard, where the JAX package
pads a narrower shard with zeros to the widest one (ROADMAP C, phantom
shards).
"""
from __future__ import annotations

import re
from typing import Any, Optional, Sequence, Tuple

import torch

PyTree = Any
Spec = Tuple[Any, ...]

DATA_AXES = ("pod", "data")   # flattened into the batch dim
MODEL_AXIS = "model"
# Axes playing the tensor-parallel role, in preference order.
MODEL_AXES = ("model", "tp")


def spec_of(*entries) -> Spec:
    """A spec from its entries, each normalised as ``PartitionSpec`` does."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out)


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def map_with_path(fn, tree, prefix=""):
    """``fn(path, leaf)`` over a nested dict's leaves, the path its keys
    joined with "/" after ``prefix`` (``jax.tree_util``'s names)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], f"{prefix}{k}/") for k in sorted(tree)}
    return fn(prefix[:-1], tree)


def _fits(dim: int, mesh, axes: Sequence[str]) -> bool:
    total = 1
    for a in axes:
        if a not in mesh.axis_names:
            return False
        total *= mesh.shape[a]
    return dim % total == 0 and dim >= total


def _axis(mesh, dim: int, *cands: Any) -> Optional[Any]:
    """First candidate (axis name or tuple) that divides ``dim``.  The
    ``MODEL_AXIS`` candidate resolves against whichever tensor-parallel
    axis the mesh names."""
    for c in cands:
        if isinstance(c, str) and c == MODEL_AXIS:
            c = model_axis(mesh)
            if c is None:
                continue
        axes = (c,) if isinstance(c, str) else tuple(c)
        if not axes:
            continue
        if _fits(dim, mesh, axes):
            return c if isinstance(c, str) else tuple(axes)
    return None


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def model_axis(mesh) -> Optional[str]:
    """The mesh's tensor-parallel axis name (first of ``MODEL_AXES``
    present), or None when the mesh names neither."""
    for a in MODEL_AXES:
        if a in mesh.axis_names:
            return a
    return None


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def param_spec(path: str, shape: Tuple[int, ...], mesh, *, stacked_prefix: int = 0,
               fsdp: bool = True) -> Spec:
    """The spec of one parameter; ``stacked_prefix`` leading stacked-layer
    dims stay unsharded."""
    da = data_axes(mesh)
    specs: list = [None] * len(shape)
    body = shape[stacked_prefix:]
    off = stacked_prefix
    name = path.split("/")[-1]

    def set_dim(i, axis):
        if axis is not None:
            specs[off + i] = axis

    if len(body) == 0:
        return spec_of(*specs)

    if name in ("tok", "head"):  # embeddings: (V, d) or (d, V)
        big = 0 if body[0] >= body[-1] else len(body) - 1
        small = len(body) - 1 - big
        set_dim(big, _axis(mesh, body[big], MODEL_AXIS))
        if fsdp and len(body) > 1:
            set_dim(small, _axis(mesh, body[small], da))
        return spec_of(*specs)

    if re.search(r"moe/(wi|wg|wo)$", path) or \
            (len(body) == 3 and name in ("wi", "wg", "wo")):
        # (E, d, ff) / (E, ff, d): experts over model, widest other dim over data
        set_dim(0, _axis(mesh, body[0], MODEL_AXIS))
        if fsdp:
            big = 1 if body[1] >= body[2] else 2
            set_dim(big, _axis(mesh, body[big], da))
        return spec_of(*specs)

    if len(body) == 2:
        # model axis on the larger dim, data on the other
        big = 0 if body[0] > body[1] else 1
        other = 1 - big
        set_dim(big, _axis(mesh, body[big], MODEL_AXIS))
        if fsdp:
            set_dim(other, _axis(mesh, body[other], da))
        elif specs[off + big] is None:
            set_dim(other, _axis(mesh, body[other], MODEL_AXIS))
        return spec_of(*specs)

    if len(body) == 1:
        # biases / norms / A_log etc: shard big vectors over model
        if body[0] >= 4096:
            set_dim(0, _axis(mesh, body[0], MODEL_AXIS))
        return spec_of(*specs)

    return spec_of(*specs)


def _stacked_depth(path: str) -> int:
    """Leading stacked dims: blocks have 1 (layers), hybrid blocks have 2."""
    if "blocks" in path:
        return 2 if path.startswith("blocks-hybrid") else 1
    return 0


def tree_param_specs(params: PyTree, mesh, *, hybrid: bool = False,
                     fsdp: bool = True) -> PyTree:
    """Spec tree matching ``params`` (any leaves with a ``shape``: tensors,
    meta tensors)."""
    def spec_for(path, leaf):
        stacked = 0
        if "blocks" in path and "shared_attn" not in path:
            stacked = 2 if (hybrid and not path.startswith("enc")) else 1
        return param_spec(path, tuple(leaf.shape), mesh, stacked_prefix=stacked,
                          fsdp=fsdp)

    return map_with_path(spec_for, params)


# ---------------------------------------------------------------------------
# tensor-parallel placement for the HeteroPP 2-D (pipe x tp) grid
# ---------------------------------------------------------------------------

# Megatron convention inside one decoder block: QKV projections and the
# MLP up/gate projections are COLUMN-parallel (output dim sharded, no
# collective needed: heads / ff slices stay local), the output
# projections ``wo`` are ROW-parallel (input dim sharded; an all-reduce
# over the tp group rebuilds the full activation before the residual add).
# Norm scales, per-head qk-norms, and everything else stay replicated.
TP_COLUMN_PARAMS = frozenset({"wq", "wk", "wv", "bq", "bk", "bv",
                              "wi", "wg"})
TP_ROW_PARAMS = frozenset({"wo"})


def tp_body_dim(path: str, body_ndim: int) -> Optional[int]:
    """Which body dim (stacked-layer dims stripped) of a block parameter
    the tp axis shards, or None for replicated.  Only the 2-D matmul
    weights and 1-D qkv biases of dense blocks participate; MoE expert
    weights (3-D bodies) and SSM params are replicated, and the runtime
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
    1 for ``(L, ...)``, 2 for a chunked ``(v, Lc, ...)``, 0 for one layer)
    down to tp member ``rank``'s Megatron shard, as a new tensor.
    Replicated leaves (norm scales, qk-norms) come back as they are."""
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


def stage_block_specs(blocks: PyTree, *, pipe_axis: str = "pipe",
                      tp_axis: Optional[str] = "tp",
                      stacked_prefix: int = 2) -> PyTree:
    """Spec tree for heteropp's stacked per-stage block params: leading
    stage dim over ``pipe_axis``, the remaining ``stacked_prefix`` - 1
    stacked layer/chunk dims replicated, and the Megatron column/row dim
    (:func:`tp_body_dim`) over ``tp_axis``.  ``tp_axis=None`` keeps params
    tp-replicated (the 1-D pipe grid)."""
    def spec_for(path, leaf):
        dims: list = [None] * leaf.ndim
        dims[0] = pipe_axis
        if tp_axis is not None:
            d = tp_body_dim(path, leaf.ndim - stacked_prefix)
            if d is not None:
                dims[stacked_prefix + d] = tp_axis
        return spec_of(*dims)

    return map_with_path(spec_for, blocks)


# ---------------------------------------------------------------------------
# train-state / batch / cache specs
# ---------------------------------------------------------------------------

def train_state_shardings(state_shape, mesh, *, hybrid=False, fsdp=True):
    """Specs for TrainState(params, opt_state{master, m, v}, step): the
    optimizer state inherits the params' specs; the step is replicated."""
    from ..training.train_step import TrainState
    p = tree_param_specs(state_shape.params, mesh, hybrid=hybrid, fsdp=fsdp)
    return TrainState(params=p, opt_state={"master": p, "m": p, "v": p}, step=())


def batch_shardings(batch_shape, mesh):
    da = data_axes(mesh)

    def spec(leaf):
        if leaf.ndim == 0:
            return ()
        b = leaf.shape[0]
        ax = _axis(mesh, b, da, da[:1] if da else None)
        return spec_of(ax, *[None] * (leaf.ndim - 1))

    return _map(spec, batch_shape)


def cache_shardings(cache_shape, mesh):
    """KV caches (L, B, KV, S, hd): batch over data, KV heads (else the
    longest trailing dim) over model.  SSM states (L, B, H, p, n): batch
    over data, heads over model."""
    da = data_axes(mesh)

    def spec(leaf):
        s = [None] * leaf.ndim
        if leaf.ndim >= 4:
            s[1] = _axis(mesh, leaf.shape[1], da, da[:1] if da else None)
            if leaf.ndim == 5:
                ma = model_axis(mesh)
                if ma is not None and _fits(leaf.shape[2], mesh, (ma,)) and \
                        leaf.shape[2] >= mesh.shape[ma]:
                    s[2] = ma
                else:
                    trail = list(range(2, 5))
                    big = max(trail, key=lambda i: leaf.shape[i])
                    s[big] = _axis(mesh, leaf.shape[big], MODEL_AXIS)
        elif leaf.ndim >= 2:
            s[1] = _axis(mesh, leaf.shape[1], da, da[:1] if da else None) \
                if leaf.ndim > 2 else None
            if s[1] is None and leaf.ndim >= 2:
                s[0] = _axis(mesh, leaf.shape[0], da, da[:1] if da else None)
        return spec_of(*s)

    return _map(spec, cache_shape)
