"""Sharding context: a process-global (mesh, logical-axis-rules) pair, the
torch copy of ``repro/sharding/ctx.py``.

``logical_to_spec`` translates logical axis names ("batch", "heads",
...) into mesh axes under the active rules, as the JAX package does.
``constrain`` is the one part with no torch counterpart: in the JAX
package it emits a GSPMD ``with_sharding_constraint`` that the XLA
partitioner turns into collectives.  Torch has no partitioner to act on
such an annotation; the port's sharded train step
(``sharding.spmd``) places every tensor and issues every collective
itself, so ``constrain`` returns its tensor unchanged, and the port's
model code does not call it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

from .rules import spec_of

_state = threading.local()

# Logical axis -> mesh axis (or tuple of mesh axes, or None) mapping.
# "batch" spans the data-parallel axes; "model" is tensor/expert parallel.
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_model": "model",     # sequence-parallel activations between blocks
    "model": "model",
    "heads": "model",         # attention heads (megatron attention)
    "expert": "model",
    "data_only": "data",
    "none": None,
}


def axis_size(name: str) -> int:
    mesh = get_mesh()
    if mesh is None:
        return 1
    return mesh.shape.get(name, 1)


def set_mesh(mesh, rules: Optional[dict] = None) -> None:
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES if rules is None else rules)


def get_mesh():
    return getattr(_state, "mesh", None)


def get_rules() -> dict:
    return getattr(_state, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    prev_mesh, prev_rules = get_mesh(), get_rules()
    set_mesh(mesh, rules)
    try:
        yield
    finally:
        set_mesh(prev_mesh, prev_rules)


def _resolve(axis: Optional[str], mesh, dim_size: int):
    """Translate a logical axis name into mesh axes, dropping trailing
    axes until the dimension divides by the product of their sizes."""
    if axis is None:
        return None
    mapped = get_rules().get(axis, None)
    if mapped is None:
        return None
    axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
    axes = tuple(a for a in axes if a in mesh.axis_names)
    if not axes:
        return None
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    if dim_size % total != 0:
        while axes:
            total = 1
            for a in axes:
                total *= mesh.shape[a]
            if dim_size % total == 0:
                break
            axes = axes[:-1]
        if not axes:
            return None
    return axes if len(axes) > 1 else axes[0]


def logical_to_spec(axes: Sequence[Optional[str]], shape: Sequence[int], mesh=None):
    mesh = mesh or get_mesh()
    assert mesh is not None
    assert len(axes) == len(shape), (axes, shape)
    return spec_of(*[_resolve(a, mesh, s) for a, s in zip(axes, shape)])


def constrain(x, *axes: Optional[str]):
    """The JAX package's GSPMD sharding hint.  Torch has nothing that acts
    on it (the sharded step's explicit collectives do its work), so ``x``
    comes back unchanged."""
    return x
