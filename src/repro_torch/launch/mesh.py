"""Mesh descriptors (the counterpart of ``repro/launch/mesh.py``).

A :class:`Mesh` is the shape of a device grid and nothing else: its
axis names and their sizes, the two things the sharding rules read.  The
JAX package's mesh also holds its devices; here the devices are the
ranks of a ``torch.distributed`` job, and :func:`make_local_mesh` lays
them out in the JAX mesh's order and builds their groups.

Single pod : (data=16, model=16)          = 256 chips
Multi-pod  : (pod=2, data=16, model=16)   = 512 chips; the ``pod`` axis is
             the HeteroPP island/pipeline axis (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Tuple

import torch
import torch.distributed as dist

from ..comm.p2p import Grid


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Mapping[str, int]

    @classmethod
    def of(cls, sizes, names) -> "Mesh":
        return cls(tuple(names), dict(zip(names, (int(s) for s in sizes))))

    @property
    def size(self) -> int:
        return math.prod(self.shape[a] for a in self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh.of((2, 16, 16), ("pod", "data", "model"))
    return Mesh.of((16, 16), ("data", "model"))


def make_local_mesh(model: int = 1, data: int = 0, pod: int = 0, *,
                    transport: str = "host", device=None):
    """The job's ranks as a (pod, data, model) grid (no ``pod`` axis when
    ``pod`` is 0), in the JAX mesh's order: rank = (p·D + d)·M + m.
    ``data`` 0 takes what the world leaves.  Needs a joined process
    group.  Returns (the mesh, this rank's :class:`~repro_torch.comm.p2p.
    Grid`): its ``tp`` group is the model axis, its ``dp`` group the data
    axes flattened (pod major), ``world`` every rank."""
    n = dist.get_world_size()
    device = torch.device("cpu") if device is None else torch.device(device)
    if pod:
        data = data or n // (model * pod)
        mesh = Mesh.of((pod, data, model), ("pod", "data", "model"))
    else:
        data = data or n // model
        mesh = Mesh.of((data, model), ("data", "model"))
    if mesh.size != n:
        raise ValueError(f"a mesh of {dict(mesh.shape)} needs {mesh.size} ranks; "
                         f"the job has {n}")
    grid = Grid.build(transport, device, dp=(pod or 1) * data, pipe=1, tp=model)
    return mesh, grid
