"""What one step does, read from its run on the meta device: the port's
counterpart of ``repro/launch/hlo_analysis.py``, which reads the same
from a compiled step's HLO.

:class:`MetaAnalysis` is a ``TorchDispatchMode``: every aten op of the
step passes through it, the recompute of each checkpoint and each
microbatch included (eager execution runs them all, so no trip counts
are needed), and it adds up

* ``flops``: ``torch.utils.flop_counter``'s formula for each op that has
  one (the products, convolutions and attention), plus each kernel
  call's closed form (``kernels/cost.py``), which the kernel wrappers
  report inside ``kernels.ops.estimating`` in place of their launch;
* ``bytes``: each op's operand and result bytes (the views, the factory
  calls that only allocate and ``detach`` excluded) and each kernel
  call's closed form: the eager counterpart of the reference's HBM
  proxy, with no fusion;
* ``peak_bytes``: the most storage bytes live at once, each storage
  counted from the op that made it until it is released, over the
  tensors given to :meth:`track` (the state and the batch) and every
  tensor the step makes.

The collectives are counted by the step's grid (``comm.p2p.
CountingComm``), not here.
"""
from __future__ import annotations

import weakref
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import ops

aten = torch.ops.aten
# ops that only allocate or relabel: no bytes move
NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
              aten.detach.default, aten.alias.default, aten.lift_fresh.default}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class MetaAnalysis(TorchDispatchMode):
    """Counts flops, bytes and the peak of live storage bytes over what
    runs inside it (see the module's docstring); ``kernels`` holds each
    kernel's calls, flops and bytes by name."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = 0
        self.live = self.peak = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self._storages: Dict[int, weakref.ref] = {}

    def __enter__(self):
        self._estimate = ops.estimating(self.kernel)
        self._estimate.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._estimate.__exit__(*exc)

    def track(self, tensors: Iterable[torch.Tensor]) -> None:
        """Count these tensors' storages as live until they are released."""
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = weakref.ref(st, lambda _, key=key, n=n: self._release(key, n))
            self.live += n
            self.peak = max(self.peak, self.live)

    def _release(self, key: int, n: int) -> None:
        if self._storages.pop(key, None) is not None:
            self.live -= n

    def kernel(self, name: str, flops: int, nbytes: int) -> None:
        """A kernel call counted by its closed form (``ops.estimating``)."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        self.flops += int(flops)
        self.bytes += int(nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if func not in NO_TRAFFIC and not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs)) + outs)
        self.track(outs)
        return out

    def report(self) -> Dict[str, object]:
        return {"flops": self.flops, "bytes": self.bytes, "peak_bytes": self.peak,
                "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())}}
