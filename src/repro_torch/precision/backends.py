"""Simulated chip backends for precision alignment (DiTorch §3.1.2; the
counterpart of ``repro/precision/backends.py``).

Each "chip" is a numerics regime applied to the same computation: a
compute dtype for the operands and an order in which a product's K
dimension is accumulated (chunked-K accumulation reproduces the paper's
"unique data layouts and accumulation orders").  The table, the probes'
shapes and their arithmetic are the reference's.

Each probe in ``OPS`` is a pair: ``draw(generator, device)`` makes its
fp32 inputs from an explicit ``torch.Generator`` (the reference draws
from a ``jax.random`` key; the two give different numbers from one
seed), and ``body(backend, *inputs)`` computes the op under a regime, so
a test can feed the body the reference's own draws.  A probe called as
``op(backend, generator, device)`` draws and computes.  ``backend_matmul``
is a plain product that the reference leaves to XLA outside any Pallas
kernel; here it is ``torch.matmul`` in the regime's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ChipBackend:
    name: str
    compute_dtype: str          # matmul input dtype
    accum_chunks: int = 1       # K-dim accumulation chunks (order change)
    stochastic_eps: float = 0.0  # per-op relative perturbation (layout noise)


BACKENDS: Dict[str, ChipBackend] = {
    "a100_ref": ChipBackend("a100_ref", "float32"),
    "chip_a": ChipBackend("chip_a", "bfloat16"),
    "chip_b": ChipBackend("chip_b", "bfloat16", accum_chunks=4),
    "chip_c": ChipBackend("chip_c", "float16"),
    "chip_d": ChipBackend("chip_d", "float16", accum_chunks=8),
}


def _rounded(be: ChipBackend, x: torch.Tensor) -> torch.Tensor:
    """x rounded to the regime's dtype and read back in fp32."""
    return x.to(DTYPES[be.compute_dtype]).float()


def backend_matmul(be: ChipBackend, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul under a backend's dtype + accumulation-order regime: the
    operands in its dtype, each product's result in that dtype, the
    chunks' products summed in fp32, lowest K chunk first."""
    dt = DTYPES[be.compute_dtype]
    a, b = a.to(dt), b.to(dt)
    if be.accum_chunks <= 1:
        return torch.matmul(a, b).float()
    K = a.shape[-1]
    c = be.accum_chunks
    while K % c:
        c -= 1
    kc = K // c
    out = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32,
                      device=a.device)
    for i in range(c):   # fixed different order: low chunks first
        out = out + torch.matmul(a[..., i * kc:(i + 1) * kc],
                                 b[..., i * kc:(i + 1) * kc, :]).float()
    return out


@dataclasses.dataclass(frozen=True)
class OpProbe:
    """One operator of the sweep: its inputs' draw and its body."""
    name: str
    draw: Callable[[torch.Generator, torch.device], Tuple[torch.Tensor, ...]]
    body: Callable[..., torch.Tensor]

    def __call__(self, be: ChipBackend, generator: torch.Generator,
                 device) -> torch.Tensor:
        return self.body(be, *self.draw(generator, device))


OPS: Dict[str, OpProbe] = {}


def _normal(generator, device, *shape):
    return torch.randn(shape, generator=generator, device=device)


def op(name, draw):
    def deco(body):
        OPS[name] = OpProbe(name, draw, body)
        return body
    return deco


@op("matmul", lambda g, d: (_normal(g, d, 128, 256), _normal(g, d, 256, 128)))
def _matmul(be, a, b):
    return backend_matmul(be, a, b)


@op("softmax", lambda g, d: (_normal(g, d, 64, 512) * 4,))
def _softmax(be, x):
    return torch.softmax(_rounded(be, x), -1)


@op("layernorm", lambda g, d: (_normal(g, d, 64, 512),))
def _layernorm(be, x):
    xf = _rounded(be, x)
    return (xf - xf.mean(-1, keepdim=True)) / torch.sqrt(
        xf.var(-1, keepdim=True, unbiased=False) + 1e-5)


@op("gelu", lambda g, d: (_normal(g, d, 4096),))
def _gelu(be, x):
    return F.gelu(_rounded(be, x), approximate="tanh")   # jax.nn.gelu's default


@op("attention", lambda g, d: tuple(_normal(g, d, 2, 64, 4, 32) for _ in range(3)))
def _attention(be, q, k, v):
    s = backend_matmul(be, q.permute(0, 2, 1, 3).reshape(8, 64, 32),
                       k.permute(0, 2, 3, 1).reshape(8, 32, 64))
    p = torch.softmax(s, -1)
    return backend_matmul(be, p, v.permute(0, 2, 1, 3).reshape(8, 64, 32))


@op("cross_entropy", lambda g, d: (_normal(g, d, 32, 1000) * 3,))
def _ce(be, x):
    return torch.logsumexp(_rounded(be, x), -1)
