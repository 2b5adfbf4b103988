"""Public wrappers for the CUDA kernels (the counterpart of
``repro/kernels/ops.py``).

Dispatch mirrors the JAX package: ``backend="auto"`` takes the kernel for
CUDA tensors and the plain PyTorch path for CPU tensors
(``preferred_backend``); ``backend="kernel"`` forces the kernel and
raises on CPU tensors (``resolve_backend``).

A wrapper given CPU tensors computes its kernel's plain version from
``ref``; given CUDA tensors it launches the kernel or raises — there is
no fallback.  It checks device, dtype, shape and contiguity, allocates
the output with ``torch.empty``, launches on PyTorch's current stream
and raises if the launch returned a CUDA error.  Each wrapper counts its
launches in a plain integer attribute (``flash_attention.launches``),
incremented only where the kernel is launched, so a run can show that
its path went through the kernel.
"""
from __future__ import annotations

import torch

from . import build
from . import ref as _ref

NEG_INF = _ref.NEG_INF
BACKENDS = ("auto", "einsum", "kernel")
HEAD_DIMS = (64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def preferred_backend(x: torch.Tensor) -> str:
    """What ``backend="auto"`` executes for tensors like ``x``: the CUDA
    kernels on the card, the plain PyTorch paths on the CPU."""
    return "kernel" if x.device.type == "cuda" else "einsum"


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """Validate ``backend`` for tensors like ``x``.  ``kernel`` on a CPU
    tensor raises; ``auto`` becomes ``kernel`` on the card and stays
    ``auto`` elsewhere (the einsum/chunked choice is by length)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "kernel" and x.device.type != "cuda":
        raise RuntimeError(
            f"backend='kernel' needs CUDA tensors, got a tensor on {x.device}")
    if backend == "auto" and preferred_backend(x) == "kernel":
        return "kernel"
    return backend


def _check(name, tensors):
    """The kernels take contiguous CUDA tensors of one device and one
    dtype from ``DTYPE_CODES``; anything else raises."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel needs CUDA")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not in {list(DTYPE_CODES)}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} "
                             "is not contiguous")


def _launch(name, *args):
    err = build.kernel(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) with H % KV == 0.
    Returns (B, Sq, H, hd) in q's dtype.  The kernel reads kv head
    h // (H / KV) in place; the plain path expands GQA with a repeat, as
    the JAX wrapper does before its kernel."""
    B, Sq, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    Sk, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"flash_attention: {H} heads over {KV} kv heads")
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset)
    _check("flash_attention", (q, k, v))
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    _launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Sq, Sk, H, KV, hd, int(bool(causal)),
            int(window), int(q_offset), DTYPE_CODES[q.dtype], _stream())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def decode_bias(pos, cache_len, *, window=0, ring=False, device=None):
    """(S,) fp32 additive mask for the query at ``pos``: 0 where the slot
    may be attended, NEG_INF elsewhere (``ops.py:131-135`` of the JAX
    package)."""
    valid = _ref.decode_valid(pos, cache_len, window=window, ring=ring,
                              device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF))


def flash_decode(q, k, v, pos, *, window=0, softcap=0.0, ring=False):
    """Single-token decode attention against the resident KV cache.

    q: (B, 1, H, hd) or (B, H, hd) — the current token's query heads;
    k/v: (B, KV, S, hd) cache layout, read in place; pos: int position
    of the query token.  ``ring=True`` applies the ring-buffer slot →
    position mapping.  The mask travels as one fp32 bias row shared by
    the batch (one ``pos`` for every row, as in the JAX wrapper).
    Returns (B, H, hd)."""
    if q.dim() == 4:
        q = q[:, 0]
    B, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    KV, S = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"flash_decode: {H} heads over {KV} kv heads")
    if q.device.type == "cpu":
        return _ref.decode_attention_ref(q, k, v, pos, window=window,
                                         softcap=softcap, ring=ring)
    G = H // KV
    q = q.contiguous()
    _check("flash_decode", (q, k, v))
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {hd} not in {HEAD_DIMS}")
    bias = decode_bias(pos, S, window=window, ring=ring, device=q.device)
    out = torch.empty_like(q)
    _launch("flash_decode", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), out.data_ptr(), B, KV, G, S, hd,
            0,                        # bias_stride: one row for the batch
            float(softcap or 0.0), DTYPE_CODES[q.dtype], _stream())
    flash_decode.launches += 1
    return out


flash_decode.launches = 0

KERNELS = (flash_attention, flash_decode)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
