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

The differentiable kernels (``flash_attention``, ``ssd_scan``,
``rmsnorm``) run inside a
``torch.autograd.Function``, the port of the JAX package's
``custom_vjp``s (``recompute_vjp``): the forward is the kernel, the
backward recomputes a plain version under autograd and returns its VJP
(there is no backward kernel, in either package).  The Function takes
its forward body as an argument, so a CPU test can put the plain version
in the kernel's place and still run the backward.  ``flash_decode`` is
inference only.
"""
from __future__ import annotations

import functools

import torch

from . import build
from . import ref as _ref

NEG_INF = _ref.NEG_INF
BACKENDS = ("auto", "einsum", "kernel")
HEAD_DIMS = (64, 80, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


class _RecomputeVJP(torch.autograd.Function):
    """Forward: ``body(*inputs, **static)`` (the kernel on the card).
    Backward: recompute ``plain(*inputs, **static)`` under autograd and
    return its VJP, as the JAX package's ``custom_vjp`` backward passes do.
    The backward runs in a profiler range called ``name``."""

    @staticmethod
    def forward(ctx, name, body, plain, static, *inputs):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        ctx.name, ctx.plain, ctx.static = name, plain, static
        return body(*inputs, **static)

    @staticmethod
    def backward(ctx, *gouts):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[4:])]
        outs = [i for i, g in enumerate(gouts) if g is not None]
        wanted = [t for t in inputs if t.requires_grad]
        if not outs or not wanted:
            return (None,) * (4 + len(inputs))
        with torch.profiler.record_function(ctx.name), torch.enable_grad():
            ys = ctx.plain(*inputs, **ctx.static)
            ys = (ys,) if isinstance(ys, torch.Tensor) else ys
            grads = iter(torch.autograd.grad([ys[i] for i in outs], wanted,
                                             [gouts[i] for i in outs],
                                             allow_unused=True))
        return (None,) * 4 + tuple(next(grads) if t.requires_grad else None
                                   for t in inputs)


def recompute_vjp(name, body, plain, inputs, **static):
    """``body(*inputs, **static)``, differentiable through ``plain``
    (see ``_RecomputeVJP``).  A CPU test passes a plain body in the
    kernel's place to run the backward."""
    return _RecomputeVJP.apply(f"{name}.backward", body, plain, static, *inputs)


def _flash_attention_kernel(q, k, v, *, causal, window, q_offset, prefix_len):
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _check("flash_attention", (q, k, v))
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    _launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Sq, Sk, H, KV, hd, int(bool(causal)),
            int(window), int(q_offset), int(prefix_len), DTYPE_CODES[q.dtype],
            _stream())
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    prefix_len=0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) with H % KV == 0.
    Returns (B, Sq, H, hd) in q's dtype, differentiable.  The kernel
    reads kv head h // (H / KV) in place; the plain path expands GQA
    with a repeat, as the JAX wrapper does before its kernel.
    ``prefix_len`` keys form a bidirectional prefix under ``causal``
    (``ref.attention_ref``), which the JAX wrapper does not take."""
    B, Sq, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} heads over {k.shape[2]} kv heads")
    if prefix_len < 0:
        raise ValueError(f"flash_attention: prefix_len {prefix_len} < 0")
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              prefix_len=prefix_len)
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, **kw)
    return recompute_vjp("flash_attention", _flash_attention_kernel,
                         _ref.flash_attention_ref, (q, k, v), **kw)


flash_attention.launches = 0


def decode_bias(pos, cache_len, *, window=0, ring=False, device=None):
    """(S,) fp32 additive mask for the query at ``pos``: 0 where the slot
    may be attended, NEG_INF elsewhere (``ops.py:131-135`` of the JAX
    package).  The einsum decode path adds it; the ``flash_decode`` kernel
    computes the same mask itself."""
    valid = _ref.decode_valid(pos, cache_len, window=window, ring=ring,
                              device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF))


DECODE_PAGE = 64                      # cache slots a page of the kernel
H100_SMS = 132


def decode_splits(batch_kv, cache_len, num_sms=H100_SMS):
    """Splits of the cache for ``flash_decode``'s first pass: enough
    (batch row, kv head, split) blocks to cover about two per SM, and at
    least one 64-slot page a split.  9 at the serving shape (B 4 x KV 8,
    544 slots: 288 blocks)."""
    n_pages = -(-cache_len // DECODE_PAGE)
    return max(1, min(n_pages, -(-2 * num_sms // batch_kv)))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def flash_decode(q, k, v, pos, *, window=0, softcap=0.0, ring=False):
    """Single-token decode attention against the resident KV cache.

    q: (B, 1, H, hd) or (B, H, hd) — the current token's query heads;
    k/v: (B, KV, S, hd) cache layout, read in place; pos: int position
    of the query token, one for the whole batch (as in the JAX wrapper).
    ``ring=True`` applies the ring-buffer slot → position mapping.  The
    kernel computes the mask from (pos, S, window, ring) itself and runs
    split over the cache (``decode_splits``) with a combine pass; its
    fp32 partials go to a scratch tensor.  Returns (B, H, hd)."""
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
    n_split = decode_splits(B * KV, S, _sm_count(q.device.index))
    part = torch.empty((B * KV, n_split, G, hd + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    _launch("flash_decode", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            part.data_ptr(), out.data_ptr(), B, KV, G, S, hd, n_split,
            int(pos), int(window), int(bool(ring)), float(softcap or 0.0),
            DTYPE_CODES[q.dtype], _stream())
    flash_decode.launches += 1
    return out


flash_decode.launches = 0

SSD_MAX_HEAD_DIM, SSD_MAX_STATE, SSD_MAX_CHUNK = 64, 128, 256


def _ssd_chunked(x, dt, A, Bm, Cm, *, chunk):
    """The plain version ``ssd_scan``'s backward differentiates: the
    CHUNKED form ``models.ssm.ssd_chunked``.  The JAX package's
    ``_ssd_core_bwd`` differentiates the sequential ``ref.ssd_ref``; both
    compute the same function from a zero state (``tests/test_kernels.py``
    holds the two equal to 1e-4), but on the card a loop over every
    position would be ~10^5 small launches a training step, where the
    chunked form is a few dozen products."""
    from ..models.ssm import ssd_chunked       # models import this module
    return ssd_chunked(x, dt, A, Bm, Cm, chunk)


def _row_strided(t):
    """``t`` (b, S, heads, d) as the kernel reads it: the last two dims
    dense and the batch stride S times the row stride, so a column slice
    of a (b, S, k) tensor is read in place.  Returns (t, row stride)."""
    b, S, nh, d = t.shape
    if not (t.stride(3) == 1 and t.stride(2) == d and t.stride(1) >= nh * d
            and t.stride(0) == S * t.stride(1)):
        t = t.contiguous()
    return t, t.stride(1)


SSD_COPY_BYTES = 16                   # the bf16 kernels copy 16-byte pieces


def _ssd_check_copies(p, n, operands):
    """The bf16 (tensor-core) kernels copy x, B and C rows in 16-byte
    pieces: p and n must be multiples of 8, and each operand's base and
    row stride multiples of 16 bytes.  Anything else raises (there is no
    other path for bf16 on the card)."""
    if p % 8 or n % 8:
        raise ValueError(f"ssd_scan: bf16 needs head_dim {p} and state {n} "
                         "to be multiples of 8")
    for name, t, rs in operands:
        if t.data_ptr() % SSD_COPY_BYTES or rs * t.element_size() % SSD_COPY_BYTES:
            raise ValueError(
                f"ssd_scan: {name} at byte offset {t.data_ptr() % SSD_COPY_BYTES} "
                f"from a {SSD_COPY_BYTES}-byte boundary with a row stride of "
                f"{rs} elements; the bf16 kernels need both {SSD_COPY_BYTES}-byte "
                "aligned")


def _ssd_scratch(b, S, h, p, n, chunk, device):
    """The bf16 path's scratch: cum of A dt within each chunk (b, h, S)
    and each chunk's own state (b, h, S / chunk, p, n), both fp32, and the
    state entering each chunk as hi and lo bf16 tiles of the kernels'
    largest (p, n) = (64, 128), (b, h, S / chunk, 2, 64, 128)."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((b, h, S), **f32),
            torch.empty((b, h, S // chunk, p, n), **f32),
            torch.empty((b, h, S // chunk, 2, SSD_MAX_HEAD_DIM, SSD_MAX_STATE),
                        dtype=torch.bfloat16, device=device))


def _ssd_scan_kernel(x, dt, A, Bm, Cm, *, chunk):
    b, S, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    dev = x.device
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", Bm), ("C", Cm)):
        if t.device != dev:
            raise ValueError(f"ssd_scan: {name} on {t.device}, x on {dev}")
    if x.dtype not in DTYPE_CODES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x/B/C dtypes {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}; expected one of {list(DTYPE_CODES)}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt {dt.dtype} and A {A.dtype} must be float32")
    if p > SSD_MAX_HEAD_DIM or n > SSD_MAX_STATE or chunk > SSD_MAX_CHUNK:
        raise ValueError(f"ssd_scan: head_dim {p}, state {n}, chunk {chunk} "
                         f"exceed the kernel's {SSD_MAX_HEAD_DIM}, "
                         f"{SSD_MAX_STATE}, {SSD_MAX_CHUNK}")
    x, x_rs = _row_strided(x)
    Bm, b_rs = _row_strided(Bm)
    Cm, c_rs = _row_strided(Cm)
    dt, A = dt.contiguous(), A.contiguous()
    y = torch.empty((b, S, h, p), dtype=torch.float32, device=dev)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    scratch = ()                      # the CUDA-core kernel (fp32, fp16) needs none
    if x.dtype == torch.bfloat16:
        _ssd_check_copies(p, n, (("x", x, x_rs), ("B", Bm, b_rs), ("C", Cm, c_rs)))
        scratch = _ssd_scratch(b, S, h, p, n, chunk, dev)
    ptrs = [t.data_ptr() for t in scratch] or [0, 0, 0]
    _launch("ssd_scan", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), fin.data_ptr(),
            *ptrs, b, S, h, g, p, n, chunk, x_rs, b_rs, c_rs,
            DTYPE_CODES[x.dtype], _stream())
    ssd_scan.launches += 1
    return y, fin


def ssd_scan(x, dt, A, Bm, Cm, *, chunk=128, initial_state=None):
    """Chunked SSD scan; the signature mirrors ``models.ssm.ssd_chunked``.

    x: (b, S, h, p) fp32, bf16 or fp16; dt: (b, S, h) fp32; A: (h,) fp32;
    Bm/Cm: (b, S, g, n) in x's dtype, g dividing h.  ``chunk`` is cut to
    S, and S must be a multiple of it.  Returns (y (b, S, h, p) fp32,
    final state (b, h, p, n) fp32), differentiable.

    The kernel starts from a zero state: an ``initial_state`` on the card
    raises (the JAX wrapper drops it silently).  bf16 runs the
    tensor-core kernels (three passes, one C call, scratch from
    ``_ssd_scratch``; operands as ``_ssd_check_copies`` asks), fp32 and
    fp16 the CUDA-core one (``ssd_scan.cu`` says why fp16 takes it).  On CPU tensors this is the plain ``ref.ssd_ref``,
    which takes one."""
    b, S, h, p = x.shape
    if dt.shape != (b, S, h) or A.shape != (h,) or Bm.dim() != 4 \
            or Bm.shape != Cm.shape or Bm.shape[:2] != (b, S) or h % Bm.shape[2]:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(Bm.shape)}, "
                         f"C {tuple(Cm.shape)}")
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"ssd_scan: sequence {S} is not a multiple of chunk {chunk}")
    if x.device.type == "cpu":
        return _ref.ssd_ref(x, dt, A, Bm, Cm, initial_state)
    if initial_state is not None:
        raise ValueError("ssd_scan: the kernel starts from a zero state; "
                         "an initial_state goes through ssd_chunked")
    return recompute_vjp("ssd_scan", _ssd_scan_kernel, _ssd_chunked,
                         (x, dt, A, Bm, Cm), chunk=chunk)


ssd_scan.launches = 0

RMSNORM_EPS = 1e-6


def _rmsnorm_kernel(x, scale, *, eps):
    _check("rmsnorm", (x,))
    if scale.device != x.device or scale.dtype not in DTYPE_CODES:
        raise TypeError(f"rmsnorm: scale {scale.dtype} on {scale.device}, x on "
                        f"{x.device}; the scale must be one of {list(DTYPE_CODES)}")
    scale = scale.contiguous()
    d = x.shape[-1]
    out = torch.empty_like(x)
    _launch("rmsnorm", x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            x.numel() // d, d, float(eps), DTYPE_CODES[x.dtype],
            DTYPE_CODES[scale.dtype], _stream())
    rmsnorm.launches += 1
    return out


def rmsnorm(x, scale):
    """Fused RMSNorm: x (..., d), scale (d,); fp32 statistics, eps 1e-6,
    the result in x's dtype, differentiable.  On the card x must be
    contiguous; the scale may be fp32, bf16 or fp16 whatever x's dtype
    (the model keeps norm scales in fp32), and is read as it is."""
    if scale.shape != x.shape[-1:] or x.numel() == 0:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)}, scale {tuple(scale.shape)}")
    if x.device.type == "cpu":
        return _ref.rmsnorm_ref(x, scale, eps=RMSNORM_EPS)
    return recompute_vjp("rmsnorm", _rmsnorm_kernel, _ref.rmsnorm_ref,
                         (x, scale), eps=RMSNORM_EPS)


rmsnorm.launches = 0

KERNELS = (flash_attention, flash_decode, ssd_scan, rmsnorm)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
