"""Closed forms of what each kernel does: the operations it needs and
the bytes it must move (each input read once, each output written
once), from its arguments' shapes.  ``chip_smoke.py`` prices each
kernel's bound with them, and the meta-device dry-run
(``launch/meta_analysis.py``) counts a kernel call with them in place of
its launch, so the two cannot drift apart.

The operations are those the kernel's arithmetic does on the tensor
cores: attention 4·hd a (query, key) pair its mask keeps (Q·Kᵀ and P·V);
the SSD scan as its chunked form needs them; RMSNorm 4 a element.
"""
from __future__ import annotations

from typing import Tuple

import torch

# H100 SXM data-sheet peaks (dense): bf16 tensor cores (fp16's peak is
# the same), fp32 outside the tensor cores (the fp32 kernels run on the
# CUDA cores) and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, dtype: str = "bfloat16") -> Tuple[float, str]:
    """(the least ms the card could take, what bounds it: ``"operations"``
    or ``"bytes"``), the operations at the peak for ``dtype``."""
    peak = PEAK_FP32_FLOPS if dtype == "float32" else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_pairs(B: int, H: int, Sq: int, Sk: int, *, causal=True, window=0,
                    q_offset=0, prefix_len=0) -> int:
    """The (query, key) pairs ``ref.attention_ref``'s mask keeps, over B
    rows and H heads: under ``causal`` the keys up to the query's
    position and the first ``prefix_len``; under ``window`` only those
    past position - window."""
    q_pos = torch.arange(Sq, dtype=torch.int64) + q_offset
    if causal:
        hi = torch.maximum((q_pos + 1).clamp(0, Sk),
                           torch.full_like(q_pos, min(prefix_len, Sk)))
    else:
        hi = torch.full_like(q_pos, Sk)
    lo = (q_pos - window + 1).clamp(min=0) if window else torch.zeros_like(q_pos)
    return B * H * int((hi - lo).clamp(min=0).sum())


def flash_attention_cost(q_shape, k_shape, itemsize: int, *, causal=True, window=0,
                         q_offset=0, prefix_len=0) -> Tuple[int, int]:
    """(operations, bytes) of one ``flash_attention`` call: q (B, Sq, H,
    hd) and k / v (B, Sk, KV, hd) of ``itemsize`` bytes an element."""
    B, Sq, H, hd = q_shape
    Sk, KV = k_shape[1], k_shape[2]
    pairs = attention_pairs(B, H, Sq, Sk, causal=causal, window=window,
                            q_offset=q_offset, prefix_len=prefix_len)
    return 4 * hd * pairs, itemsize * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd)


def flash_decode_cost(B: int, KV: int, G: int, hd: int, live: int,
                      itemsize: int) -> Tuple[int, int]:
    """(operations, bytes) of one ``flash_decode`` call over the ``live``
    cache slots the query may attend to: their K and V rows read, the
    query read and the output written."""
    return (4 * B * KV * G * live * hd,
            itemsize * (2 * B * KV * live * hd + 2 * B * KV * G * hd))


def ssd_scan_cost(b: int, S: int, h: int, p: int, g: int, n: int, chunk: int,
                  x_itemsize: int) -> Tuple[int, int]:
    """(operations, bytes) of one ``ssd_scan`` call: x, B, C in their
    dtype, dt and A fp32 read; y and the final state fp32 written.
    Operations as the chunked form needs them: C·Bᵀ once per group and
    L·X per head over the lower triangle of each chunk (diagonal
    included), and the carried term and state update per head."""
    nbytes = (x_itemsize * b * S * (h * p + 2 * g * n)  # x, B, C
              + 4 * b * S * h + 4 * h                   # dt, A
              + 4 * b * S * h * p + 4 * b * h * p * n)  # y, final state
    tri = chunk * (chunk + 1)                  # 2 x the (i, j <= i) pairs
    flops = b * (S // chunk) * (g * tri * n + h * (tri * p + 4 * chunk * n * p))
    return flops, nbytes


def rmsnorm_cost(rows: int, d: int, x_itemsize: int,
                 scale_itemsize: int) -> Tuple[int, int]:
    """(operations, bytes) of one ``rmsnorm`` call: x read and the output
    written in x's dtype, the scale read once."""
    return 4 * rows * d, 2 * x_itemsize * rows * d + scale_itemsize * d
