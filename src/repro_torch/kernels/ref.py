"""Plain PyTorch versions of the kernels (the counterpart of
``repro/kernels/ref.py``): numerics ground truth, no tiling.  Each
computes in fp32 and returns its input's dtype (fp32, bf16 or fp16; the
SSD's outputs are fp32), as the Pallas bodies do.

The kernel wrappers in ``ops`` take these only for tensors on the CPU;
``chip_smoke.py`` holds each CUDA kernel against them on the card, and
``tests/test_torch_kernels.py`` / ``tests/test_torch_ssm.py`` hold them
against the JAX oracles and the interpret-mode Pallas kernels.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                  prefix_len=0):
    """q/k/v: (B, Sq/Sk, H, hd), K/V already expanded to H heads.  The
    mask is ``_mask_bias``'s of ``repro/models/attention.py``: under
    ``causal`` a key is visible when k <= q + q_offset or k < prefix_len
    (a bidirectional prefix; it counts only under ``causal``), and under
    ``window`` also when k > q + q_offset - window."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = k_pos <= q_pos
        if prefix_len:
            mask = mask | (k_pos < prefix_len)
    if window:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                        prefix_len=0):
    """The plain version of ``ops.flash_attention``: k/v (B, Sk, KV, hd)
    expanded to H heads with a repeat, as the JAX wrapper does, then
    ``attention_ref``."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, prefix_len=prefix_len)


def decode_slot_positions(pos, cache_len, *, ring=False, device=None):
    """Position held by each cache slot at decode step ``pos``.

    Linear cache: slot i holds position i.  Ring cache (sliding-window
    buffer): slot i holds the latest p ≤ pos with p % cache_len == i —
    slots not yet written come out negative and must be masked.  Shared
    by the einsum decode path, the flash_decode wrapper and this oracle,
    so the three can never disagree on ring semantics.  (``torch``'s
    ``%`` floors like Python's and ``jnp``'s.)"""
    idx = torch.arange(cache_len, dtype=torch.int64, device=device)
    if ring:
        return pos - ((pos - idx) % cache_len)
    return idx


def decode_valid(pos, cache_len, *, window=0, ring=False, device=None):
    """(S,) bool: cache slots the query at ``pos`` may attend to."""
    k_pos = decode_slot_positions(pos, cache_len, ring=ring, device=device)
    valid = (k_pos >= 0) & (k_pos <= pos)
    if window:
        valid = valid & (k_pos > pos - window)
    return valid


def decode_attention_ref(q, k, v, pos, *, window=0, softcap=0.0,
                         ring=False):
    """Single-query decode attention (the ``flash_decode`` ground truth).
    q: (B, H, hd) — ONE query token per sequence; k/v: (B, KV, S, hd)
    cache layout (kv head i serves q heads [i·G, (i+1)·G)); pos: int
    position of the query token.  Returns (B, H, hd)."""
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    rep = H // KV
    kk = k.repeat_interleave(rep, dim=1).float()            # (B, H, S, hd)
    vv = v.repeat_interleave(rep, dim=1).float()
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kk) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = decode_valid(pos, S, window=window, ring=ring, device=q.device)
    s = torch.where(valid[None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", p, vv)
    return out.to(q.dtype)


def ssd_ref(x, dt, A, Bm, Cm, initial_state=None):
    """Sequential (non-chunked) SSD recurrence: the ground truth of the
    ``ssd_scan`` kernel and of ``models.ssm.ssd_chunked``.  A Python loop
    over positions in place of the JAX ``lax.scan``.

    x: (b, S, h, p); dt: (b, S, h); A: (h,); Bm/Cm: (b, S, g, n).
    Returns (y (b, S, h, p) fp32, final_state (b, h, p, n) fp32).
    """
    b, S, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    Bh = Bm.repeat_interleave(rep, dim=2).float()
    Ch = Cm.repeat_interleave(rep, dim=2).float()
    xf, dtf = x.float(), dt.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if initial_state is None else initial_state
    ys = []
    for t in range(S):
        decay = torch.exp(A[None, :] * dtf[:, t])                 # (b, h)
        xd = xf[:, t] * dtf[:, t, :, None]                        # (b, h, p)
        state = state * decay[..., None, None] + \
            torch.einsum("bhp,bhn->bhpn", xd, Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1), state


def rmsnorm_ref(x, scale, eps=1e-6):
    """RMSNorm over the last dim in fp32, returned in x's dtype (the
    ``rmsnorm`` ground truth, as ``ref.rmsnorm_ref`` of the JAX package)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
