"""Mamba2 (SSD — state-space duality) block, chunked-parallel + recurrent
(the counterpart of ``repro/models/ssm.py``).

Training and prefill use the chunked SSD form of arXiv:2405.21060
(quadratic within a chunk, linear across chunks) or, on the card, the
hand-written ``ssd_scan`` CUDA kernel (``kernels.ops``); decode is the
O(1) recurrent update.  The JAX module's sharding hints (``constrain``)
have no counterpart on one device and are left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers
from ..kernels import ops as kops


def init_ssm(cfg, dtype, *, generator, device, stack=()):
    """The JAX initializers' distributions: ``A_log``, ``D`` and
    ``dt_bias`` in fp32, the rest in the model dtype."""
    d = cfg.d_model
    dinner, ng, st = cfg.ssm_dinner, cfg.ssm_ngroups, cfg.ssm_state
    nh = cfg.ssm_nheads
    conv_dim = dinner + 2 * ng * st
    in_dim = 2 * dinner + 2 * ng * st + nh
    kw = dict(generator=generator, device=device, stack=stack)
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, **f32))
    return {
        "in_proj": layers.dense_init((d, in_dim), 0, dtype, **kw),
        "conv_w": layers.dense_init((cfg.ssm_conv_width, conv_dim), 0, dtype, **kw),
        "conv_b": layers.made(torch.zeros((*stack, conv_dim), dtype=dtype,
                                          device=device)),
        "A_log": layers.made(a_log.expand(*stack, nh).clone()),
        "D": layers.made(torch.ones((*stack, nh), **f32)),
        "dt_bias": layers.made(torch.zeros((*stack, nh), **f32)),
        "norm": layers.init_norm("rmsnorm", dinner, device=device, stack=stack),
        "out_proj": layers.dense_init((dinner, d), 0, dtype, **kw),
    }


def _split_in_proj(cfg, zxbcdt, nh):
    """[z | x | B | C | dt] of ``nh`` heads' in_proj output."""
    ng, st = cfg.ssm_ngroups, cfg.ssm_state
    dinner = nh * cfg.ssm_headdim
    z = zxbcdt[..., :dinner]
    x = zxbcdt[..., dinner:2 * dinner]
    Bm = zxbcdt[..., 2 * dinner:2 * dinner + ng * st]
    Cm = zxbcdt[..., 2 * dinner + ng * st:2 * dinner + 2 * ng * st]
    dt = zxbcdt[..., -nh:]
    return z, x, Bm, Cm, dt


def _causal_conv(u, w, b):
    """Depthwise causal conv. u: (B, S, C); w: (W, C).  Summed tap by tap
    in u's dtype, in the JAX order."""
    W = w.shape[0]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = torch.zeros_like(u)
    for i in range(W):
        out = out + pad[:, i:i + u.shape[1], :] * w[i]
    return out + b


def _segsum(a):
    """Stable segment-sum: a (..., l) -> (..., l, l) with
    out[i, j] = sum_{j < t <= i} a[t], -inf above the diagonal."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(l, device=a.device)
    mask = i[:, None] >= i[None, :]
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD.

    x:  (b, S, h, p)   inputs per head
    dt: (b, S, h)      positive step sizes (already softplus'd)
    A:  (h,)           negative decay rates
    Bm: (b, S, g, n)   input matrices  (g groups broadcast over heads)
    Cm: (b, S, g, n)   output matrices
    Returns (y (b,S,h,p), final_state (b,h,p,n)), both fp32.

    The JAX version repeats B and C to every head and contracts four
    operands in one einsum; here the heads split into (g, h/g) so the
    groups broadcast without a copy, and every product is pairwise, so
    no intermediate exceeds the (b, h, c, l, l) size of L (a 6-D one with
    n would be ~50 GB at the mamba2-780m training shape).
    """
    b, S, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        raise ValueError(f"ssd_chunked: sequence {S} is not a multiple of "
                         f"chunk {chunk}")
    nc, r = S // chunk, h // g

    xd = (x * dt[..., None]).float()
    Ad = (A[None, None, :] * dt).float()                       # (b,S,h)

    xc = xd.reshape(b, nc, chunk, g, r, p)
    Ac = Ad.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)       # (b,h,nc,l)
    Bc = Bm.reshape(b, nc, chunk, g, n).float()
    Cc = Cm.reshape(b, nc, chunk, g, n).float()

    A_cum = torch.cumsum(Ac, dim=-1)                           # (b,h,nc,l)

    # 1. intra-chunk: (C B^T o L) (x dt)
    L = torch.exp(_segsum(Ac)).reshape(b, g, r, nc, chunk, chunk)
    CB = torch.einsum("bclgn,bcsgn->bgcls", Cc, Bc)            # (b,g,nc,l,s)
    M = L * CB[:, :, None]                                     # (b,g,r,nc,l,s)
    Y_diag = torch.einsum("bgrcls,bcsgrp->bclgrp", M, xc)

    # 2. per-chunk final states
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)          # (b,h,nc,l)
    ds = decay_states.reshape(b, g, r, nc, chunk).permute(0, 3, 4, 1, 2)
    states = torch.einsum("bclgn,bclgrp->bcgrpn", Bc, xc * ds[..., None])

    # 3. inter-chunk recurrence
    states = states.reshape(b, nc, h, p, n)
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=torch.float32,
                                    device=x.device)
    states = torch.cat([initial_state[:, None].float(), states], dim=1)
    chunk_sums = F.pad(A_cum[..., -1], (1, 0))                 # (b,h,nc+1)
    decay_chunk = torch.exp(_segsum(chunk_sums))               # (b,h,nc+1,nc+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. state contribution to the outputs
    state_decay = torch.exp(A_cum)                             # (b,h,nc,l)
    prev = prev_states.reshape(b, nc, g, r, p, n)
    Y_off = torch.einsum("bclgn,bcgrpn->bclgrp", Cc, prev)
    sd = state_decay.reshape(b, g, r, nc, chunk).permute(0, 3, 4, 1, 2)
    Y_off = Y_off * sd[..., None]

    y = (Y_diag + Y_off).reshape(b, S, h, p)
    return y, final_state


def ssd_recurrent_step(state, x_t, dt_t, A, B_t, C_t):
    """One decode step.  state: (b,h,p,n); x_t: (b,h,p); dt_t: (b,h);
    B_t/C_t: (b,g,n).  Returns (y_t (b,h,p), new_state)."""
    h, g = x_t.shape[1], B_t.shape[1]
    rep = h // g
    Bh = B_t.repeat_interleave(rep, dim=1).float()             # (b,h,n)
    Ch = C_t.repeat_interleave(rep, dim=1).float()
    decay = torch.exp(A[None, :] * dt_t).float()               # (b,h)
    xd = (x_t * dt_t[..., None]).float()
    new_state = state * decay[..., None, None] + \
        torch.einsum("bhp,bhn->bhpn", xd, Bh)
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y, new_state


# ---------------------------------------------------------------------------
# full Mamba2 block
# ---------------------------------------------------------------------------

def _ssd_backend(backend, initial_state, x):
    """The JAX dispatch (``ssm.py:174-185``): ``auto`` takes the kernel on
    the card only from a zero state; ``kernel`` with a state raises (the
    kernel would drop it) and on CPU tensors raises too."""
    if backend == "kernel" and initial_state is not None:
        raise ValueError("backend='kernel': the ssd_scan kernel starts from "
                         "a zero state and cannot take an initial_state")
    resolved = kops.resolve_backend(backend, x)
    return "kernel" if resolved == "kernel" and initial_state is None else "chunked"


def _gated_norm(params, x, mean_sq=None, eps: float = 1e-6):
    """The rmsnorm of the gated output, whose mean of squares ``mean_sq(xf)``
    gives where the channels are one model member's share of dinner."""
    if mean_sq is None:
        return layers.apply_norm(params, x, "rmsnorm", eps)
    xf = x.float()
    return (xf * torch.rsqrt(mean_sq(xf) + eps) * params["scale"].float()).to(x.dtype)


def mamba2_forward(params, cfg, u, *, initial_state=None, backend="auto", mean_sq=None):
    """u: (B, S, d) -> (y (B, S, d), final ssm state (B, h, p, n), conv
    tail (B, W-1, conv_dim)).  The conv tail is the last W-1 positions of
    the conv input (before the conv), which a prefill leaves in the
    decode cache.

    The head count is ``A_log``'s, so ``params`` may be one model
    member's heads (``sharding.spmd``): in_proj's columns [z | x | B | C
    | dt] and the conv's [x | B | C] of those heads (B and C whole), their
    ``A_log``, ``D``, ``dt_bias`` and norm channels, and out_proj's rows,
    whose output is then the member's part of the sum.  The gated norm
    runs over the whole dinner, so ``mean_sq`` then returns the mean of
    squares over every member's channels."""
    B, S, d = u.shape
    nh, hp = params["A_log"].shape[-1], cfg.ssm_headdim
    dinner, ng, st = nh * hp, cfg.ssm_ngroups, cfg.ssm_state
    zxbcdt = u @ params["in_proj"]
    z, x, Bm, Cm, dt = _split_in_proj(cfg, zxbcdt, nh)
    # x | B | C are adjacent columns of zxbcdt: the conv input, in place
    conv_tail = zxbcdt[:, -(cfg.ssm_conv_width - 1):, dinner:2 * dinner + 2 * ng * st]
    BC = torch.cat([Bm, Cm], dim=-1)                           # (B, S, 2·ng·st)
    x = F.silu(_causal_conv(x, params["conv_w"][:, :dinner],
                            params["conv_b"][:dinner]))
    BC = F.silu(_causal_conv(BC, params["conv_w"][:, dinner:],
                             params["conv_b"][dinner:]))
    Bm = BC[..., :ng * st]
    Cm = BC[..., ng * st:]

    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    xh = x.reshape(B, S, nh, hp)
    Bg = Bm.reshape(B, S, ng, st)
    Cg = Cm.reshape(B, S, ng, st)

    chunk = min(cfg.ssm_chunk, S)
    if _ssd_backend(backend, initial_state, xh) == "kernel":
        y, final = kops.ssd_scan(xh, dt, A, Bg, Cg, chunk=chunk)
    else:
        y, final = ssd_chunked(xh, dt, A, Bg, Cg, chunk, initial_state)
    y = y + xh.float() * params["D"][None, None, :, None]
    y = y.reshape(B, S, dinner).to(u.dtype)

    y = _gated_norm(params["norm"], y * F.silu(z), mean_sq)
    return y @ params["out_proj"], final, conv_tail


def init_ssm_cache(cfg, batch, dtype, *, device, stack=()):
    dinner, ng, st = cfg.ssm_dinner, cfg.ssm_ngroups, cfg.ssm_state
    conv_dim = dinner + 2 * ng * st
    return {
        "conv": torch.zeros((*stack, batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((*stack, batch, cfg.ssm_nheads, cfg.ssm_headdim, st),
                             dtype=torch.float32, device=device),
    }


def mamba2_decode_step(params, cfg, u, cache, *, mean_sq=None, gather_x=None):
    """u: (B, 1, d); cache: {conv, state} -> (y (B,1,d), new cache).  The
    new cache holds new tensors, as in JAX (the conv window shifts).

    As in :func:`mamba2_forward`, ``params`` may be one model member's
    heads, with ``mean_sq`` the gated norm's mean of squares over every
    member's channels; its state is then the member's heads' block.  The
    conv cache stays every channel's on every member: ``gather_x(x)``
    returns every member's x channels of the new token in order (the
    model group's all-gather) and the member's first one, so each member
    shifts the same whole window and convolves its own channels of it."""
    B = u.shape[0]
    nh, hp = params["A_log"].shape[-1], cfg.ssm_headdim
    dinner, ng, st = nh * hp, cfg.ssm_ngroups, cfg.ssm_state
    zxbcdt = u[:, 0] @ params["in_proj"]                       # (B, in_dim)
    z, x, Bm, Cm, dt = _split_in_proj(cfg, zxbcdt, nh)
    if gather_x is None:
        xBC = torch.cat([x, Bm, Cm], dim=-1)                   # (B, conv_dim)
        window = torch.cat([cache["conv"], xBC[:, None]], dim=1)   # (B, W, conv)
        mine = window
    else:
        x_all, first = gather_x(x)
        window = torch.cat([cache["conv"], torch.cat([x_all, Bm, Cm], dim=-1)[:, None]],
                           dim=1)
        mine = torch.cat([window[..., first:first + dinner],
                          window[..., x_all.shape[-1]:]], dim=-1)
    conv_out = torch.sum(mine * params["conv_w"][None], dim=1) + params["conv_b"]
    xBC = F.silu(conv_out)
    new_conv = window[:, 1:]

    x = xBC[..., :dinner]
    Bm = xBC[..., dinner:dinner + ng * st]
    Cm = xBC[..., dinner + ng * st:]
    dt = F.softplus(dt.float() + params["dt_bias"])            # (B, nh)
    A = -torch.exp(params["A_log"])

    xh = x.reshape(B, nh, hp)
    Bg = Bm.reshape(B, ng, st)
    Cg = Cm.reshape(B, ng, st)
    y, new_state = ssd_recurrent_step(cache["state"], xh, dt, A, Bg, Cg)
    y = y + xh.float() * params["D"][None, :, None]
    y = y.reshape(B, dinner).to(u.dtype)
    y = _gated_norm(params["norm"], y * F.silu(z), mean_sq)
    out = (y @ params["out_proj"])[:, None]
    return out, {"conv": new_conv, "state": new_state}
