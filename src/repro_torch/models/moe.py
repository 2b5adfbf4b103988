"""Mixture-of-Experts block with sort-based capacity dispatch (the
counterpart of ``repro/models/moe.py``).

Per token group (a batch row: capacity comes from the sequence length):

  1. router logits (fp32) -> top-k (gate values + expert ids) per token
  2. flatten the (tokens x k) assignments, stable-argsort by expert id
  3. position within its expert from the cumulative counts; slots past
     the capacity C are dropped (GShard/Switch semantics)
  4. scatter tokens into an (E, C, d) buffer, run the batched expert
     MLPs, gather back and combine weighted by the gate values.

The groups are processed together: group b's rows of the flattened
buffers start at b * (E*C + 1) (dispatch) and b * E*C (combine), so one
``index_add`` and one gather serve every group.  The expert products are
the reference's three einsums, plain batched matmuls that the JAX
package also computes outside any Pallas kernel.  Its sharding hints
(``constrain``) have nothing to do on one device and are dropped.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from . import layers


def init_moe(cfg, dtype, *, generator, device, stack=()):
    """``router`` (d, E) fp32 whatever ``dtype``; ``wi`` / ``wg`` (E, d,
    ff) and ``wo`` (E, ff, d), N(0, 1/fan_in) over each expert's input."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    kw = dict(generator=generator, device=device, stack=stack)
    p = {"router": layers.dense_init((d, E), 0, torch.float32, **kw),
         "wi": layers.dense_init((E, d, ff), 1, dtype, **kw)}
    if cfg.mlp in ("swiglu", "geglu", "glu"):
        p["wg"] = layers.dense_init((E, d, ff), 1, dtype, **kw)
    p["wo"] = layers.dense_init((E, ff, d), 1, dtype, **kw)
    return p


def capacity(cfg, group_tokens: int) -> int:
    """Per-expert capacity for a token group."""
    k, E, cf = cfg.experts_per_token, cfg.num_experts, cfg.moe_capacity_factor
    c = int(math.ceil(k * group_tokens * cf / E))
    return max(4, min(c, group_tokens * k))


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of the last dim,
    the lower index first among equal values, as ``jax.lax.top_k``
    (``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params, cfg, x):
    """Router logits (fp32), probabilities, and the renormalised top-k
    gates and expert ids of ``x`` (..., d)."""
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, cfg.experts_per_token)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate_vals, expert_ids


def count(ids, n: int) -> torch.Tensor:
    """``torch.bincount(ids.flatten(), minlength=n)`` for ids below
    ``n``, by a scatter-add: ``bincount`` on the card reads the largest
    id back to the host to size its output, a synchronisation in every
    layer."""
    flat = ids.reshape(-1)
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def own(slot, valid, C: int, experts: Tuple[int, int]):
    """Of ``dispatch``'s assignments, those of the ``experts`` (first, n):
    their slots in those experts' (n*C)-row buffer (the others at its
    sentinel row n*C) and which they are."""
    first, n = experts
    local = slot - first * C
    mine = valid & (local >= 0) & (local < n * C)
    return torch.where(mine, local, torch.full_like(local, n * C)), mine


def dispatch(x, expert_ids, E: int, C: int, experts: Optional[Tuple[int, int]] = None):
    """x: (B, g, d); expert_ids: (B, g, k).  Returns (buffer (B, E*C, d),
    slot (B, g*k), valid (B, g*k)), each group as the reference's
    ``_dispatch_one_group``: an assignment past its expert's capacity
    goes to the sentinel row E*C, multiplied by 0.  With ``experts``
    (first, n) the buffer holds those n experts' rows only, (B, n*C, d)
    (:func:`own`); slot and valid stay every expert's."""
    B, g, k = expert_ids.shape
    flat_ids = expert_ids.reshape(B, g * k)          # token-major, as the reference
    sort_idx = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, sort_idx)
    rows = torch.arange(B, device=x.device)[:, None]
    counts = count(flat_ids + rows * E, B * E).view(B, E)
    starts = torch.cumsum(counts, dim=1) - counts
    ar = torch.arange(g * k, device=x.device).expand(B, g * k)
    pos_in_expert = ar - torch.gather(starts, 1, sorted_ids)
    valid_sorted = pos_in_expert < C
    slot_sorted = torch.where(valid_sorted, sorted_ids * C + pos_in_expert,
                              torch.full_like(sorted_ids, E * C))
    # the inverse permutation, by a scatter: slot of original index j
    inv = torch.empty_like(sort_idx).scatter_(1, sort_idx, ar)
    slot = torch.gather(slot_sorted, 1, inv)
    valid = torch.gather(valid_sorted, 1, inv)
    n = E if experts is None else experts[1]
    fill, kept = (slot, valid) if experts is None else own(slot, valid, C, experts)
    d = x.shape[-1]
    tok_idx = (ar // k + rows * g).reshape(-1)
    src = x.reshape(B * g, d)[tok_idx] * kept.reshape(-1, 1).to(x.dtype)
    buf = torch.zeros((B * (n * C + 1), d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, (fill + rows * (n * C + 1)).reshape(-1), src)
    return buf.view(B, n * C + 1, d)[:, :n * C], slot, valid


def combine(ybuf, slot, valid, gate_vals):
    """ybuf: (B, E*C, d); slot/valid: (B, g*k); gate_vals: (B, g, k) ->
    (B, g, d): the reference's ``_combine_one_group`` on every group,
    the gates cast to the buffer's dtype and the sum over k in it."""
    B, g, k = gate_vals.shape
    EC, d = ybuf.shape[1:]
    safe_slot = torch.where(valid, slot, torch.zeros_like(slot))
    rows = torch.arange(B, device=ybuf.device)[:, None]
    out = ybuf.reshape(B * EC, d)[(safe_slot + rows * EC).reshape(-1)]
    out = out * valid.reshape(-1, 1).to(ybuf.dtype)
    out = out.view(B, g, k, d)
    return torch.sum(out * gate_vals[..., None].to(ybuf.dtype), dim=2)


def expert_mlp(params, cfg, buf):
    """buf: (B, E, C, d) -> (B, E, C, d): each expert's MLP on its
    capacity buffer."""
    h = torch.einsum("becd,edf->becf", buf, params["wi"])
    if cfg.mlp in ("swiglu", "glu"):
        h = F.silu(torch.einsum("becd,edf->becf", buf, params["wg"])) * h
    elif cfg.mlp == "geglu":
        h = F.gelu(torch.einsum("becd,edf->becf", buf, params["wg"]),
                   approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("becf,efd->becd", h, params["wo"])


def moe_block(params, cfg, x, routing_sum: Optional[Callable] = None,
              experts: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (y (B, S, d), metrics): ``moe_aux_loss`` (Switch
    load balance x ``router_aux_coef``), ``moe_z_loss`` (mean squared
    router log-partition x ``router_z_coef``) and ``moe_drop_frac``.
    ``routing_sum(counts, n)``, where given, returns the top-1 counts and
    the token count summed over the data-parallel ranks, so that the
    load-balance loss's expert fractions are the whole batch's, as on the
    single device (the sharded train step's, ``sharding.spmd``).

    ``experts`` (first, n), where given, says that ``params`` holds those
    n experts' weights alone (expert parallelism over a model axis): the
    whole router routes every token as before, but only those experts'
    capacity buffer is filled and run, and ``y`` is their part of the
    output, which the model members sum.  Capacity, drops and the
    auxiliary losses are every expert's, so the parts add up exactly."""
    B, S, d = x.shape
    E = cfg.num_experts
    C = capacity(cfg, S)
    n = E if experts is None else experts[1]
    logits, probs, gate_vals, expert_ids = route(params, cfg, x)
    buf, slot, valid = dispatch(x, expert_ids, E, C, experts)
    ybuf = expert_mlp(params, cfg, buf.reshape(B, n, C, d))
    mine = (slot, valid) if experts is None else own(slot, valid, C, experts)
    y = combine(ybuf.reshape(B, n * C, d), *mine, gate_vals)

    counts, n = count(expert_ids[..., 0], E), B * S
    if routing_sum is not None:
        counts, n = routing_sum(counts, n)
    frac_tokens = counts.float() / n
    mean_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * mean_probs)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    drop_frac = 1.0 - valid.float().mean()
    return y, {"moe_aux_loss": aux * cfg.router_aux_coef,
               "moe_z_loss": z * cfg.router_z_coef,
               "moe_drop_frac": drop_frac}


def moe_reference(params, cfg, x):
    """Dense loop-over-experts oracle with unlimited capacity."""
    E = cfg.num_experts
    _, _, gate_vals, expert_ids = route(params, cfg, x)
    y = torch.zeros_like(x)
    for e in range(E):
        h = x @ params["wi"][e]
        if cfg.mlp in ("swiglu", "glu"):
            h = F.silu(x @ params["wg"][e]) * h
        elif cfg.mlp == "geglu":
            h = F.gelu(x @ params["wg"][e], approximate="tanh") * h
        else:
            h = F.gelu(h, approximate="tanh")
        ye = h @ params["wo"][e]
        w = torch.where(expert_ids == e, gate_vals, torch.zeros_like(gate_vals)).sum(-1)
        y = y + ye * w[..., None].to(x.dtype)
    return y
