"""Kernel-precondition lint (H2E5xx / H2W5xx): the Pallas grid / block
/ page / group preconditions buried in ``kernels.ops`` dispatch and the
manual-tp shard rules, surfaced before anything compiles.  All
thresholds come from the jax-free ``kernels.constraints`` module — the
same numbers the kernels legalize against at trace time.

A copy of the JAX package's ``analysis/kernel_lint.py``,
held equal to it by ``tests/test_torch_planning.py``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..kernels import constraints as con
from ..models.config import ModelConfig

from .diagnostics import Diagnostic, error, warning


def check_attention(cfg: ModelConfig, seq_len: Optional[int] = None, *,
                    page_size: int = con.DEFAULT_PAGE
                    ) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    where = f"model {cfg.name}"
    if cfg.num_kv_heads <= 0 or cfg.num_heads % cfg.num_kv_heads:
        diags.append(error(
            "H2E502", f"num_heads={cfg.num_heads} is not a multiple of "
            f"num_kv_heads={cfg.num_kv_heads}; the GQA expansion and "
            "decode grouping need an integral group", where=where))
    for msg in con.check_page_size(page_size):
        diags.append(error("H2E503", msg, where=where))
    if diags:
        return diags
    if cfg.head_dim % con.LANE:
        diags.append(warning(
            "H2W501", f"head_dim={cfg.head_dim} is off the "
            f"{con.LANE}-lane tile; kernel blocks pad every head",
            where=where))
    group = cfg.num_heads // cfg.num_kv_heads
    if group < con.MIN_GROUP:
        diags.append(warning(
            "H2W502", f"GQA group {group} < sublane tile "
            f"{con.MIN_GROUP}; flash_decode pads the group "
            f"{con.MIN_GROUP / group:.0f}x", where=where))
    if seq_len is not None and seq_len % page_size:
        diags.append(warning(
            "H2W503", f"seq_len={seq_len} is off the {page_size}-wide "
            "kernel page; padded slots are masked, not free",
            where=where))
    return diags


def check_tp(cfg: ModelConfig, tps: Sequence[int]) -> List[Diagnostic]:
    """H2E501/H2E504 for every distinct tp degree a plan executes
    (uniform ``tensor_parallel`` or each grouped ``stage_tp`` entry —
    ``validate_spec_tp`` runs the same split per degree)."""
    diags: List[Diagnostic] = []
    wide = sorted(t for t in set(int(t) for t in tps) if t > 1)
    if not wide:
        return diags
    where = f"model {cfg.name}"
    if cfg.block_kind != "dense" or cfg.hybrid_attn_every \
            or cfg.is_encoder_decoder:
        diags.append(error(
            "H2E504", f"plan executes tp={wide} but the manual tp "
            f"runtime shards dense decoder blocks only (family "
            f"{cfg.family!r})", where=where))
        return diags
    for t in wide:
        for msg in con.check_tp_divisibility(cfg.num_heads,
                                             cfg.num_kv_heads,
                                             cfg.d_ff, t):
            diags.append(error("H2E501", msg, where=where))
    return diags


def check_kernels(cfg: ModelConfig, *, tps: Sequence[int] = (),
                  seq_len: Optional[int] = None,
                  page_size: Optional[int] = None) -> List[Diagnostic]:
    """All kernel-precondition checks for one model config."""
    diags = check_attention(cfg, seq_len,
                            page_size=page_size or con.DEFAULT_PAGE)
    diags += check_tp(cfg, tps)
    return diags
