"""The card's kernel lint (H2E511-516): will the card's kernels take the
shapes a run gives them?  The rules are ``kernels.card_rules``, the ones
the dispatch (``kernels.ops``) applies before each launch; this module
applies them to a model config before a run starts, as
``analysis/kernel_lint.py`` applies the TPU's tile rules.

    python -m repro_torch.analysis.card_lint --arch granite_8b \\
        [--smoke] [--model-parallel M] [--seq S]

prints each diagnostic, or ``CARD_LINT_OK <arch>``, and exits 1 on an
error.  The launchers call :func:`refuse_on_card` where a run on the
card is about to start (``launch/train.py``, ``launch/serve.py``) and the
dry-run where it estimates one (``launch/dryrun.py``: ``refused`` with
the code); a run on the CPU takes the plain versions and never asks.

Each rank's kernels see a model member's share of a block: the query
heads over the members, each member's kv head whole where the kv heads
are fewer (``sharding.spmd.member_cut``; a pipeline stage's tp block
likewise, ``heteropp._tp_local_cfg``), an ssm layer's heads over the
members; a part the members do not split, the whole model's
(``sharding.spmd.whole_parts``).  A decode on a cache sharded over its sequence runs every head
of the whole model on each member.  A config with no attention layer
(the ssm family) has no attention shapes to check.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

from ..kernels import card_rules as rules
from ..models.config import ModelConfig
from ..sharding.spmd import whole_parts
from .diagnostics import Diagnostic, error, format_report, split


class CardRefusal(ValueError):
    """A run whose kernels the card would refuse; ``diagnostics`` holds
    the errors."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = diagnostics
        super().__init__("the card's kernels refuse this run:\n"
                         + format_report(diagnostics))


def member_heads(cfg: ModelConfig, members: int) -> Tuple[int, int]:
    """(query heads, kv heads) one member of ``members`` computes: H / M
    and KV / M, or one kv head where the kv heads are fewer than the
    members.  The whole model's where the grid computes attention whole
    (``sharding.spmd.whole_parts``: the members do not divide the query
    heads, or the kv heads neither divide the members nor are divided by
    them)."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if members <= 1 or "attention" in whole_parts(cfg, members):
        return H, KV
    return H // members, max(1, KV // members)


def _attention(cfg: ModelConfig, members: int, where: str) -> List[Diagnostic]:
    diags = [error("H2E511", f"{kernel}: {msg}", where=where)
             for kernel in ("flash_attention", "flash_decode")
             for msg in rules.check_head_dim(cfg.head_dim)]
    H, KV = member_heads(cfg, members)
    groups = {cfg.num_heads // cfg.num_kv_heads if cfg.num_kv_heads > 0 else 0,
              H // KV if KV > 0 else 0}
    for group in sorted(g for g in groups if g > 0):
        diags += [error("H2E512", f"flash_decode: {msg}", where=where)
                  for msg in rules.check_decode_group(group, cfg.head_dim)]
    return diags


def _ssd(cfg: ModelConfig, seq_len: Optional[int], dtype: str,
         where: str) -> List[Diagnostic]:
    p, n = cfg.ssm_headdim, cfg.ssm_state
    chunk = cfg.ssm_chunk if seq_len is None else rules.ssd_chunk(seq_len, cfg.ssm_chunk)
    diags = [error("H2E513", f"ssd_scan: {msg}", where=where)
             for msg in rules.check_ssd_dims(p, n, chunk)]
    diags += [error("H2E514", f"ssd_scan: {msg}", where=where)
              for msg in rules.check_ssd_copies(p, n, dtype)]
    if seq_len is not None:
        diags += [error("H2E515", f"ssd_scan: {msg}", where=where)
                  for msg in rules.check_ssd_sequence(seq_len, cfg.ssm_chunk)]
    return diags


def check_card_kernels(cfg: ModelConfig, *, seq_len: Optional[int] = None,
                       heads_per_member: Optional[int] = None,
                       dtype: Optional[str] = None) -> List[Diagnostic]:
    """The card's rules over the shapes ``cfg``'s kernels see on one rank.

    ``heads_per_member``: the number of members a block's heads are split
    over (the grid's model axis, a pipeline stage's tp degree); None or 1
    for one device.  ``seq_len``: the sequence a train step or a prefill
    runs (an ssm layer's scan runs whole chunks of it); None checks what
    does not depend on it.  ``dtype``: the kernels' inputs, by default the
    config's."""
    members = heads_per_member or 1
    dtype = dtype or cfg.dtype
    where = f"model {cfg.name}"
    if members > 1:
        H, KV = member_heads(cfg, members)
        where += f", a member of {members}"
        shares = []
        if cfg.family != "ssm":
            shares.append(f"{H} of {cfg.num_heads} heads, {KV} of {cfg.num_kv_heads} kv heads")
        if cfg.family in ("ssm", "hybrid") and cfg.ssm_nheads % members == 0:
            shares.append(f"{cfg.ssm_nheads // members} of {cfg.ssm_nheads} ssm heads")
        if shares:
            where += f" ({'; '.join(shares)})"
    diags = [error("H2E516", msg, where=where) for msg in rules.check_dtype(dtype)]
    if cfg.family != "ssm":
        diags += _attention(cfg, members, where)
    if cfg.family in ("ssm", "hybrid"):
        diags += _ssd(cfg, seq_len, dtype, where)
    return diags


def require(cfg: ModelConfig, **kw) -> None:
    """Raise :class:`CardRefusal` where :func:`check_card_kernels` (same
    arguments) finds an error."""
    errs, _ = split(check_card_kernels(cfg, **kw))
    if errs:
        raise CardRefusal(errs)


def refuse_on_card(cfg: ModelConfig, device, backend: str, *,
                   seq_len: Optional[int] = None, members=(1,)) -> None:
    """A launcher's gate: exit (``SystemExit``, the diagnostics) where a
    run of ``cfg`` on ``device`` through ``backend`` would reach a kernel
    that refuses its shapes, for each count of ``members`` a block's heads
    are split over.  The CPU and the einsum path run the plain versions
    and are let through."""
    if device.type != "cuda" or backend == "einsum":
        return
    try:
        for m in members:
            require(cfg, seq_len=seq_len, heads_per_member=m)
    except CardRefusal as e:
        raise SystemExit(str(e)) from None


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.card_lint",
        description="check a model config against what the card's kernels take")
    p.add_argument("--arch", required=True, help="model config name")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced smoke variant of --arch")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="members a block's heads are split over")
    p.add_argument("--seq", type=int, default=None,
                   help="the sequence a train step or prefill runs")
    args = p.parse_args(argv)
    from ..configs import canonical, get_config, get_smoke_config
    name = canonical(args.arch)
    cfg = get_smoke_config(name) if args.smoke else get_config(name)
    errs, warns = split(check_card_kernels(cfg, seq_len=args.seq,
                                           heads_per_member=args.model_parallel))
    for d in warns:
        print(f"WARNING {d.format()}")
    for d in errs:
        print(d.format(), file=sys.stderr)
    if errs:
        return 1
    print(f"CARD_LINT_OK {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
