"""Pallas kernel grid/block/page/group preconditions — jax-free.

The single source of the tiling constants the TPU kernels build their
grids from (``flash_attention`` / ``flash_decode`` import them from
here) plus the legalization rules the ``ops.py`` dispatch wrappers
apply around them.  Keeping both in one jax-free module lets the static
plan verifier (``repro_torch.analysis``, DESIGN.md §15) lint a model config
against the exact constraints the kernels will enforce at trace time —
without importing pallas.

Hard preconditions (dispatch would raise or compute garbage):

* GQA grouping needs ``num_heads % num_kv_heads == 0`` — the decode
  wrapper reshapes q to (B, KV, G, hd);
* ``flash_decode``'s page must be a positive multiple of the lane tile
  (the kernel streams the cache in (page, head_dim) blocks; a ragged
  page breaks the lane-aligned score tile);
* tensor parallelism must divide heads / kv heads / d_ff (the Megatron
  shard — mirrored from ``heteropp.validate_tensor_parallel``).

Soft preconditions (legal, but the wrapper pads and the padding is
wasted work — the verifier downgrades these to warnings):

* GQA group < MIN_GROUP: the decode wrapper pads the group up to the
  fp32 sublane tile, so a group of 1 computes 8 sublanes;
* head_dim off the lane tile: blocks pad to 128 lanes;
* sequence length off the page/block multiple: padded slots are masked
  through the bias / causal bound.

A copy of the JAX package's ``kernels/constraints.py``,
held equal to it by ``tests/test_torch_planning.py``.
Its TPU tile rules (128 lanes, 8 sublanes) only warn (H2W501-503);
Hopper's rules are ROADMAP A16.
"""
from __future__ import annotations

from typing import List

LANE = 128              # TPU lane tile (last-dim alignment)
DEFAULT_PAGE = 128      # lane-tile-aligned KV page length (flash_decode)
MIN_GROUP = 8           # fp32 sublane tile: pad the GQA group up to this
DEFAULT_BLOCK_Q = 128   # flash_attention q block rows
DEFAULT_BLOCK_K = 128   # flash_attention k block cols


def shrink_block_k(seq_k: int, block_k: int = DEFAULT_BLOCK_K) -> int:
    """Largest block ≤ ``block_k`` dividing ``seq_k`` — the non-causal
    flash-attention legalization: padded k rows would win the softmax
    (no causal bound masks them), so the dispatch shrinks the k block to
    a divisor of Sk instead of padding."""
    bk = min(block_k, max(seq_k, 1))
    while seq_k % bk:
        bk -= 1
    return bk


def check_page_size(page_size: int) -> List[str]:
    """Hard ``flash_decode`` page precondition: positive multiple of the
    lane tile."""
    problems = []
    if page_size <= 0:
        problems.append(f"page_size={page_size} must be positive")
    elif page_size % LANE:
        problems.append(
            f"page_size={page_size} is not a multiple of the {LANE}-lane "
            f"tile; the decode kernel streams the KV cache in "
            f"(page, head_dim) blocks and a ragged page breaks the "
            f"lane-aligned score tile")
    return problems


def check_attention_shapes(num_heads: int, num_kv_heads: int,
                           head_dim: int, seq_len: int, *,
                           page_size: int = DEFAULT_PAGE
                           ) -> tuple:
    """Attention kernel preconditions for a model shape.

    Returns ``(errors, warnings)`` — plain-string lists; the analysis
    layer maps them onto its diagnostic codes."""
    errors: List[str] = []
    warnings: List[str] = []
    if num_kv_heads <= 0 or num_heads % num_kv_heads:
        errors.append(
            f"num_heads={num_heads} is not a multiple of "
            f"num_kv_heads={num_kv_heads}; the GQA dispatch reshapes "
            f"q to (B, KV, G, hd) and needs an integral group")
    errors.extend(check_page_size(page_size))
    if head_dim % LANE:
        warnings.append(
            f"head_dim={head_dim} is off the {LANE}-lane tile; kernel "
            f"blocks pad the feature dim (wasted lanes)")
    if num_kv_heads > 0 and num_heads % num_kv_heads == 0:
        group = num_heads // num_kv_heads
        if group < MIN_GROUP:
            warnings.append(
                f"GQA group {group} < MIN_GROUP={MIN_GROUP}; the decode "
                f"wrapper pads the group up to the fp32 sublane tile "
                f"({MIN_GROUP - group} of {MIN_GROUP} sublanes wasted)")
    if page_size > 0 and seq_len % page_size:
        warnings.append(
            f"seq_len={seq_len} is off the page_size={page_size} "
            f"multiple; the decode wrapper pads the cache tail "
            f"({(-seq_len) % page_size} masked slots per page sweep)")
    return errors, warnings


def check_tp_divisibility(num_heads: int, num_kv_heads: int, d_ff: int,
                          tp: int) -> List[str]:
    """The Megatron shard preconditions one tp degree must satisfy —
    the jax-free mirror of ``heteropp.validate_tensor_parallel``'s
    divisibility rules."""
    if tp <= 1:
        return []
    problems = []
    for what, n in (("num_heads", num_heads),
                    ("num_kv_heads", num_kv_heads), ("d_ff", d_ff)):
        if n % tp:
            problems.append(
                f"tensor_parallel={tp} does not divide {what}={n}; "
                f"pick a tp that divides heads, kv heads and d_ff")
    return problems
