"""What the card's kernels accept: the one source of the shapes, sizes and
types the CUDA kernels of ``csrc/`` take, for the dispatch that launches
them (``kernels.ops``) and for the static checks that refuse a run before
it starts (``analysis.card_lint``).

Plain functions over ints and dtype names; each returns a list of
messages, empty where the kernel takes the shape.  The dispatch raises
``ValueError`` with the first message after the kernel's name; the lint
reports each under its code.  This module imports neither torch nor jax.

``kernels/constraints.py`` is the TPU's counterpart (its 128-lane and
8-sublane tiles), copied from the JAX package and held equal to it; the
rules here are the card's own and take its place wherever a kernel runs
on the card.
"""
from __future__ import annotations

from typing import List

#: the kernels' element types by name (fp32 on the CUDA cores; bf16 and
#: fp16 on the tensor cores, but fp16 ``ssd_scan``, see ``ssd_scan.cu``)
DTYPES = ("float32", "bfloat16", "float16")

#: the head dims ``flash_attention`` and ``flash_decode`` are instantiated
#: for (``launch_hd`` in both sources)
HEAD_DIMS = (64, 80, 128, 256)

#: the widest GQA group ``flash_decode`` holds: G query heads of hd each
#: share a block, G * hd <= 2048 (the guard of ``repro_flash_decode``)
DECODE_GROUP_WIDTH = 2048

#: ``ssd_scan``'s largest head dim, state and chunk (``MAX_P``, ``MAX_N``,
#: ``MAX_CHUNK`` of ``ssd_scan.cu``)
SSD_MAX_HEAD_DIM, SSD_MAX_STATE, SSD_MAX_CHUNK = 64, 128, 256

#: the bf16 ``ssd_scan`` kernels copy x, B and C rows in 16-byte pieces:
#: head dim and state a multiple of 8 bf16 elements
SSD_COPY_BYTES = 16
SSD_BF16_MULTIPLE = SSD_COPY_BYTES // 2


def check_dtype(dtype: str) -> List[str]:
    """The kernels take fp32, bf16 and fp16 inputs only."""
    if dtype in DTYPES:
        return []
    return [f"dtype {dtype} not in {list(DTYPES)}"]


def check_head_dim(head_dim: int) -> List[str]:
    """``flash_attention`` and ``flash_decode`` are built for ``HEAD_DIMS``."""
    if head_dim in HEAD_DIMS:
        return []
    return [f"head_dim {head_dim} not in {HEAD_DIMS}"]


def check_decode_group(group: int, head_dim: int) -> List[str]:
    """``flash_decode`` holds a block's G query heads of one kv head at
    once: G * hd must not pass ``DECODE_GROUP_WIDTH``."""
    if group * head_dim <= DECODE_GROUP_WIDTH:
        return []
    return [f"a GQA group of G {group} x hd {head_dim} = {group * head_dim} is wider "
            f"than the kernel's {DECODE_GROUP_WIDTH}"]


def check_ssd_dims(head_dim: int, state: int, chunk: int) -> List[str]:
    """``ssd_scan``'s tiles hold a head dim, a state and a chunk up to
    ``SSD_MAX_HEAD_DIM``, ``SSD_MAX_STATE`` and ``SSD_MAX_CHUNK``."""
    if head_dim <= SSD_MAX_HEAD_DIM and state <= SSD_MAX_STATE \
            and chunk <= SSD_MAX_CHUNK:
        return []
    return [f"head_dim {head_dim}, state {state}, chunk {chunk} exceed the kernel's "
            f"{SSD_MAX_HEAD_DIM}, {SSD_MAX_STATE}, {SSD_MAX_CHUNK}"]


def check_ssd_copies(head_dim: int, state: int, dtype: str) -> List[str]:
    """The bf16 (tensor-core) kernels copy in 16-byte pieces: head dim and
    state multiples of 8.  fp32 and fp16 take any."""
    if dtype != "bfloat16" or not (head_dim % SSD_BF16_MULTIPLE
                                   or state % SSD_BF16_MULTIPLE):
        return []
    return [f"bf16 needs head_dim {head_dim} and state {state} to be multiples of "
            f"{SSD_BF16_MULTIPLE}"]


def ssd_chunk(seq_len: int, chunk: int) -> int:
    """The chunk the scan runs at: the configured one, cut to the sequence."""
    return min(chunk, seq_len)


def check_ssd_sequence(seq_len: int, chunk: int) -> List[str]:
    """The scan runs whole chunks: the sequence must be a multiple of the
    chunk (as cut by :func:`ssd_chunk`)."""
    chunk = ssd_chunk(seq_len, chunk)
    if chunk > 0 and seq_len % chunk == 0:
        return []
    return [f"sequence {seq_len} is not a multiple of chunk {chunk}"]


def check_ssd_initial_state(given: bool) -> List[str]:
    """The kernel starts from a zero state; a state goes through the
    chunked form (``models.ssm.ssd_chunked``)."""
    if not given:
        return []
    return ["the kernel starts from a zero state; an initial_state goes through "
            "ssd_chunked"]
