"""Typed diagnostics for the static plan verifier (DESIGN.md §15).

Every check in ``repro_torch.analysis`` reports through one vocabulary:
``H2Exxx`` codes are load-time ERRORS (executing the plan would deadlock
a real mesh, OOM a chip, or crash at trace time — the gate refuses),
``H2Wxxx`` codes are WARNINGS (legal but wasteful or suspicious — the
gate prints and proceeds).  The hundreds digit names the pass family:

    1xx  plan shape        (malformed / inexpressible plan)
    2xx  schedule safety   (op-list invariants — DESIGN.md §3, §7)
    3xx  collective safety (divergence across participants — §12, §13)
    4xx  resource bounds   (per-stage memory vs chip HBM)
    5xx  kernel lint       (Pallas grid/block/page/group preconditions;
                            51x: the card's kernels, ``card_lint``)

The table below is the registry; tests assert every emitted code is in
it, so a new check must register its code here.

A copy of the JAX package's ``analysis/diagnostics.py``,
held equal to it by ``tests/test_torch_planning.py``, with the card's
codes H2E511-516 (``analysis/card_lint.py``) added to the registry.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

ERROR = "error"
WARNING = "warning"

#: code -> one-line meaning (the DESIGN.md §15 table is generated from
#: the same wording; keep them in sync)
CODES = {
    # --- plan shape ------------------------------------------------------
    "H2E101": "malformed or inexpressible plan (unknown schedule, "
              "unsupported (S, b), invalid sync config, layout the "
              "runtime refuses)",
    # --- schedule / tick-program safety ----------------------------------
    "H2E201": "op coverage violation: a (microbatch, chunk) is missing "
              "or duplicated in a stage's F/B/D/W ops",
    "H2E202": "placement violation: global_stage/device_of are not "
              "inverse bijections with increasing chunk slots",
    "H2E203": "causal-replay deadlock: the per-stage op order "
              "contradicts the stage topology",
    "H2E204": "inflight activation walk exceeds the schedule's "
              "closed form (the memory model would under-count)",
    "H2E205": "non-streamable op order: no tight tick-synchronous "
              "stream realizes the schedule (or a hop spans "
              "non-adjacent stages)",
    # --- collective divergence -------------------------------------------
    "H2E301": "per-replica tick programs disagree on length: tick "
              "count is not monotone in the allocation, participants "
              "would hang in the scan",
    "H2E302": "participants of a collective issue mismatched "
              "(op, axis, group, order) sequences — guaranteed "
              "deadlock on a real mesh",
    "H2E303": "a dp replica's tick program is underivable (its "
              "allocation is unsupported by the schedule) — "
              "participants cannot issue convergent sequences",
    "H2E304": "padded no-op ticks are not inert: an active op consumes "
              "a value produced on an inactive tick",
    "H2E305": "grouped stage tables inconsistent: membership matrix or "
              "boundary send/recv rows do not realize the declared "
              "reshard strategies",
    # --- resource bounds --------------------------------------------------
    "H2E401": "stage peak memory exceeds the chip HBM cap",
    # --- kernel preconditions ---------------------------------------------
    "H2E501": "tensor parallelism does not divide heads / kv heads / "
              "d_ff (Megatron shard precondition)",
    "H2E502": "GQA group is not integral: num_heads is not a multiple "
              "of num_kv_heads",
    "H2E503": "invalid flash_decode page size (not a positive multiple "
              "of the lane tile)",
    "H2E504": "tensor parallelism on a block kind the tp runtime does "
              "not shard (non-dense family)",
    # --- the card's kernels (analysis/card_lint.py; the port's own) ------
    "H2E511": "head_dim the card's attention kernels are not built for "
              "(flash_attention, flash_decode)",
    "H2E512": "GQA group wider than flash_decode holds (G * hd above "
              "2048)",
    "H2E513": "ssd_scan head dim, state or chunk past the kernel's tiles",
    "H2E514": "bf16 ssd_scan head dim or state off its 16-byte copies "
              "(multiples of 8)",
    "H2E515": "sequence not a whole number of ssd_scan chunks",
    "H2E516": "dtype the card's kernels do not take",
    # --- warnings ---------------------------------------------------------
    "H2W201": "closed-form alpha disagrees with the simulator-derived "
              "value",
    "H2W401": "stage peak memory within 10% of the chip HBM cap",
    "H2W501": "head_dim off the 128-lane tile (kernel blocks pad)",
    "H2W502": "GQA group below the sublane tile (decode pads the group)",
    "H2W503": "sequence length off the kernel page/block multiple "
              "(padded slots are masked, not free)",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of the static verifier.

    ``code`` is an ``H2Exxx``/``H2Wxxx`` registry entry; ``where`` names
    the plan element it anchors to (a stage, a replica, a boundary —
    free-form, for humans)."""
    code: str
    message: str
    where: Optional[str] = None

    def __post_init__(self):
        assert self.code in CODES, f"unregistered diagnostic {self.code}"

    @property
    def severity(self) -> str:
        return ERROR if self.code[2] == "E" else WARNING

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def format(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.code}{loc}: {self.message}"


def error(code: str, message: str, where: Optional[str] = None
          ) -> Diagnostic:
    d = Diagnostic(code, message, where)
    assert d.is_error, code
    return d


def warning(code: str, message: str, where: Optional[str] = None
            ) -> Diagnostic:
    d = Diagnostic(code, message, where)
    assert not d.is_error, code
    return d


def split(diags: Iterable[Diagnostic]
          ) -> Tuple[List[Diagnostic], List[Diagnostic]]:
    """(errors, warnings) partition, order preserved."""
    errs, warns = [], []
    for d in diags:
        (errs if d.is_error else warns).append(d)
    return errs, warns


def format_report(diags: Iterable[Diagnostic]) -> str:
    return "\n".join(d.format() for d in diags)
