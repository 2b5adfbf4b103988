"""Chip catalog for hyper-heterogeneous clusters.

The paper anonymizes its four vendors as Chips A–D (Table 5) and gives only
capability *bands* relative to an NVIDIA A100 plus memory and node size; the
exact sustained efficiencies are calibrated (see ``repro_torch.core.profiler``)
against the paper's own homogeneous throughput measurements (Table 6) — the
same role the paper's auto-profiler plays on real hardware.

A copy of the JAX package's ``core/chips.py``,
held equal to it by ``tests/test_torch_planning.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

A100_FP16 = 312e12


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float          # sustained-peak FP16/BF16 matmul FLOP/s
    memory_bytes: float
    chips_per_node: int
    intra_node_bw: float       # B/s effective per chip for TP collectives
    nic_bw: float              # B/s per chip for inter-node traffic
    mfu: float                 # calibrated matmul efficiency (profiler)
    pcie_bw: float = 16e9      # offload path (Chip D's CPU-offload mode)
    tp_max: int = 8

    @property
    def memory_gb(self) -> float:
        return self.memory_bytes / 2 ** 30


def _gb(x: float) -> float:
    return x * 2 ** 30


# Table 5 bands -> point values; mfu calibrated against Table 6 (see
# tests/test_paper_validation.py::test_homogeneous_tgs_matches_table6).
CHIPS: Dict[str, ChipSpec] = {
    "A": ChipSpec("A", 0.75 * A100_FP16, _gb(96), 16, 160e9, 12.5e9,
                  mfu=0.443, tp_max=16),
    "B": ChipSpec("B", 0.80 * A100_FP16, _gb(64), 8, 200e9, 12.5e9,
                  mfu=0.560, tp_max=8),
    "C": ChipSpec("C", 0.25 * A100_FP16, _gb(32), 16, 100e9, 12.5e9,
                  mfu=0.580, tp_max=16),
    # Chip D: fastest compute but 32 GB and NO high-speed intra-node fabric
    # (Fig 3 "complex intra-node topologies"): TP collectives ride a shared
    # PCIe complex -> 18 GB/s effective, which is what throttles its TGS
    "D": ChipSpec("D", 1.75 * A100_FP16, _gb(32), 8, 18e9, 12.5e9,
                  mfu=0.560, tp_max=8),
    "A100": ChipSpec("A100", A100_FP16, _gb(80), 8, 300e9, 25e9,
                     mfu=0.55, tp_max=8),
    # TPU islands for the JAX/TPU mapping (DESIGN.md §2)
    "v5e": ChipSpec("v5e", 197e12, _gb(16), 256, 45e9, 25e9,
                    mfu=0.55, tp_max=16),
    "v4": ChipSpec("v4", 275e12, _gb(32), 256, 60e9, 25e9,
                   mfu=0.55, tp_max=16),
}


@dataclasses.dataclass(frozen=True)
class ChipGroup:
    """A homogeneous island: ``count`` chips of one type."""
    spec: ChipSpec
    count: int
    label: str = ""

    @property
    def name(self) -> str:
        return self.label or self.spec.name


def cluster(*groups: Tuple[str, int]) -> List[ChipGroup]:
    return [ChipGroup(CHIPS[name], count) for name, count in groups]


# Table 7 experiment configurations
EXPERIMENTS: Dict[str, dict] = {
    "Exp-A-1": {"groups": [("A", 256), ("B", 256), ("C", 256)], "gbs_tokens": 2 * 2 ** 20},
    "Exp-A-2": {"groups": [("A", 256), ("B", 256), ("C", 256)], "gbs_tokens": 6 * 2 ** 20},
    "Exp-B-1": {"groups": [("A", 256), ("B", 256), ("C", 256), ("D", 256)], "gbs_tokens": 2 * 2 ** 20},
    "Exp-B-2": {"groups": [("A", 256), ("B", 256), ("C", 256), ("D", 256)], "gbs_tokens": 8 * 2 ** 20},
    "Exp-C-1": {"groups": [("A", 384), ("B", 1024)], "gbs_tokens": 4 * 2 ** 20},
    "Exp-C-2": {"groups": [("A", 384), ("B", 1024)], "gbs_tokens": 8 * 2 ** 20},
    "Exp-D": {"groups": [("A", 384), ("B", 2048)], "gbs_tokens": 8 * 2 ** 20},
}

# Table 6: homogeneous baselines (256 chips, GBS 2M tokens) — chip ->
# (PP, DP, TP, recompute, offload, TGS)
TABLE6 = {
    "A": {"pp": 16, "dp": 4, "tp": 4, "recompute": False, "offload": False,
          "tgs": 136.9},
    "B": {"pp": 16, "dp": 4, "tp": 4, "recompute": True, "offload": False,
          "tgs": 143.7},
    "C": {"pp": 32, "dp": 2, "tp": 4, "recompute": True, "offload": False,
          "tgs": 46.2},
    "D": {"pp": 8, "dp": 4, "tp": 8, "recompute": False, "offload": True,
          "tgs": 99.5},
}
