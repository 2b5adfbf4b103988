"""Architecture config registry (a copy of ``repro.configs``: the arch
files are data, and the port imports nothing of ``repro``).

Each assigned architecture has its own module exporting ``config()``; the
registry exposes them by id for ``--arch <id>`` selection.  Every arch
resolves here; ``models.model.init_params`` refuses the families the
port does not run yet.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig, reduced

ARCH_IDS: List[str] = [
    "moonshot_v1_16b_a3b",
    "qwen3_moe_30b_a3b",
    "starcoder2_7b",
    "mamba2_780m",
    "paligemma_3b",
    "granite_8b",
    "zamba2_2p7b",
    "dbrx_132b",
    "qwen1p5_0p5b",
    "whisper_base",
    "h2_100b",            # the paper's own model (Table 4)
]

_ALIASES = {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "starcoder2-7b": "starcoder2_7b",
    "mamba2-780m": "mamba2_780m",
    "paligemma-3b": "paligemma_3b",
    "granite-8b": "granite_8b",
    "zamba2-2.7b": "zamba2_2p7b",
    "dbrx-132b": "dbrx_132b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "whisper-base": "whisper_base",
    "h2-100b": "h2_100b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f".{canonical(name)}", __package__)
    return mod.config()


def get_smoke_config(name: str) -> ModelConfig:
    return reduced(get_config(name))


def list_configs() -> List[str]:
    return list(ARCH_IDS)


ASSIGNED = [a for a in ARCH_IDS if a != "h2_100b"]
