"""Device-side run statistics (the part of ``repro/obs/runtime.py`` the
single-device launchers use)."""
from __future__ import annotations

from typing import Optional

import torch


def device_memory_highwater(device=None) -> Optional[int]:
    """Peak bytes allocated by PyTorch on the card since the last
    ``torch.cuda.reset_peak_memory_stats``, or None on the CPU, which
    keeps no such count."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.max_memory_allocated(dev))
