"""Device resolution for every entry point of the port.

``None`` and ``"cuda"`` mean the card; ``"cpu"`` must be asked for by
name.  Asking for the card where there is none raises: the port never
carries on quietly on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DEVICES = ("cuda", "cpu")


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run the port on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}; expected one of {DEVICES}")


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
