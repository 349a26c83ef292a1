"""The device an entry point builds on: the card unless the caller asks
for the CPU."""

from __future__ import annotations

import torch

__all__ = ["entry_device"]


def entry_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; the default ``"cuda"`` raises when
    there is no card rather than fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA card; pass device='cpu' to "
                           f"build on the CPU")
    return device
