"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device with no card raises
    (the port never carries on on the CPU unless asked to)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for but no CUDA device "
                           "is available; pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return device
