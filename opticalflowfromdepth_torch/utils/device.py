"""The device an entry point runs on, and what the kernels' host plans
read of it."""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``, looked up
    once a device: the hand-written kernels' host plans size their grids
    and split their sweeps by it."""
    return torch.cuda.get_device_properties(index).multi_processor_count
