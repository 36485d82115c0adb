"""Pixel-coordinate helpers (port of ``opticalflowfromdepth_tpu/core/geometry.py``)."""

from __future__ import annotations

import torch


def pixel_grid(h: int, w: int, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """Identity pixel-coordinate grid, shape [2, H, W]; grid[0]=x, grid[1]=y."""
    y, x = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([x, y], dim=0)
