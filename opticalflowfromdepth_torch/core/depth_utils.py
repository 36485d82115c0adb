"""Depth hygiene (port of ``opticalflowfromdepth_tpu/core/depth_utils.py``;
the reference's in-place `utils.py:102-126` as masked functional ops).

Depths live in [1, 100], 100 being the "invalid / infinitely far"
sentinel that the forward warp's z-buffer and the valid masks rely on.
"""

from __future__ import annotations

import torch

INVALID_DEPTH = 100.0


def normalize_depth(depth: torch.Tensor) -> torch.Tensor:
    """Valid depth rescaled to [1, 99]; invalid (0 or > 100) -> 100.

    [1, H, W] is one image; [B, 1, H, W] takes its min and max per image.
    The sentinels become 100, ``dmin`` is the min after that, ``dmax``
    the max of the valid values, and valid values map to ``(d - dmin) *
    98 / (dmax - dmin) + 1`` (`utils.py:102-116`)."""
    dims = tuple(range(1, depth.dim())) if depth.dim() == 4 \
        else tuple(range(depth.dim()))
    d = torch.where((depth == 0) | (depth > 100.0),
                    torch.full_like(depth, 100.0), depth)
    invalid = d == 100.0
    dmin = d.amin(dim=dims, keepdim=True)
    dmax = torch.where(invalid, torch.zeros_like(d), d).amax(dim=dims,
                                                             keepdim=True)
    denom = torch.where(dmax == dmin, torch.ones_like(dmax), dmax - dmin)
    scaled = (d - dmin) * 98.0 / denom + 1.0
    return torch.where(invalid, torch.full_like(d, INVALID_DEPTH), scaled)


def smooth_closer(depth):
    """8-bit closeness ("closer is larger") -> depth: clamp at 240, then
    1 / (255 - d) (`utils.py:118-121`). A tensor or a numpy array (the
    source readers call it on the host)."""
    return 1.0 / (255.0 - depth.clip(max=240.0))


def fix_warped_depth(depth: torch.Tensor) -> torch.Tensor:
    """Holes (0) and near-max (> 99.5) depth -> the 100 sentinel
    (`utils.py:123-126`)."""
    return torch.where((depth == 0) | (depth > 99.5),
                       torch.full_like(depth, INVALID_DEPTH), depth)
