"""Depth <-> disparity <-> flow conversions (port of
``opticalflowfromdepth_tpu/core/convert.py``; the reference's ``Convert``,
`preprocess.py:237-298`). Random values come in as explicit draws."""

from __future__ import annotations

from typing import Tuple

import torch

from . import camera
from .geometry import backproject_depth, pixel_grid, project_3d


def depth_to_disparity(depth: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """disparity = s * B * f / depth, with the drawn scale ``s``
    (``GroupDraws.s``); `preprocess.py:238-246`."""
    return s * camera.BASELINE * camera.FOCAL / depth


def disparity_to_flow(disparity: torch.Tensor) -> torch.Tensor:
    """Disparity [1, H, W] -> horizontal flow (-d, 0) [2, H, W]
    (`preprocess.py:248-254`; the synthesis never flips its sign)."""
    return torch.cat([disparity, torch.zeros_like(disparity)], 0) * -1.0


def disparity_to_depth(disparity: torch.Tensor) -> torch.Tensor:
    """depth = B * f / (disparity + 0.005) (`preprocess.py:256-262`).
    A tensor numerator: ``float / tensor`` is a reciprocal times the
    float in PyTorch, which rounds otherwise than the division."""
    d = disparity + 0.005
    return torch.full_like(d, camera.BASELINE * camera.FOCAL) / d


def depth_to_random_flow(depth: torch.Tensor, T1: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 2-D flow [2, H, W] that the camera motion ``T1`` [1, 4, 4]
    (``camera.random_motion``) induces on depth [1, H, W]: backproject
    with the plausible intrinsics, move, reproject. Returns (flow, T1);
    `preprocess.py:264-298`."""
    _, h, w = depth.shape
    K, inv_K = camera.intrinsics(h, w, device=depth.device)
    cam_points = backproject_depth(depth[None], inv_K)
    p1, _ = project_3d(cam_points, K, T1, h, w)       # [1, H, W, 2]
    p1 = (p1 + 1.0) / 2.0
    p1 = p1 * torch.stack([torch.full((), w - 1.0, device=depth.device),
                           torch.full((), h - 1.0, device=depth.device)])
    p0 = pixel_grid(h, w, device=depth.device).permute(1, 2, 0)
    return (p1[0] - p0).permute(2, 0, 1), T1
