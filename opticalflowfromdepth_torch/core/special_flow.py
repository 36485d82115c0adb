"""Flows of the image-level geometric augmentations (port of
``opticalflowfromdepth_tpu/core/special_flow.py``; the reference's
``SpecialFlow``, `preprocess.py:24-105`).

Each returns the forward flow (original -> transformed) and the backward
flow, [2, H, W], or [B, 2, H, W] for batched draws. As in the JAX
package, flips are vertical and shears take the ``[[1, s], [0, 1]]``
branch: the reference's latch never toggles back
(`preprocess.py:49,83,113-118`). The 2x2 products are written out as
multiplies and adds.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .geometry import pixel_grid

# The reference's effective flip orientation: vertical. The synthesis
# pipeline's mirror fast path reads the same constant.
FLIP_HORIZONTAL = False


def flip_flow(h: int, w: int, horizontal: bool = FLIP_HORIZONTAL,
              device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The mirror's flow (forward = backward), `preprocess.py:47-60`."""
    p0 = pixel_grid(h, w, device=device)
    p1 = p0.clone()
    if horizontal:
        p1[0] = (w - 1.0) - p0[0]
    else:
        p1[1] = (h - 1.0) - p0[1]
    flow = p1 - p0
    return flow, flow.clone()


def rotate_flow(cx: torch.Tensor, cy: torch.Tensor, theta_deg: torch.Tensor,
                h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotation by ``theta_deg`` about the pivot (``cx``, ``cy``) in
    pixels (``rng.draw_augment``, type 6); `preprocess.py:62-79`. Scalar
    draws give [2, H, W], draws of shape [B] give [B, 2, H, W]."""
    batched = cx.dim() == 1
    cx, cy, theta_deg = (v.reshape(-1, 1, 1) for v in (cx, cy, theta_deg))
    theta = theta_deg * (3.141592653589793 / 180.0)
    ct, st = torch.cos(theta), torch.sin(theta)
    p0 = pixel_grid(h, w, device=cx.device)[None]
    dx, dy = p0[:, 0] - cx, p0[:, 1] - cy
    # (p0 - c0) @ [[ct, -st], [st, ct]] + c0, and the reverse rotation
    p1 = torch.stack([dx * ct + dy * st + cx, dx * -st + dy * ct + cy], 1)
    prev = torch.stack([dx * ct + dy * -st + cx, dx * st + dy * ct + cy], 1)
    flow, back = p1 - p0, prev - p0
    return (flow, back) if batched else (flow[0], back[0])


def shear_flow(s: torch.Tensor, h: int, w: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shear by the drawn ``s`` (type 7), the reference's effective
    ``[[1, s], [0, 1]]`` branch: y moved by s * x (`preprocess.py:81-99`)."""
    batched = s.dim() == 1
    s = s.reshape(-1, 1, 1)
    p0 = pixel_grid(h, w, device=s.device)[None]
    x, y = p0[:, 0], p0[:, 1]
    x = x.expand_as(y * s)
    flow = torch.stack([x, x * s + y], 1) - p0
    back = torch.stack([x, x * -s + y], 1) - p0
    return (flow, back) if batched else (flow[0], back[0])
