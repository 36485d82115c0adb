"""Bilinear sampling, flow warping and bilinear resize (port of
``opticalflowfromdepth_tpu/ops/sampling.py``).

The samplers have the semantics of ``F.grid_sample(mode='bilinear',
padding_mode='zeros', align_corners=True)``: out-of-range corner taps
contribute zero, so samples fade to 0 outside the image. The JAX
versions are XLA, not Pallas, so there is no kernel to port here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.geometry import pixel_grid


def bilinear_gather(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample ``img [C, H, W]`` at continuous pixel coordinates ``x``, ``y``
    (same shape S) -> ``[C, *S]``; out-of-range taps contribute zero."""
    c, h, w = img.shape
    shape = x.shape
    x = x.reshape(-1)
    y = y.reshape(-1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    flat = img.reshape(c, h * w)
    out = torch.zeros(c, x.shape[0], dtype=img.dtype, device=img.device)
    for ox, oy, wgt in ((0, 0, (1 - dx) * (1 - dy)), (1, 0, dx * (1 - dy)),
                        (0, 1, (1 - dx) * dy), (1, 1, dx * dy)):
        xi = x0 + ox
        yi = y0 + oy
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        out = out + flat[:, idx] * (wgt * inb).to(img.dtype)[None]
    return out.reshape((c,) + tuple(shape))


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = True) -> torch.Tensor:
    """torch-style grid_sample of one image: ``img [C, H, W]``, ``grid
    [..., 2]`` normalized (x, y) in [-1, 1] -> ``[C, ...]``, zero
    padding."""
    _, h, w = img.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        x = (gx + 1.0) / 2.0 * (w - 1)
        y = (gy + 1.0) / 2.0 * (h - 1)
    else:
        x = ((gx + 1.0) * w - 1.0) / 2.0
        y = ((gy + 1.0) * h - 1.0) / 2.0
    return bilinear_gather(img, x, y)


def flow_warp(feature: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``feature [B, C, H, W]`` by ``flow [B, 2, H, W]``:
    sample it at (pixel grid + flow), reference `gmflow/geometry.py:65-72`.
    ``F.grid_sample`` computes the same function in one call."""
    b, _, h, w = feature.shape
    pos = pixel_grid(h, w, device=flow.device)[None] + flow.float()
    norm = torch.stack([2.0 * pos[:, 0] / max(w - 1, 1) - 1.0,
                        2.0 * pos[:, 1] / max(h - 1, 1) - 1.0], dim=-1)
    return F.grid_sample(feature, norm.to(feature.dtype), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def _resize_weights_1d(n_in: int, n_out: int,
                       device) -> torch.Tensor:
    """[n_out, n_in] two-tap interpolation matrix; row i samples source
    coordinate i*(n_in-1)/(n_out-1), torch's align_corners=True grid."""
    w = torch.zeros(n_out, n_in, dtype=torch.float32, device=device)
    if n_in == 1 or n_out == 1:
        w[:, 0] = 1.0
        return w
    src = torch.arange(n_out, dtype=torch.float32,
                       device=device) * (n_in - 1) / (n_out - 1)
    lo = torch.clamp(torch.floor(src), 0, n_in - 2).long()
    frac = src - lo.float()
    rows = torch.arange(n_out, device=device)
    w[rows, lo] = 1.0 - frac
    w[rows, lo + 1] += frac
    return w


def resize_bilinear_align_corners(x: torch.Tensor, new_h: int,
                                  new_w: int) -> torch.Tensor:
    """Bilinear resize of NHWC [B, H, W, C], F.interpolate(mode='bilinear',
    align_corners=True) semantics, as two separable f32 products."""
    _, h, w, _ = x.shape
    out = x.float()
    if new_h != h:
        out = torch.einsum("oh,bhwc->bowc",
                           _resize_weights_1d(h, new_h, x.device), out)
    if new_w != w:
        out = torch.einsum("ow,bhwc->bhoc",
                           _resize_weights_1d(w, new_w, x.device), out)
    return out.to(x.dtype)
