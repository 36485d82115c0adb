"""Bilinear resize with align_corners=True (port of the JAX
``ops/sampling.py:resize_bilinear_align_corners``)."""

from __future__ import annotations

import torch


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
