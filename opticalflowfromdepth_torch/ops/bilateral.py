"""Sparse bilateral depth filter: a discontinuity-aware weighted median
(port of ``opticalflowfromdepth_tpu/ops/bilateral.py``; the reference's
``bilateral_filter.py``, vendored from 3d-photo-inpainting).

Tensor functions on the caller's device, in plain PyTorch: the weighted
median of every pixel's window at once over [H, W, K] patches (a stable
sort and a cumulative sum along K, added one tap at a time in f32 as
``np.cumsum`` and JAX add: ``torch.cumsum`` accumulates f32 in f64 on the
CPU, which moves medians across 0.5). The JAX package has no Pallas
kernel here, and the port has none either.

Semantics (``bilateral_filter.py``):
  * the discontinuity map from |d(1/depth)| > threshold on 4 directed
    differences, cropped to the interior and zero-padded (:63-116); zero
    depth counts as a discontinuity;
  * a pixel whose window holds no discontinuity keeps its value
    (:172-174);
  * the coefficient is 1 - discontinuity; an all-zero window keeps the
    centre value;
  * the weighted median is the first depth, in sorted order, whose
    cumulative normalised coefficient passes 0.5 (``np.digitize(0.5,
    cum)``);
  * the 1-pixel border is replaced by the interior's edge (:141-143).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _edge_pad(x: torch.Tensor, m: int) -> torch.Tensor:
    return F.pad(x[None, None], (m, m, m, m), mode="replicate")[0, 0]


def _patches(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[H, W] -> [H, W, ws*ws] edge-padded windows, row-major taps."""
    h, w = x.shape
    xp = _edge_pad(x, ws // 2)
    return torch.stack([xp[dy:dy + h, dx:dx + w]
                        for dy in range(ws) for dx in range(ws)], dim=-1)


def depth_discontinuity(depth: torch.Tensor, depth_threshold: float
                        ) -> torch.Tensor:
    """[H, W] f32 map: 1 where the disparity jumps or the depth is 0."""
    one = torch.ones((), dtype=depth.dtype, device=depth.device)
    disp = one / depth     # a tensor numerator: JAX's rounding of 1 / depth
    u = ((disp[1:, :] - disp[:-1, :])[:-1, 1:-1]).abs() > depth_threshold
    b = ((disp[:-1, :] - disp[1:, :])[1:, 1:-1]).abs() > depth_threshold
    l = ((disp[:, 1:] - disp[:, :-1])[1:-1, :-1]).abs() > depth_threshold
    r = ((disp[:, :-1] - disp[:, 1:])[1:-1, 1:]).abs() > depth_threshold
    disc = sum(F.pad(a.float(), (1, 1, 1, 1)) for a in (u, b, l, r))
    return torch.where(depth == 0, 1.0, disc.clamp(0.0, 1.0))


def _edge_reset(x: torch.Tensor) -> torch.Tensor:
    """The 1-pixel border replaced by the interior's edge."""
    return _edge_pad(x[1:-1, 1:-1], 1)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the last axis, added left to right in x's dtype
    (``np.cumsum``'s rounding on any device)."""
    out = torch.empty_like(x)
    acc = out[..., 0] = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = out[..., k] = acc + x[..., k]
    return out


def weighted_median(depth_patch: torch.Tensor, coef: torch.Tensor
                    ) -> torch.Tensor:
    """[..., K] depths and coefficients -> their weighted median."""
    d_sorted, order = torch.sort(depth_patch, dim=-1, stable=True)
    c_sorted = torch.gather(coef, -1, order)
    c_sum = c_sorted.sum(-1, keepdim=True)
    cum = _cumsum(c_sorted / c_sum.clamp_min(1e-12))
    # np.digitize(0.5, cum): the count of bins at or below 0.5
    ind = (cum <= 0.5).sum(-1, keepdim=True).clamp_max(
        depth_patch.shape[-1] - 1)
    return torch.gather(d_sorted, -1, ind)[..., 0]


def bilateral_filter_step(depth: torch.Tensor, discontinuity: torch.Tensor,
                          window_size: int) -> torch.Tensor:
    """One filtering pass (``bilateral_filter.py:119-235``, the
    discontinuity path)."""
    depth = _edge_reset(depth)
    disc = _patches(_edge_reset(discontinuity), window_size)
    coef = 1.0 - disc                          # the hole mask
    med = weighted_median(_patches(depth, window_size), coef)
    keep = ~(disc > 0).any(-1) | (coef.amax(-1) == 0)
    return torch.where(keep, depth, med)


def sparse_bilateral_filtering(depth: torch.Tensor,
                               filter_sizes: Sequence[int] = (5, 5),
                               depth_threshold: float = 0.04
                               ) -> torch.Tensor:
    """``len(filter_sizes)`` passes over an [H, W] depth
    (``bilateral_filter.py:13-60``); returns the filtered depth."""
    out = depth
    for ws in filter_sizes:
        out = bilateral_filter_step(
            out, depth_discontinuity(out, depth_threshold), ws)
    return out
