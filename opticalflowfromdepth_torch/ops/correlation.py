"""RAFT correlation in plain PyTorch: the dense pyramid and the on-demand
lookup (port of ``opticalflowfromdepth_tpu/ops/correlation.py``).

These are RAFT's ``corr_impl="pyramid"`` and ``alternate_corr`` modes.
Feature maps, coordinates and lookups use the JAX layouts: NHWC
``[B, H, W, C]`` maps, ``[B, H, W, 2]`` (x, y) coordinates and
``[B, H, W, num_levels*(2r+1)^2]`` lookups, x-major within each window.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F


def _avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID average pool over the trailing two dims of [B, M, H, W];
    a side shorter than 2 pools to an empty level (as XLA's VALID window)."""
    h, w = x.shape[-2:]
    if h < 2 or w < 2:
        return x.new_zeros(*x.shape[:-2], h // 2, w // 2)
    return F.avg_pool2d(x, 2, 2)


def _window_delta(radius: int, device="cpu") -> torch.Tensor:
    """[(2r+1)^2, 2] window offsets in (x, y) order, **x-major** flattening:
    k = kx*(2r+1) + ky, the reference's channel order (ported checkpoints'
    convc1 weights depend on it)."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    xo, yo = torch.meshgrid(d, d, indexing="ij")     # xo varies along axis 0
    return torch.stack([xo.reshape(-1), yo.reshape(-1)], dim=-1)


def _separable_window_lookup(corr: torch.Tensor, coords: torch.Tensor,
                             radius: int) -> torch.Tensor:
    """corr [B, N, hl, wl] (one level), coords [B, N, 2] level pixels ->
    [B, N, (2r+1)^2] as two products against bilinear indicator matrices;
    out-of-range taps match no row and contribute exactly 0."""
    b, n, hl, wl = corr.shape
    k = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=corr.device)

    def indicator(center, fr, size):
        base = center[..., None] + d                          # [B, N, K]
        i = torch.arange(size, dtype=torch.float32, device=corr.device)
        lo = (i == base[..., None]).float()
        hi = (i == base[..., None] + 1.0).float()
        return ((1.0 - fr)[..., None, None] * lo
                + fr[..., None, None] * hi).to(corr.dtype)

    cx, cy = coords[..., 0], coords[..., 1]
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    ymat = indicator(y0, cy - y0, hl)                         # [B, N, K, hl]
    xmat = indicator(x0, cx - x0, wl)                         # [B, N, K, wl]
    # f32 accumulation of the (exactly representable) low-precision products
    tmp = torch.einsum("bnkh,bnhw->bnkw", ymat.float(), corr.float())
    out = torch.einsum("bnxw,bnkw->bnxk", xmat.float(),
                       tmp.to(corr.dtype).float())
    return out.to(corr.dtype).reshape(b, n, k * k)


class CorrPyramid:
    """All-pairs correlation pyramid (the dense ``pyramid`` path).

    ``dtype`` is the storage/lookup dtype. The volume product is a plain
    ``torch.matmul`` with f32 accumulation; pooling runs in f32.
    """

    def __init__(self, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 num_levels: int = 4, radius: int = 4,
                 dtype=torch.float32):
        self.num_levels = num_levels
        self.radius = radius
        self.dtype = dtype
        b, h, w, c = fmap1.shape
        f1 = fmap1.to(dtype).reshape(b, h * w, c).float()
        f2 = fmap2.to(dtype).reshape(b, h * w, c).float()
        corr = torch.matmul(f1, f2.transpose(1, 2)) / (float(c) ** 0.5)
        corr = corr.reshape(b, h * w, h, w).to(dtype)
        self.levels: List[torch.Tensor] = [corr]
        for _ in range(num_levels - 1):
            corr = _avg_pool2x2(corr.float()).to(dtype)
            self.levels.append(corr)

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        """coords [B, H, W, 2] -> [B, H, W, num_levels*(2r+1)^2]."""
        b, h, w, _ = coords.shape
        n = h * w
        out = [_separable_window_lookup(
            corr, coords.reshape(b, n, 2).float() / (2.0 ** i), self.radius)
            for i, corr in enumerate(self.levels)]
        return torch.cat(out, dim=-1).reshape(b, h, w, -1)


def on_demand_corr(fmap1: torch.Tensor, fmap2: torch.Tensor,
                   coords: torch.Tensor, num_levels: int = 4,
                   radius: int = 4, dtype=torch.float32) -> torch.Tensor:
    """Memory-efficient lookup (the ``alternate_corr`` path): bilinearly
    gathered f2 windows dotted with f1, no H^2W^2 volume. Same contract as
    :class:`CorrPyramid`."""
    b, h, w, c = fmap1.shape
    n = h * w
    scale = 1.0 / (float(c) ** 0.5)
    delta = _window_delta(radius, fmap1.device)                # [K, 2]
    k = delta.shape[0]
    f1 = fmap1.to(dtype).reshape(b, n, c)
    f2 = fmap2.to(dtype)

    out = []
    for i in range(num_levels):
        hl, wl = f2.shape[1], f2.shape[2]
        cl = coords.reshape(b, n, 1, 2).float() / (2.0 ** i) + delta
        x, y = cl[..., 0], cl[..., 1]
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        dx = x - x0
        dy = y - y0
        f2_flat = f2.reshape(b, hl * wl, c)
        win = torch.zeros(b, n, k, c, dtype=dtype, device=fmap1.device)
        taps = () if hl * wl == 0 else (
            (0, 0, (1 - dx) * (1 - dy)), (1, 0, dx * (1 - dy)),
            (0, 1, (1 - dx) * dy), (1, 1, dx * dy))
        for ox, oy, wt in taps:
            xi = x0 + ox
            yi = y0 + oy
            inb = (xi >= 0) & (xi <= wl - 1) & (yi >= 0) & (yi <= hl - 1)
            xc = torch.clamp(xi, 0, wl - 1).long()
            yc = torch.clamp(yi, 0, hl - 1).long()
            idx = (yc * wl + xc).reshape(b, n * k, 1).expand(-1, -1, c)
            vals = torch.gather(f2_flat, 1, idx).reshape(b, n, k, c)
            win = win + vals * (wt * inb)[..., None].to(dtype)
        corr = torch.einsum("bnc,bnkc->bnk", f1.float(), win.float()) * scale
        out.append(corr.to(dtype))
        f2 = _avg_pool2x2(f2.float().permute(0, 3, 1, 2))
        f2 = f2.permute(0, 2, 3, 1).to(dtype)
    return torch.cat(out, dim=-1).reshape(b, h, w, -1)
