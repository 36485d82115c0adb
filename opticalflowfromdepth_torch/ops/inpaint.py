"""Hole filling of warped images (port of ``opticalflowfromdepth_tpu/ops/inpaint.py``).

The reference round-trips every warped image to the CPU for cv2's Telea
inpaint (`utils.py:136-151`); the JAX package fills on the device with a
pull-push pyramid, and so does the port, in PyTorch ops (no Pallas
kernel in the JAX package, so no kernel here). Batched: [B, C, H, W].

Mask semantics (`utils.py:137-142`):
    M  = (valid != collision);  M' = dilate3x3(M);  P = (M' == M)
    keep = valid * P;  fill everywhere keep == 0
then floor and clip to [0, 255], as the reference's uint8 round trip.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _dilate3x3(mask: torch.Tensor) -> torch.Tensor:
    """Binary 3x3 dilation of [B, 1, H, W] (a max pool; its padding is
    -inf)."""
    return F.max_pool2d(mask, 3, stride=1, padding=1)


def _avgpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool of [B, C, H, W]; odd sizes are padded with zeros and
    still divided by 4 (so not ``ceil_mode``, which divides by the pixels
    inside the image). The four are added in raster order."""
    h, w = x.shape[-2:]
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2))
    s = x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2] \
        + x[..., 1::2, 1::2]
    return s / 4.0


def _upsample2(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest 2x upsample of [B, C, h2, w2] cropped to [B, C, h, w]."""
    *lead, h2, w2 = x.shape
    up = x[..., :, None, :, None].expand(*lead, h2, 2, w2, 2)
    return up.reshape(*lead, 2 * h2, 2 * w2)[..., :h, :w]


def pullpush_fill(img: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Fill ``img`` [B, C, H, W] where ``keep`` [B, 1, H, W] is 0: means
    weighted by validity pulled down to 1x1, then pushed back up, each
    level trusted where it has support."""
    h, w = img.shape[-2:]
    m = keep.to(img.dtype)
    levels = [(img * m, m)]
    lh, lw = h, w
    while lh > 1 or lw > 1:
        i_prev, m_prev = levels[-1]
        levels.append((_avgpool2(i_prev), _avgpool2(m_prev)))
        lh, lw = levels[-1][0].shape[-2:]
    i_k, m_k = levels[-1]
    est = i_k / torch.clamp(m_k, min=1e-8)
    for i_k, m_k in reversed(levels[:-1]):
        hh, ww = i_k.shape[-2:]
        up = _upsample2(est, hh, ww)
        val = i_k / torch.clamp(m_k, min=1e-8)
        alpha = torch.clamp(m_k, max=1.0)
        est = alpha * val + (1.0 - alpha) * up
    return torch.where(keep > 0, img, est)


def inpaint(img: torch.Tensor, valid: torch.Tensor, collision: torch.Tensor
            ) -> torch.Tensor:
    """Inpaint the holes of a warped image [B, C, H, W] (in [0, 255]) from
    the warp's ``valid`` and ``collision`` [B, 1, H, W] -> f32, filled,
    floored and clipped to [0, 255]. Unbatched [C, H, W] works too."""
    if img.dim() == 3:
        return inpaint(img[None], valid[None], collision[None])[0]
    M = (valid != collision).to(torch.float32)
    P = (_dilate3x3(M) == M).to(torch.float32)
    filled = pullpush_fill(img, valid * P)
    return torch.clamp(torch.floor(filled), 0.0, 255.0)
