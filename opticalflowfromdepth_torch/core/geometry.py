"""Pinhole-camera geometry (port of ``opticalflowfromdepth_tpu/core/geometry.py``).

  * :func:`pixel_grid`, :func:`pixel_grid_last` — the (x, y) identity grid
  * :func:`backproject_depth`  — depth map -> homogeneous camera points
  * :func:`project_3d`         — camera points -> normalized pixel coords
  * :func:`get_translation_matrix`, :func:`rot_from_axisangle`,
    :func:`transformation_from_parameters` — axis-angle and translation
    -> SE(3)

The JAX package takes its products at ``precision=HIGHEST``. Here every
product is written out as elementwise multiplies and adds (:func:`_matmul`),
so it stays true f32 on the card whatever ``allow_tf32`` says, and the
card and the CPU add in the same order.
"""

from __future__ import annotations

import torch


def pixel_grid(h: int, w: int, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """Identity pixel-coordinate grid, shape [2, H, W]; grid[0]=x, grid[1]=y."""
    y, x = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([x, y], dim=0)


def pixel_grid_last(h: int, w: int, dtype=torch.float32,
                    device="cpu") -> torch.Tensor:
    """Identity pixel grid with channels last, shape [H, W, 2] (x, y)."""
    return pixel_grid(h, w, dtype, device).permute(1, 2, 0)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over the last two axes as f32 multiplies and adds, the
    terms added in order of the inner index."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def backproject_depth(depth: torch.Tensor, inv_K: torch.Tensor
                      ) -> torch.Tensor:
    """Depth [B, 1, H, W] (or [B, H, W]) and inverse intrinsics [B, 4, 4]
    -> homogeneous camera points [B, 4, H*W] (x, y, z, 1)."""
    if depth.dim() == 3:
        depth = depth[:, None]
    b, _, h, w = depth.shape
    grid = pixel_grid(h, w, depth.dtype, depth.device).reshape(2, h * w)
    pix = torch.cat([grid, torch.ones_like(grid[:1])], 0)       # [3, HW]
    cam = _matmul(inv_K[:, :3, :3], pix.expand(b, 3, h * w))
    cam = depth.reshape(b, 1, h * w) * cam
    return torch.cat([cam, torch.ones_like(cam[:, :1])], 1)


def project_3d(points: torch.Tensor, K: torch.Tensor, T: torch.Tensor,
               h: int, w: int, eps: float = 1e-7):
    """Homogeneous points [B, 4, H*W] through ``K @ T`` -> (pixel coords
    [B, H, W, 2] normalized to [-1, 1] in (x, y) order, depth [B, 1,
    H*W])."""
    b = points.shape[0]
    P = _matmul(K, T)[:, :3, :]                                 # [B, 3, 4]
    cam = _matmul(P, points)                                    # [B, 3, HW]
    z = cam[:, 2:3, :]
    pix = cam[:, :2, :] / (z + eps)
    pix = pix.reshape(b, 2, h, w).permute(0, 2, 3, 1)
    # a tensor divisor: on the card a Python scalar divisor becomes a
    # multiply by its reciprocal, which rounds otherwise than the division
    scale = torch.stack([torch.full((), w - 1.0, device=pix.device),
                         torch.full((), h - 1.0, device=pix.device)])
    pix = (pix / scale - 0.5) * 2.0
    return pix, z


def get_translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """Translation [B, 3] (or [B, 1, 3]) -> [B, 4, 4]."""
    t = t.reshape(-1, 3)
    T = torch.eye(4, dtype=t.dtype, device=t.device).repeat(t.shape[0], 1, 1)
    T[:, :3, 3] = t
    return T


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [B, 1, 3] -> [B, 4, 4] rotation (Rodrigues)."""
    vec = vec.reshape(-1, 1, 3)
    angle = torch.sqrt((vec * vec).sum(2, keepdim=True))       # [B, 1, 1]
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]                               # [B, 1]
    sa = torch.sin(angle)[..., 0]
    C = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]          # [B, 1]
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC
    rot = torch.zeros(vec.shape[0], 4, 4, dtype=vec.dtype, device=vec.device)
    entries = {(0, 0): x * xC + ca, (0, 1): xyC - zs, (0, 2): zxC + ys,
               (1, 0): xyC + zs, (1, 1): y * yC + ca, (1, 2): yzC - xs,
               (2, 0): zxC - ys, (2, 1): yzC + xs, (2, 2): z * zC + ca}
    for (i, j), v in entries.items():
        rot[:, i, j] = v[:, 0]
    rot[:, 3, 3] = 1.0
    return rot


def transformation_from_parameters(axisangle: torch.Tensor,
                                   translation: torch.Tensor,
                                   invert: bool = False) -> torch.Tensor:
    """(axisangle [B, 1, 3], translation [B, 1, 3]) -> SE(3) [B, 4, 4]."""
    R = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        R = R.transpose(1, 2)
        t = -t
    T = get_translation_matrix(t)
    return _matmul(R, T) if invert else _matmul(T, R)
