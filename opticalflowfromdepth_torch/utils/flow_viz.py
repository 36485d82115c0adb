"""Middlebury flow colorization (S10).

Re-implementation of the reference's `flow_colors.py:13-118` (duplicated in
the reference as `flow_viz.py` in both model trees): the 55-color Middlebury
wheel, bilinear color interpolation over flow angle, radius-normalized
saturation, out-of-range darkening. The port's own copy of
``opticalflowfromdepth_tpu/utils/flow_viz.py``.
"""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """[55, 3] uint8-range Middlebury color wheel (`flow_colors.py:13-58`)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


_WHEEL = make_colorwheel()


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray,
                      convert_to_bgr: bool = False) -> np.ndarray:
    """Normalized (u, v) in [-1, 1] -> [H, W, 3] uint8
    (`flow_colors.py:61-92`)."""
    image = np.zeros((*u.shape, 3), np.uint8)
    ncols = _WHEEL.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    for i in range(3):
        col0 = _WHEEL[k0, i] / 255.0
        col1 = _WHEEL[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75  # out of range
        ch = 2 - i if convert_to_bgr else i
        image[..., ch] = np.floor(255 * col)
    return image


def flow_to_color(flow: np.ndarray, clip_flow: float = None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """[H, W, 2] flow -> [H, W, 3] uint8 with radius normalization
    (`flow_colors.py:95-118`)."""
    assert flow.ndim == 3 and flow.shape[2] == 2, flow.shape
    if clip_flow is not None:
        flow = np.clip(flow, 0, clip_flow)
    u, v = flow[..., 0], flow[..., 1]
    rad_max = np.max(np.sqrt(u ** 2 + v ** 2))
    eps = 1e-5
    return flow_uv_to_colors(u / (rad_max + eps), v / (rad_max + eps),
                             convert_to_bgr)
