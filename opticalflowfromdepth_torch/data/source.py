"""Source depth datasets of the synthesis: ReDWeb and DIML (port of
``opticalflowfromdepth_tpu/data/source.py``; the reference's
`dataloader.py:13-58` and readers `utils.py:17-72`).

Arrays are channel-first float32, images RGB. The card's host has no
cv2, so the readers use Pillow (images, the 8-bit closeness map) and the
port's PNG codec (the 16-bit DIML disparity), and :func:`_resize_chw` is
``cv2.resize(..., INTER_LINEAR)`` on f32 in numpy: bilinear with
half-pixel centres, clamped at the border, no antialiasing, and at an
exact 2x reduction cv2's 2x2 mean, each in cv2's order of operations.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..core.depth_utils import smooth_closer
from . import frame_io


def _linear_taps(src: int, dst: int):
    """cv2's source index and f32 weight of the second tap for each output
    index: ``f = (float)((d + 0.5) * scale - 0.5)``, ``scale = 1 / (dst /
    src)`` in double."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    return s.astype(np.int64), (f - s).astype(np.float32)


def _resize_hwc(x: np.ndarray, th: int, tw: int) -> np.ndarray:
    h, w, c = x.shape
    if (h, w) == (2 * th, 2 * tw):
        # cv2 takes an exact 2x reduction as INTER_AREA's 2x2 mean
        a, b = x[0::2, 0::2], x[0::2, 1::2]
        cc, d = x[1::2, 0::2], x[1::2, 1::2]
        s = (a + b) + (cc + d) if c == 1 else ((a + b) + cc) + d
        return s * np.float32(0.25)
    # horizontal: left of the image the first pixel, right of it the last
    sx, fx = _linear_taps(w, tw)
    fx = np.where((sx < 0) | (sx >= w - 1), np.float32(0), fx)
    right = sx >= w - 1
    sx = np.clip(sx, 0, w - 1)
    a0, a1 = np.float32(1) - fx, fx
    rows = x[:, sx] * a0[:, None] + x[:, np.minimum(sx + 1, w - 1)] \
        * a1[:, None]
    rows[:, right] = x[:, sx[right]]
    # vertical: the rows clamped, the weights not
    sy, fy = _linear_taps(h, th)
    r0 = rows[np.clip(sy, 0, h - 1)]
    r1 = rows[np.clip(sy + 1, 0, h - 1)]
    return r0 * (np.float32(1) - fy)[:, None, None] \
        + r1 * fy[:, None, None]


def _resize_chw(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[C, H, W] float32 -> [C, th, tw] as ``cv2.resize(INTER_LINEAR)``
    computes it without IPP (cv2 with Intel IPP adds in another order,
    a few ulps off)."""
    c, h, w = arr.shape
    th, tw = size
    if (h, w) == (th, tw):
        return arr
    out = _resize_hwc(np.moveaxis(arr.astype(np.float32), 0, -1), th, tw)
    return np.ascontiguousarray(np.moveaxis(out, -1, 0))


def read_img_chw(path: str) -> np.ndarray:
    """RGB image -> [3, H, W] float32 (Pillow; gray files as three equal
    channels)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return np.ascontiguousarray(np.moveaxis(frame_io.read_image(path), -1, 0))


def read_relative_depth_chw(path: str) -> np.ndarray:
    """8-bit closeness map -> [1, H, W] depth through ``smooth_closer``
    (`utils.py:48-57, 118-121`: clamp 240, depth = 1 / (255 - c))."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return smooth_closer(frame_io.read_gray8(path))[None]


def read_disparity_chw(path: str) -> np.ndarray:
    """16-bit disparity PNG scaled by 63/255 -> [1, H, W] float32
    (`utils.py:61-73`)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    d = frame_io.read_png(path)
    if d.ndim == 3:       # cv2's IMREAD_UNCHANGED keeps the channels
        raise ValueError(f"a disparity PNG has one channel: {path}")
    d = d.astype(np.float32)
    return (d * 63.0 / 255.0)[None]


@dataclass
class Sample:
    name: str
    img0: np.ndarray              # [3, H, W]
    depth_or_disp: np.ndarray     # [1, H, W]
    img1: Optional[np.ndarray] = None  # stereo right (DIML)
    is_stereo: bool = False


def _names(list_file: str):
    with open(list_file) as f:
        return [ln.strip().split(".")[0] for ln in f if ln.strip()]


class ReDWeb:
    """Monocular relative depth (`dataloader.py:13-32`): ``Imgs/{name}.jpg``
    and ``RDs/{name}.png``."""

    def __init__(self, dataset_dir: str = "datasets/ReDWeb_V1",
                 list_file: str = "ReDWeb_list.txt"):
        self.dataset_dir = dataset_dir
        self.names = _names(list_file)

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx: int) -> Sample:
        name = self.names[idx]
        img = read_img_chw(os.path.join(self.dataset_dir, "Imgs",
                                        f"{name}.jpg"))
        depth = read_relative_depth_chw(
            os.path.join(self.dataset_dir, "RDs", f"{name}.png"))
        if depth.shape[1:] != img.shape[1:]:
            depth = _resize_chw(depth, img.shape[1:])
        return Sample(name, img, depth, is_stereo=False)


class DIML:
    """Stereo left/right and disparity (`dataloader.py:35-58`):
    ``train/LR/{outleft,outright,disparity}/{name}.png``."""

    def __init__(self, dataset_dir: str = "datasets/DIML",
                 list_file: str = "DIML_list.txt"):
        self.dataset_dir = dataset_dir
        self.names = _names(list_file)

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx: int) -> Sample:
        name = self.names[idx]
        base = os.path.join(self.dataset_dir, "train", "LR")
        img0 = read_img_chw(os.path.join(base, "outleft", f"{name}.png"))
        img1 = read_img_chw(os.path.join(base, "outright", f"{name}.png"))
        disp = read_disparity_chw(
            os.path.join(base, "disparity", f"{name}.png"))
        if disp.shape[1:] != img0.shape[1:]:
            disp = _resize_chw(disp, img0.shape[1:])
        return Sample(name, img0, disp, img1=img1, is_stereo=True)


SOURCES = {"ReDWeb": ReDWeb, "DIML": DIML}
