"""Host-side training augmentors (port of
``opticalflowfromdepth_tpu/data/augmentor.py``), without cv2.

The reference's two augmentor families
(`adjusted_RAFT/core/utils/augmentor.py:15-301`):

* :class:`FlowAugmentor` for dense ground truth: color jitter (asymmetric
  with p = 0.2), the eraser (p = 0.5, 1-2 boxes of 50-100 px in img2's
  mean colour), a random 2^U scale with an independent x/y stretch
  (p = 0.8), h/v flips (0.5 / 0.1) that negate the flow's component, a
  crop; back_flow and both depths follow the images;
* :class:`SparseFlowAugmentor` for sparse ground truth (KITTI): symmetric
  jitter, a nearest scatter of the valid flows to the resized grid, a crop
  with margins.

The card's host has no cv2. The JAX package calls it in two places, and
the port computes both in numpy as cv2 does:

* the hue jitter's 8-bit HSV (H in [0, 180)): :func:`rgb_to_hsv_u8` is
  cv2's integer ``RGB2HSV`` (its ``sdiv``/``hdiv`` tables, a 12-bit
  shift), :func:`hsv_to_rgb_u8` its float ``HSV2RGB`` (``1 - s*h``
  fused, V scaled by 1/255 and back; a row's first ``32 * k`` pixels take
  its vector path, which truncates, the rest its scalar path, which
  rounds), bit for bit;
* ``cv2.resize(src, None, fx, fy, INTER_LINEAR)``: ``data/source.py:
  resize_linear`` (u8 in cv2's fixed point, f32 in its float order).

Every other expression is the JAX module's, verbatim: ``r * [fx, fy]`` and
the flips' ``* [-1.0, 1.0]`` promote to f64 before the readers' final f32
cast, the eraser writes an f64 mean into u8 (truncating), and
``resize_sparse_flow_map`` uses Python's ``round``. Randomness comes from a
``np.random.Generator`` drawn in the JAX module's order, so the same
generator gives the same samples in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .source import resize_linear

HSV_SHIFT = 12      # cv2's fixed-point shift for RGB -> HSV
HSV_LANES = 32      # pixels a step of cv2's vectorised HSV -> RGB (AVX2)


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()
# for each sector, the entries of (v, p, q, t) that give b, g and r
_SECTOR = np.asarray([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                      [2, 1, 0]])


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` for u8 ``[..., 3]``."""
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> HSV_SHIFT
    h = h + np.where(h < 0, 180, 0)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2RGB)`` for u8 ``[H, W, 3]``, H in
    [0, 180)."""
    f32, f64 = np.float32, np.float64
    one = f32(1)
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h)
    h = h - sector

    def one_minus(a, b):     # cv2's 1 - a*b, one rounding (fused)
        return (f64(1) - a.astype(f64) * b).astype(f32)

    tab = np.stack([v, v * (one - s), v * one_minus(s, h),
                    v * one_minus(s, one - h)], -1)
    bgr = np.take_along_axis(tab, _SECTOR[sector.astype(np.int64) % 6], -1)
    x = bgr[..., ::-1] * f32(255)
    out = np.rint(x)
    n = hsv.shape[1] - hsv.shape[1] % HSV_LANES
    out[:, :n] = np.trunc(x[:, :n])
    return np.clip(out, 0, 255).astype(np.uint8)


def color_jitter(rng: np.random.Generator, img: np.ndarray,
                 brightness: float, contrast: float, saturation: float,
                 hue: float) -> np.ndarray:
    """Jitter a uint8 RGB image; factors sampled like torchvision's."""
    out = img.astype(np.float32)
    ops = list(rng.permutation(4))
    for op in ops:
        if op == 0 and brightness > 0:
            f = rng.uniform(1 - brightness, 1 + brightness)
            out = out * f
        elif op == 1 and contrast > 0:
            f = rng.uniform(1 - contrast, 1 + contrast)
            mean = out.mean()
            out = (out - mean) * f + mean
        elif op == 2 and saturation > 0:
            f = rng.uniform(1 - saturation, 1 + saturation)
            gray = out @ np.asarray([0.299, 0.587, 0.114], np.float32)
            out = (out - gray[..., None]) * f + gray[..., None]
        elif op == 3 and hue > 0:
            f = rng.uniform(-hue, hue)  # fraction of the hue circle
            hsv = rgb_to_hsv_u8(np.clip(out, 0, 255).astype(np.uint8))
            hsv = hsv.astype(np.int32)
            hsv[..., 0] = (hsv[..., 0] + int(round(f * 180))) % 180
            out = hsv_to_rgb_u8(hsv.astype(np.uint8)).astype(np.float32)
        out = np.clip(out, 0, 255)
    return out.astype(np.uint8)


class FlowAugmentor:
    """Dense-GT augmentor (`augmentor.py:15-176`). ``rng=None`` draws
    from an unseeded generator, as the JAX class does."""

    def __init__(self, crop_size: Tuple[int, int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip: bool = True,
                 eraser_aug_prob: float = 0.5,
                 jitter=(0.4, 0.4, 0.4, 0.5 / 3.14),
                 rng: Optional[np.random.Generator] = None):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = eraser_aug_prob
        self.jitter = jitter
        self.rng = rng or np.random.default_rng()

    # -- photometric --------------------------------------------------------
    def color_transform(self, img1, img2):
        if self.rng.random() < self.asymmetric_color_aug_prob:
            img1 = color_jitter(self.rng, img1, *self.jitter)
            img2 = color_jitter(self.rng, img2, *self.jitter)
        else:
            stack = np.concatenate([img1, img2], axis=0)
            stack = color_jitter(self.rng, stack, *self.jitter)
            img1, img2 = np.split(stack, 2, axis=0)
        return img1, img2

    def eraser_transform(self, img1, img2, bounds=(50, 100)):
        ht, wd = img1.shape[:2]
        if self.rng.random() < self.eraser_aug_prob:
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(self.rng.integers(1, 3)):
                x0 = int(self.rng.integers(0, wd))
                y0 = int(self.rng.integers(0, ht))
                dx = int(self.rng.integers(bounds[0], bounds[1]))
                dy = int(self.rng.integers(bounds[0], bounds[1]))
                img2 = img2.copy()
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    # -- spatial ------------------------------------------------------------
    def _resize_all(self, arrays, fx, fy, flow_scale_idx):
        """Resize every array; entries at flow_scale_idx also scale their
        (x, y) components."""
        out = []
        for i, a in enumerate(arrays):
            if a is None:
                out.append(None)
                continue
            squeeze = a.ndim == 3 and a.shape[2] == 1
            src = a[..., 0] if squeeze else a
            r = resize_linear(src, fx, fy)
            if squeeze:
                r = r[..., None]
            if i in flow_scale_idx:
                r = r * [fx, fy]
            out.append(r)
        return out

    def spatial_transform(self, img1, img2, flow, back_flow=None,
                          img1_depth=None, img2_depth=None):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum((self.crop_size[0] + 8) / float(ht),
                               (self.crop_size[1] + 8) / float(wd))
        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if self.rng.random() < self.stretch_prob:
            scale_x *= 2 ** self.rng.uniform(-self.max_stretch,
                                             self.max_stretch)
            scale_y *= 2 ** self.rng.uniform(-self.max_stretch,
                                             self.max_stretch)
        scale_x = np.clip(scale_x, min_scale, None)
        scale_y = np.clip(scale_y, min_scale, None)

        arrays = [img1, img2, flow, back_flow, img1_depth, img2_depth]
        if self.rng.random() < self.spatial_aug_prob:
            arrays = self._resize_all(arrays, scale_x, scale_y, {2, 3})
        else:
            # the crop must still fit (`augmentor.py:103-121`)
            sy = 1 if ht > self.crop_size[0] else (
                self.crop_size[0] + 8) / float(ht)
            sx = 1 if wd > self.crop_size[1] else (
                self.crop_size[1] + 8) / float(wd)
            if sx != 1 or sy != 1:
                arrays = self._resize_all(arrays, sx, sy, {2, 3})
        img1, img2, flow, back_flow, img1_depth, img2_depth = arrays

        if self.do_flip:
            if self.rng.random() < self.h_flip_prob:
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
                if back_flow is not None:
                    back_flow = back_flow[:, ::-1] * [-1.0, 1.0]
                if img1_depth is not None:
                    img1_depth = img1_depth[:, ::-1]
                if img2_depth is not None:
                    img2_depth = img2_depth[:, ::-1]
            if self.rng.random() < self.v_flip_prob:
                img1 = img1[::-1, :]
                img2 = img2[::-1, :]
                flow = flow[::-1, :] * [1.0, -1.0]
                if back_flow is not None:
                    back_flow = back_flow[::-1, :] * [1.0, -1.0]
                if img1_depth is not None:
                    img1_depth = img1_depth[::-1, :]
                if img2_depth is not None:
                    img2_depth = img2_depth[::-1, :]

        y0 = int(self.rng.integers(0, img1.shape[0] - self.crop_size[0] + 1))
        x0 = int(self.rng.integers(0, img1.shape[1] - self.crop_size[1] + 1))

        def crop(a):
            return None if a is None else np.ascontiguousarray(
                a[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]])

        return tuple(crop(a) for a in
                     (img1, img2, flow, back_flow, img1_depth, img2_depth))

    def __call__(self, img1, img2, flow, back_flow=None, img1_depth=None,
                 img2_depth=None):
        img1, img2 = self.color_transform(np.asarray(img1, np.uint8),
                                          np.asarray(img2, np.uint8))
        img1, img2 = self.eraser_transform(img1, img2)
        return self.spatial_transform(img1, img2, flow, back_flow,
                                      img1_depth, img2_depth)


class SparseFlowAugmentor:
    """Sparse-GT augmentor for KITTI-style data (`augmentor.py:178-301`).
    ``rng=None`` draws from an unseeded generator, as the JAX class does."""

    def __init__(self, crop_size: Tuple[int, int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip: bool = False,
                 eraser_aug_prob: float = 0.5,
                 jitter=(0.3, 0.3, 0.3, 0.3 / 3.14),
                 rng: Optional[np.random.Generator] = None):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.do_flip = do_flip
        self.eraser_aug_prob = eraser_aug_prob
        self.jitter = jitter
        self.rng = rng or np.random.default_rng()

    def color_transform(self, img1, img2):
        stack = np.concatenate([img1, img2], axis=0)
        stack = color_jitter(self.rng, stack, *self.jitter)
        return np.split(stack, 2, axis=0)

    def eraser_transform(self, img1, img2):
        ht, wd = img1.shape[:2]
        if self.rng.random() < self.eraser_aug_prob:
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(self.rng.integers(1, 3)):
                x0 = int(self.rng.integers(0, wd))
                y0 = int(self.rng.integers(0, ht))
                dx = int(self.rng.integers(50, 100))
                dy = int(self.rng.integers(50, 100))
                img2 = img2.copy()
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        """Coordinate-remapped nearest scatter (`augmentor.py:218-248`)."""
        ht, wd = flow.shape[:2]
        coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)),
                          axis=-1).reshape(-1, 2).astype(np.float32)
        flow_flat = flow.reshape(-1, 2).astype(np.float32)
        valid_flat = valid.reshape(-1).astype(np.float32)

        coords0 = coords[valid_flat >= 1]
        flow0 = flow_flat[valid_flat >= 1]

        ht1 = int(round(ht * fy))
        wd1 = int(round(wd * fx))
        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]

        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        keep = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)

        flow_img = np.zeros([ht1, wd1, 2], np.float32)
        valid_img = np.zeros([ht1, wd1], np.int32)
        flow_img[yy[keep], xx[keep]] = flow1[keep]
        valid_img[yy[keep], xx[keep]] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum((self.crop_size[0] + 1) / float(ht),
                               (self.crop_size[1] + 1) / float(wd))
        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        scale_x = float(np.clip(scale, min_scale, None))
        scale_y = float(np.clip(scale, min_scale, None))

        if self.rng.random() < self.spatial_aug_prob:
            img1 = resize_linear(img1, scale_x, scale_y)
            img2 = resize_linear(img2, scale_x, scale_y)
            flow, valid = self.resize_sparse_flow_map(flow, valid,
                                                      scale_x, scale_y)
        if self.do_flip and self.rng.random() < 0.5:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]

        margin_y, margin_x = 20, 50
        y0 = int(self.rng.integers(
            0, img1.shape[0] - self.crop_size[0] + margin_y))
        x0 = int(self.rng.integers(
            -margin_x, img1.shape[1] - self.crop_size[1] + margin_x))
        y0 = int(np.clip(y0, 0, img1.shape[0] - self.crop_size[0]))
        x0 = int(np.clip(x0, 0, img1.shape[1] - self.crop_size[1]))

        def crop(a):
            return np.ascontiguousarray(
                a[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]])
        return crop(img1), crop(img2), crop(flow), crop(valid)

    def __call__(self, img1, img2, flow, valid):
        img1, img2 = self.color_transform(np.asarray(img1, np.uint8),
                                          np.asarray(img2, np.uint8))
        img1, img2 = self.eraser_transform(img1, img2)
        return self.spatial_transform(img1, img2, flow, valid)
