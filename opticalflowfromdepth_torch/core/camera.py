"""Plausible-camera model (port of ``opticalflowfromdepth_tpu/core/camera.py``).

Reference: ``Plausible`` (`preprocess.py:184-235`): focal length 1,
stereo baseline 50, intrinsics fx = fy = 0.58 and cx = cy = 0.5 scaled by
(w, h), and a camera motion from explicit draws (``core/rng.py``). The
JAX package's ``another`` intrinsics and motion offsets, which no caller
uses, are not ported.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from .geometry import transformation_from_parameters

FOCAL = 1.0        # Plausible.f  (`preprocess.py:185-187`)
BASELINE = 50.0    # Plausible.B  (`preprocess.py:189-191`)


def intrinsics(h: int, w: int, device="cpu"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed plausible intrinsics (K, inv_K), each [1, 4, 4] f32; the
    inverse is analytic (`preprocess.py:193-209`). Cached per shape and
    device (one copy to the card per shape): do not modify them."""
    return _intrinsics(h, w, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _intrinsics(h: int, w: int, device: str):
    fx, cx = 0.58 * w, 0.5 * w
    fy, cy = 0.58 * h, 0.5 * h
    K = torch.tensor([[[fx, 0.0, cx, 0.0], [0.0, fy, cy, 0.0],
                       [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]]],
                     dtype=torch.float32, device=device)
    inv_K = torch.tensor([[[1.0 / fx, 0.0, -cx / fx, 0.0],
                           [0.0, 1.0 / fy, -cy / fy, 0.0],
                           [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]]],
                         dtype=torch.float32, device=device)
    return K, inv_K


def random_motion(axisangle: torch.Tensor, translation: torch.Tensor):
    """The SE(3) camera motion of drawn ``axisangle`` [3] and
    ``translation`` [3] (``rng.draw_group``) -> (T [1, 4, 4], axisangle
    [1, 1, 3], translation [1, 1, 3]); `preprocess.py:211-235`."""
    axisangle = axisangle.reshape(1, 1, 3)
    translation = translation.reshape(1, 1, 3)
    return (transformation_from_parameters(axisangle, translation),
            axisangle, translation)
