"""Synthesized-shard dataset (port of the ``AugmentedShards`` reader in
``opticalflowfromdepth_tpu/data/datasets.py``).

Host-side numpy, one sample schema (a dict of arrays):

    image1 [H, W, 3] f32 (0..255)   image2 [H, W, 3] f32
    flow   [H, W, 2] f32            valid  [H, W] f32
    label  [4] f32 one-hot          back_flow, depth1, depth2

The shards are the synthesis writer's npz files (``{stem}_g{g}_a{a}.npz``
with the keys ``img0_1 img1_1 depth0_1 depth1_1 flow_1 back_flow_1``, the
same with ``_2``, and ``label``), read with ``np.load``. Only the plain
path is ported: a random side, flips and a random crop, in the JAX
reader's order of draws. The dense re-augmentation (``re_augment``) needs
the JAX package's cv2 ``FlowAugmentor``, which is not ported yet.
"""

from __future__ import annotations

import glob
import os.path as osp
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np

NUM_CLASSES = 4  # {none, flip, rotate, shear}; `dataloader.py:11`
FLOW_Q = 64.0    # int16 shard flows are fixed point, 1/64 px


def one_hot(label: int, n: int = NUM_CLASSES) -> np.ndarray:
    v = np.zeros((n,), np.float32)
    v[label] = 1.0
    return v


def dequantize_flow(arr: np.ndarray) -> np.ndarray:
    """Shard flow -> px: int16 fixed point (1/64 px) or float passthrough
    (a copy of ``synth/writer.py:dequantize_flow``)."""
    if arr.dtype == np.int16:
        return arr.astype(np.float32) / FLOW_Q
    return arr.astype(np.float32)


class AugmentedShards:
    """Reader for the synthesis writer's npz shards.

    Index selection mirrors `dataloader.py:235-268`: ``__len__`` is
    ``epochs x len(files)``; each sample takes a random side, then the
    plain flips (`dataloader.py:129-142`) and a random crop. valid is
    ``|flow| < 1000`` on both components and ``depth1 != 100``."""

    def __init__(self, root: str, crop_size: Optional[Tuple[int, int]] = None,
                 re_augment: bool = False, aug_params: Optional[dict] = None,
                 epochs: int = 2, seed: Optional[int] = None,
                 h_flip_prob: float = 0.5, v_flip_prob: float = 0.1):
        if re_augment or aug_params:
            raise NotImplementedError(
                "AugmentedShards(re_augment=True) needs the dense "
                "FlowAugmentor, which is not ported yet")
        self.root = root
        self.files = sorted(glob.glob(osp.join(root, "*_g*_a*.npz")))
        if not self.files:
            raise FileNotFoundError(f"no synthesized shards under {root}")
        self.crop_size = crop_size
        self.epochs = epochs
        self.rng = np.random.default_rng(seed)
        self.h_flip_prob = h_flip_prob
        self.v_flip_prob = v_flip_prob

    def __len__(self) -> int:
        return self.epochs * len(self.files)

    def _load(self, index: int) -> Dict[str, np.ndarray]:
        """Corrupt files fall through to the next index
        (`dataloader.py:81-91`)."""
        for off in range(len(self.files)):
            path = self.files[(index + off) % len(self.files)]
            try:
                with np.load(path) as z:
                    return {k: z[k] for k in z.files}
            except (OSError, ValueError, EOFError, zipfile.BadZipFile):
                continue
        raise RuntimeError(f"all shards unreadable under {self.root}")

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        data = self._load(index % len(self.files))
        side = int(self.rng.integers(0, 2))
        sfx = "1" if side == 0 else "2"
        img1 = data[f"img0_{sfx}"].astype(np.float32)
        img2 = data[f"img1_{sfx}"].astype(np.float32)
        flow = dequantize_flow(data[f"flow_{sfx}"])
        back_flow = dequantize_flow(data[f"back_flow_{sfx}"])
        depth1 = data[f"depth0_{sfx}"].astype(np.float32)
        depth2 = data[f"depth1_{sfx}"].astype(np.float32)
        label = int(data["label"])

        if self.rng.random() < self.h_flip_prob:
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            back_flow = back_flow[:, ::-1] * [-1.0, 1.0]
            depth1, depth2 = depth1[:, ::-1], depth2[:, ::-1]
        if self.rng.random() < self.v_flip_prob:
            img1, img2 = img1[::-1], img2[::-1]
            flow = flow[::-1] * [1.0, -1.0]
            back_flow = back_flow[::-1] * [1.0, -1.0]
            depth1, depth2 = depth1[::-1], depth2[::-1]
        if self.crop_size is not None:
            ch, cw = self.crop_size
            h, w = img1.shape[:2]
            y0 = int(self.rng.integers(0, max(h - ch, 0) + 1))
            x0 = int(self.rng.integers(0, max(w - cw, 0) + 1))
            sel = (slice(y0, y0 + ch), slice(x0, x0 + cw))
            img1, img2 = img1[sel], img2[sel]
            flow, back_flow = flow[sel], back_flow[sel]
            depth1, depth2 = depth1[sel], depth2[sel]

        d1 = np.squeeze(depth1, -1) if depth1.ndim == 3 else depth1
        valid = ((np.abs(flow[..., 0]) < 1000) &
                 (np.abs(flow[..., 1]) < 1000) &
                 (d1 != 100.0))
        return {
            "image1": np.ascontiguousarray(img1, np.float32),
            "image2": np.ascontiguousarray(img2, np.float32),
            "flow": np.ascontiguousarray(flow, np.float32),
            "back_flow": np.ascontiguousarray(back_flow, np.float32),
            "depth1": np.ascontiguousarray(
                depth1.reshape(depth1.shape[:2]), np.float32),
            "depth2": np.ascontiguousarray(
                depth2.reshape(depth2.shape[:2]), np.float32),
            "valid": np.ascontiguousarray(valid, np.float32),
            # label 0 for photometric types, 1/2/3 for flip/rotate/shear
            # (`dataloader.py:154-157`: max(0, type-4))
            "label": one_hot(max(0, label - 4)),
        }
