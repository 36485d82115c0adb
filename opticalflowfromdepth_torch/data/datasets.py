"""Datasets (port of ``opticalflowfromdepth_tpu/data/datasets.py``): the
benchmark flow datasets the validators and submissions read, and the
synthesized-shard reader the trainers read.

Host-side numpy, one sample schema (a dict of arrays):

    image1 [H, W, 3] f32 (0..255)   image2 [H, W, 3] f32
    flow   [H, W, 2] f32            valid  [H, W] f32
    label  [4] f32 one-hot          (shards) back_flow, depth1, depth2

Benchmark datasets: MpiSintel (with occlusion maps), FlyingChairs,
FlyingThings3D, KITTI, KITTI12, FineTuneKITTI15 (160/40 split), without
augmentation (``aug_params=None``): the validators and submissions read
them so. HD1K is a training set and waits for the augmentor.

The shards are the synthesis writer's npz files (``{stem}_g{g}_a{a}.npz``
with the keys ``img0_1 img1_1 depth0_1 depth1_1 flow_1 back_flow_1``, the
same with ``_2``, and ``label``), read with ``np.load``. Only the plain
path is ported: a random side, flips and a random crop, in the JAX
reader's order of draws. Augmentation (``aug_params``, ``re_augment``)
needs the JAX package's cv2 ``FlowAugmentor``, which is not ported yet
(``ROADMAP.md``, queue 1, item 2).
"""

from __future__ import annotations

import glob
import os
import os.path as osp
import warnings
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import frame_io

NUM_CLASSES = 4  # {none, flip, rotate, shear}; `dataloader.py:11`
FLOW_Q = 64.0    # int16 shard flows are fixed point, 1/64 px


def one_hot(label: int, n: int = NUM_CLASSES) -> np.ndarray:
    v = np.zeros((n,), np.float32)
    v[label] = 1.0
    return v


class FlowDataset:
    """Base reader (`adjusted_RAFT/core/datasets.py:18-100`), without
    augmentation."""

    def __init__(self, aug_params: Optional[dict] = None,
                 sparse: bool = False):
        if aug_params is not None:
            raise NotImplementedError(
                "dataset augmentation (aug_params) needs the cv2-free "
                "FlowAugmentor, which is not ported yet (ROADMAP.md, queue "
                "1, item 2)")
        self.sparse = sparse
        self.is_test = False
        self.flow_list: List[str] = []
        self.image_list: List[Tuple[str, str]] = []
        self.extra_info: List = []

    def __len__(self) -> int:
        return len(self.image_list)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        index = index % len(self.image_list)
        img1 = np.asarray(frame_io.read_gen(self.image_list[index][0]),
                          np.uint8)
        img2 = np.asarray(frame_io.read_gen(self.image_list[index][1]),
                          np.uint8)
        if img1.ndim == 2:  # grayscale
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1 = img1[..., :3]
            img2 = img2[..., :3]

        if self.is_test:
            return {
                "image1": img1.astype(np.float32),
                "image2": img2.astype(np.float32),
                "extra_info": self.extra_info[index],
            }

        if self.sparse:
            flow, valid = frame_io.read_flow_kitti(self.flow_list[index])
        else:
            flow = np.asarray(frame_io.read_gen(self.flow_list[index]),
                              np.float32)
            # dense GT: valid where |flow| < 1000 (`datasets.py:95-98`)
            valid = ((np.abs(flow[..., 0]) < 1000) &
                     (np.abs(flow[..., 1]) < 1000))
        return {
            "image1": np.ascontiguousarray(img1, np.float32),
            "image2": np.ascontiguousarray(img2, np.float32),
            "flow": np.ascontiguousarray(flow, np.float32),
            "valid": np.ascontiguousarray(valid, np.float32),
            "label": one_hot(0),
        }


class MpiSintel(FlowDataset):
    """`datasets.py:103-131`; also loads occlusion maps when asked
    (GMFlow's matched/unmatched eval, `adjusted_gmflow/data/datasets.py:
    61-127`)."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/Sintel", dstype="clean",
                 load_occlusion: bool = False):
        super().__init__(aug_params)
        flow_root = osp.join(root, split, "flow")
        image_root = osp.join(root, split, dstype)
        occ_root = osp.join(root, split, "occlusions")
        self.occ_list: List[str] = []
        self.load_occlusion = load_occlusion
        if split == "test":
            self.is_test = True
        for scene in sorted(os.listdir(image_root)):
            image_list = sorted(glob.glob(osp.join(image_root, scene,
                                                   "*.png")))
            for i in range(len(image_list) - 1):
                self.image_list.append((image_list[i], image_list[i + 1]))
                self.extra_info.append((scene, i))
            if split != "test":
                self.flow_list.extend(sorted(
                    glob.glob(osp.join(flow_root, scene, "*.flo"))))
                if load_occlusion:
                    self.occ_list.extend(sorted(
                        glob.glob(osp.join(occ_root, scene, "*.png"))))
        if load_occlusion and split != "test":
            # a partially populated occlusions/ tree would pair occlusion
            # maps with the wrong frames: raise instead
            if not self.occ_list:
                warnings.warn(
                    f"load_occlusion requested but no occlusion maps under "
                    f"{occ_root}; matched/unmatched metrics will be skipped")
                self.load_occlusion = False
            elif len(self.occ_list) != len(self.flow_list):
                raise ValueError(
                    f"Sintel occlusions/ is partially populated: "
                    f"{len(self.occ_list)} occlusion maps vs "
                    f"{len(self.flow_list)} flows under {occ_root}")

    def __getitem__(self, index):
        sample = super().__getitem__(index)
        if self.load_occlusion and not self.is_test and self.occ_list:
            occ = frame_io.read_image(self.occ_list[index])
            sample["occlusion"] = (occ[..., 0] > 127).astype(np.float32)
        return sample


class FlyingChairs(FlowDataset):
    """`datasets.py:134-155`; split via chairs_split.txt (1 train, 2
    validation; all train when the file is missing)."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/FlyingChairs_release/data",
                 split_file="chairs_split.txt"):
        super().__init__(aug_params)
        images = sorted(glob.glob(osp.join(root, "*.ppm")))
        flows = sorted(glob.glob(osp.join(root, "*.flo")))
        if len(images) // 2 != len(flows):
            raise ValueError(f"FlyingChairs: {len(images)} images for "
                             f"{len(flows)} flows under {root}")
        split_path = split_file if osp.exists(split_file) else osp.join(
            osp.dirname(root), split_file)
        if osp.exists(split_path):
            split_list = np.loadtxt(split_path, dtype=np.int32)
        else:
            split_list = np.ones((len(flows),), np.int32)
        for i in range(len(flows)):
            xid = split_list[i]
            if (split == "training" and xid == 1) or \
               (split == "validation" and xid == 2):
                self.flow_list.append(flows[i])
                self.image_list.append((images[2 * i], images[2 * i + 1]))


class FlyingThings3D(FlowDataset):
    """`datasets.py:158-198`; both directions, the TEST split optional."""

    def __init__(self, aug_params=None, root="datasets/FlyingThings3D",
                 dstype="frames_cleanpass", test_set: bool = False):
        super().__init__(aug_params)
        split_dir = "TEST" if test_set else "TRAIN"
        cam = "left"
        for direction in ("into_future", "into_past"):
            image_dirs = sorted(glob.glob(
                osp.join(root, dstype, f"{split_dir}/*/*")))
            image_dirs = sorted([osp.join(f, cam) for f in image_dirs])
            flow_dirs = sorted(glob.glob(
                osp.join(root, f"optical_flow/{split_dir}/*/*")))
            flow_dirs = sorted(
                [osp.join(f, direction, cam) for f in flow_dirs])
            for idir, fdir in zip(image_dirs, flow_dirs):
                images = sorted(glob.glob(osp.join(idir, "*.png")))
                flows = sorted(glob.glob(osp.join(fdir, "*.pfm")))
                for i in range(len(flows) - 1):
                    if direction == "into_future":
                        self.image_list.append((images[i], images[i + 1]))
                        self.flow_list.append(flows[i])
                    else:
                        self.image_list.append((images[i + 1], images[i]))
                        self.flow_list.append(flows[i + 1])


class KITTI(FlowDataset):
    """KITTI-2015 (`datasets.py:201-219`)."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/KITTI"):
        super().__init__(aug_params, sparse=True)
        if split == "testing":
            self.is_test = True
        root = osp.join(root, split)
        images1 = sorted(glob.glob(osp.join(root, "image_2/*_10.png")))
        images2 = sorted(glob.glob(osp.join(root, "image_2/*_11.png")))
        for img1, img2 in zip(images1, images2):
            self.extra_info.append([img1.split("/")[-1]])
            self.image_list.append((img1, img2))
        if split == "training":
            self.flow_list = sorted(
                glob.glob(osp.join(root, "flow_occ/*_10.png")))


class KITTI12(FlowDataset):
    """KITTI-2012 (`datasets.py:221-238`; images in colored_0/)."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/KITTI12"):
        super().__init__(aug_params, sparse=True)
        if split == "testing":
            self.is_test = True
        root = osp.join(root, split)
        images1 = sorted(glob.glob(osp.join(root, "colored_0/*_10.png")))
        images2 = sorted(glob.glob(osp.join(root, "colored_0/*_11.png")))
        for img1, img2 in zip(images1, images2):
            self.extra_info.append([img1.split("/")[-1]])
            self.image_list.append((img1, img2))
        if split == "training":
            self.flow_list = sorted(
                glob.glob(osp.join(root, "flow_occ/*_10.png")))


class FineTuneKITTI15(FlowDataset):
    """The 160-train / 40-validation split of KITTI-2015's training set
    (`datasets.py:201-228`)."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/KITTI"):
        super().__init__(aug_params, sparse=True)
        base = osp.join(root, "training")
        images1 = sorted(glob.glob(osp.join(base, "image_2/*_10.png")))
        images2 = sorted(glob.glob(osp.join(base, "image_2/*_11.png")))
        flows = sorted(glob.glob(osp.join(base, "flow_occ/*_10.png")))
        sl = slice(0, 160) if split == "training" else slice(160, 200)
        for img1, img2, flow in zip(images1[sl], images2[sl], flows[sl]):
            self.extra_info.append([img1.split("/")[-1]])
            self.image_list.append((img1, img2))
            self.flow_list.append(flow)


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
