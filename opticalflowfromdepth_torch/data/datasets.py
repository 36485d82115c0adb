"""Datasets (port of ``opticalflowfromdepth_tpu/data/datasets.py``): the
benchmark flow datasets the validators and submissions read, and the
synthesized-shard reader the trainers read.

Host-side numpy, one sample schema (a dict of arrays):

    image1 [H, W, 3] f32 (0..255)   image2 [H, W, 3] f32
    flow   [H, W, 2] f32            valid  [H, W] f32
    label  [4] f32 one-hot          (shards) back_flow, depth1, depth2

Benchmark datasets: MpiSintel (with occlusion maps), FlyingChairs,
FlyingThings3D, KITTI, KITTI12, FineTuneKITTI15 (160/40 split) and HD1K
(the reference's ``seq_ix += -1`` loop fixed, as in the JAX package). The
validators and submissions read them without augmentation
(``aug_params=None``); the training stages with the cv2-free augmentors of
``data/augmentor.py`` (``aug_params``).

The shards are the synthesis writer's npz files (``{stem}_g{g}_a{a}.npz``
with the keys ``img0_1 img1_1 depth0_1 depth1_1 flow_1 back_flow_1``, the
same with ``_2``, and ``label``; ``{stem}_group.npz`` with ``group``),
decoded by the port's npz codec (``data/native_io.py``), as the JAX
readers decode through theirs. Every reader draws from its generators in
the JAX reader's order, so the same generators give the same samples.

As in the JAX package, an augmentor built from ``aug_params`` draws from
an unseeded ``np.random.default_rng()``: ``seed`` seeds the shard readers'
own draws (side, flips, crop), not the augmentation, so augmented samples
differ from run to run. Set ``dataset.augmentor.rng`` to reproduce them.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import frame_io, native_io
from .augmentor import FlowAugmentor, SparseFlowAugmentor

NUM_CLASSES = 4  # {none, flip, rotate, shear}; `dataloader.py:11`
FLOW_Q = 64.0    # int16 shard flows are fixed point, 1/64 px


def one_hot(label: int, n: int = NUM_CLASSES) -> np.ndarray:
    v = np.zeros((n,), np.float32)
    v[label] = 1.0
    return v


class FlowDataset:
    """Base reader (`adjusted_RAFT/core/datasets.py:18-100`).
    ``aug_params`` builds the dense or (``sparse``) sparse augmentor;
    ``seed`` is taken for the JAX signature and, as there, seeds
    nothing."""

    def __init__(self, aug_params: Optional[dict] = None,
                 sparse: bool = False, seed: Optional[int] = None):
        del seed
        self.sparse = sparse
        self.augmentor = None
        if aug_params is not None:
            cls = SparseFlowAugmentor if sparse else FlowAugmentor
            self.augmentor = cls(**aug_params)
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

        valid = None
        if self.sparse:
            flow, valid = frame_io.read_flow_kitti(self.flow_list[index])
        else:
            flow = frame_io.read_gen(self.flow_list[index])
        flow = np.asarray(flow, np.float32)

        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(
                    img1, img2, flow, valid)
            else:
                img1, img2, flow, _, _, _ = self.augmentor(img1, img2, flow)

        if valid is None:
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


class HD1K(FlowDataset):
    """`datasets.py:240-257`, sequences read forward (the reference's
    `seq_ix += -1` at `:247` never ends; the JAX package fixed it so)."""

    def __init__(self, aug_params=None, root="datasets/HD1k"):
        super().__init__(aug_params, sparse=True)
        seq_ix = 0
        while True:
            flows = sorted(glob.glob(
                osp.join(root, "hd1k_flow_gt",
                         f"flow_occ/{seq_ix:06d}_*.png")))
            images = sorted(glob.glob(
                osp.join(root, "hd1k_input", f"image_2/{seq_ix:06d}_*.png")))
            if len(flows) == 0:
                break
            for i in range(len(flows) - 1):
                self.flow_list.append(flows[i])
                self.image_list.append((images[i], images[i + 1]))
            seq_ix += 1


def dequantize_flow(arr: np.ndarray) -> np.ndarray:
    """Shard flow -> px: int16 fixed point (1/64 px) or float passthrough
    (a copy of ``synth/writer.py:dequantize_flow``)."""
    if arr.dtype == np.int16:
        return arr.astype(np.float32) / FLOW_Q
    return arr.astype(np.float32)


# a shard the codec cannot decode (IOError) or without the key read
_UNREADABLE = (OSError, KeyError)


def _flip_crop(rng, h_flip_prob, v_flip_prob, crop_size, img1, img2, flow,
               back_flow, depth1, depth2):
    """The plain path of both shard readers (`dataloader.py:129-142`):
    flips, then a random crop, drawn in this order."""
    if rng.random() < h_flip_prob:
        img1, img2 = img1[:, ::-1], img2[:, ::-1]
        flow = flow[:, ::-1] * [-1.0, 1.0]
        back_flow = back_flow[:, ::-1] * [-1.0, 1.0]
        depth1, depth2 = depth1[:, ::-1], depth2[:, ::-1]
    if rng.random() < v_flip_prob:
        img1, img2 = img1[::-1], img2[::-1]
        flow = flow[::-1] * [1.0, -1.0]
        back_flow = back_flow[::-1] * [1.0, -1.0]
        depth1, depth2 = depth1[::-1], depth2[::-1]
    if crop_size is not None:
        ch, cw = crop_size
        h, w = img1.shape[:2]
        y0 = int(rng.integers(0, max(h - ch, 0) + 1))
        x0 = int(rng.integers(0, max(w - cw, 0) + 1))
        sel = (slice(y0, y0 + ch), slice(x0, x0 + cw))
        img1, img2 = img1[sel], img2[sel]
        flow, back_flow = flow[sel], back_flow[sel]
        depth1, depth2 = depth1[sel], depth2[sel]
    return img1, img2, flow, back_flow, depth1, depth2


class AugmentedShards:
    """Reader for the synthesis writer's npz shards.

    Index selection mirrors `dataloader.py:235-268`: ``__len__`` is
    ``epochs x len(files)``; each sample takes a random side, then either
    the plain flips (`dataloader.py:129-142`) and a random crop, or with
    ``re_augment`` the dense ``FlowAugmentor`` over the images, both flows
    and both depths (`core/datasets.py:269-289`; its crop is
    ``aug_params["crop_size"]``, by default ``crop_size``). valid is
    ``|flow| < 1000`` on both components and ``depth1 != 100``
    (`:291-297`)."""

    def __init__(self, root: str, crop_size: Optional[Tuple[int, int]] = None,
                 re_augment: bool = False, aug_params: Optional[dict] = None,
                 epochs: int = 2, seed: Optional[int] = None,
                 h_flip_prob: float = 0.5, v_flip_prob: float = 0.1):
        self.root = root
        self.files = sorted(glob.glob(osp.join(root, "*_g*_a*.npz")))
        if not self.files:
            raise FileNotFoundError(f"no synthesized shards under {root}")
        self.crop_size = crop_size
        self.epochs = epochs
        self.rng = np.random.default_rng(seed)
        self.h_flip_prob = h_flip_prob
        self.v_flip_prob = v_flip_prob
        self.augmentor = None
        if re_augment:
            params = dict(aug_params or {})
            params.setdefault("crop_size", crop_size)
            self.augmentor = FlowAugmentor(**params)

    def __len__(self) -> int:
        return self.epochs * len(self.files)

    def _load(self, index: int) -> Dict[str, np.ndarray]:
        """Corrupt files fall through to the next index
        (`dataloader.py:81-91`)."""
        for off in range(len(self.files)):
            path = self.files[(index + off) % len(self.files)]
            try:
                return native_io.load_npz(path)
            except _UNREADABLE:
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

        if self.augmentor is not None:
            img1, img2, flow, back_flow, depth1, depth2 = self.augmentor(
                img1, img2, flow, back_flow, depth1, depth2)
        else:
            img1, img2, flow, back_flow, depth1, depth2 = _flip_crop(
                self.rng, self.h_flip_prob, self.v_flip_prob, self.crop_size,
                img1, img2, flow, back_flow, depth1, depth2)

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


class DepthToFlowShards:
    """Training directly on the un-augmented group pairs of the
    ``{stem}_group.npz`` shards (the reference's `dataloader.py:160-232`,
    which nothing consumes and whose channels target an older layout; the
    JAX package's working equivalent).

    Each group tensor is the 44-channel layout of `preprocess.py:437-447`
    (``synth.pipeline.group_tensor``). A random one of three supervised
    pairs, each with its own channels (flow02 pairs with img2', the image
    it was composed for, `preprocess.py:430`):

        0: (img0 0:3,  d0 3:4,  img1  4:7,   d1  7:8,  flow01 24:26, back 26:28)
        1: (img1 4:7,  d1 7:8,  img2  8:11,  d2 11:12, flow12 28:30, back 30:32)
        2: (img0 0:3,  d0 3:4,  img2' 16:19, d2' 19:20, flow02 32:34, back 34:36)

    The label is always class 0 (`dataloader.py:229-231`); flips and the
    crop are the augmented reader's plain path."""

    _PAIRS = (
        ((0, 3), (3, 4), (4, 7), (7, 8), (24, 26), (26, 28)),
        ((4, 7), (7, 8), (8, 11), (11, 12), (28, 30), (30, 32)),
        ((0, 3), (3, 4), (16, 19), (19, 20), (32, 34), (34, 36)),
    )

    def __init__(self, root: str, crop_size: Optional[Tuple[int, int]] = None,
                 epochs: int = 2, seed: Optional[int] = None,
                 h_flip_prob: float = 0.5, v_flip_prob: float = 0.1):
        self.root = root
        self.files = sorted(glob.glob(osp.join(root, "*_group.npz")))
        if not self.files:
            raise FileNotFoundError(f"no group shards under {root}")
        self.crop_size = crop_size
        self.epochs = epochs
        self.rng = np.random.default_rng(seed)
        self.h_flip_prob = h_flip_prob
        self.v_flip_prob = v_flip_prob

    def __len__(self) -> int:
        return self.epochs * len(self.files)

    def _load(self, index: int) -> np.ndarray:
        """Corrupt files fall through to the next (`dataloader.py:180-184`)."""
        for off in range(len(self.files)):
            path = self.files[(index + off) % len(self.files)]
            try:
                return native_io.load_npz(path)["group"]
            except _UNREADABLE:
                continue
        raise RuntimeError(f"all group shards unreadable under {self.root}")

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        group = self._load(index % len(self.files))  # [44, H, W] f16
        (i0, d0, i1, d1, fl, bk) = self._PAIRS[int(self.rng.integers(0, 3))]

        def chw(lo, hi):  # [C, H, W] f16 -> [H, W, C] f32
            return np.moveaxis(group[lo:hi], 0, -1).astype(np.float32)

        img1, img2, flow, back_flow, depth1, depth2 = _flip_crop(
            self.rng, self.h_flip_prob, self.v_flip_prob, self.crop_size,
            chw(*i0), chw(*i1), chw(*fl), chw(*bk), chw(*d0)[..., 0],
            chw(*d1)[..., 0])
        valid = ((np.abs(flow[..., 0]) < 1000) &
                 (np.abs(flow[..., 1]) < 1000) &
                 (depth1 != 100.0))
        return {
            "image1": np.ascontiguousarray(img1, np.float32),
            "image2": np.ascontiguousarray(img2, np.float32),
            "flow": np.ascontiguousarray(flow, np.float32),
            "back_flow": np.ascontiguousarray(back_flow, np.float32),
            "depth1": np.ascontiguousarray(depth1, np.float32),
            "depth2": np.ascontiguousarray(depth2, np.float32),
            "valid": np.ascontiguousarray(valid, np.float32),
            "label": one_hot(0),  # always un-augmented (`dataloader.py:229`)
        }


class ConcatDataset:
    """Concatenation (and, by repeating an entry, integer multiplication)
    of datasets, as the reference's stages use torch's `ConcatDataset`
    (`datasets.py:306-358`)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.sizes = [len(d) for d in self.datasets]
        self.total = sum(self.sizes)

    def __len__(self):
        return self.total

    def __getitem__(self, index):
        index = index % self.total
        for d, n in zip(self.datasets, self.sizes):
            if index < n:
                return d[index]
            index -= n
        raise IndexError


def fetch_train_dataset(stage: str, crop_size: Tuple[int, int],
                        shards_root: Optional[Dict[str, str]] = None,
                        data_root: str = "datasets",
                        eraser_aug_prob: float = 0.5,
                        seed: Optional[int] = None):
    """Stage recipes (`adjusted_RAFT/core/datasets.py:306-352`,
    `adjusted_gmflow/data/datasets.py:373-441`).

    ``shards_root`` maps ``{"redweb": dir, "diml": dir}`` for the
    synthesized stages; ``mixed`` concatenates both (`datasets.py:
    347-352`); ``depthtoflow`` reads the group shards of every dir given.
    """
    aug = dict(crop_size=crop_size, eraser_aug_prob=eraser_aug_prob)

    if stage == "chairs":
        return FlyingChairs(
            dict(aug, min_scale=-0.1, max_scale=1.0, do_flip=True),
            split="training", root=osp.join(
                data_root, "FlyingChairs_release/data"))
    if stage == "things":
        clean = FlyingThings3D(
            dict(aug, min_scale=-0.4, max_scale=0.8, do_flip=True),
            root=osp.join(data_root, "FlyingThings3D"),
            dstype="frames_cleanpass")
        final = FlyingThings3D(
            dict(aug, min_scale=-0.4, max_scale=0.8, do_flip=True),
            root=osp.join(data_root, "FlyingThings3D"),
            dstype="frames_finalpass")
        return ConcatDataset([clean, final])
    if stage == "sintel":
        base = dict(aug, min_scale=-0.2, max_scale=0.6, do_flip=True)
        things = FlyingThings3D(base, root=osp.join(
            data_root, "FlyingThings3D"), dstype="frames_cleanpass")
        sintel_clean = MpiSintel(base, split="training", dstype="clean",
                                 root=osp.join(data_root, "Sintel"))
        sintel_final = MpiSintel(base, split="training", dstype="final",
                                 root=osp.join(data_root, "Sintel"))
        kitti = KITTI(dict(aug, min_scale=-0.3, max_scale=0.5, do_flip=True),
                      root=osp.join(data_root, "KITTI"))
        hd1k = HD1K(dict(aug, min_scale=-0.5, max_scale=0.2, do_flip=True),
                    root=osp.join(data_root, "HD1k"))
        # 100*sintel_clean + 100*sintel_final + 200*kitti + 5*hd1k + things
        return ConcatDataset(
            [sintel_clean] * 100 + [sintel_final] * 100 + [kitti] * 200 +
            [hd1k] * 5 + [things])
    if stage in ("kitti", "finetunekitti15"):
        params = dict(aug, min_scale=-0.2, max_scale=0.4, do_flip=False)
        if stage == "kitti":
            return KITTI(params, split="training",
                         root=osp.join(data_root, "KITTI"))
        return FineTuneKITTI15(params, split="training",
                               root=osp.join(data_root, "KITTI"))
    if stage in ("augmentedredweb", "augmenteddiml", "mixed"):
        if not shards_root:
            raise ValueError(f"stage {stage} needs shards_root dirs")
        keys = {"augmentedredweb": ["redweb"], "augmenteddiml": ["diml"],
                "mixed": ["redweb", "diml"]}[stage]
        parts = [AugmentedShards(
            shards_root[k], crop_size=crop_size, re_augment=True,
            aug_params=dict(aug, min_scale=-0.2, max_scale=0.5,
                            do_flip=True),
            seed=seed) for k in keys]
        return parts[0] if len(parts) == 1 else ConcatDataset(parts)
    if stage == "depthtoflow":
        # un-augmented group pairs, label 0 (D3, `dataloader.py:160-232`)
        if not shards_root:
            raise ValueError("stage depthtoflow needs shards_root dirs")
        parts = [DepthToFlowShards(root, crop_size=crop_size, seed=seed)
                 for root in shards_root.values()]
        return parts[0] if len(parts) == 1 else ConcatDataset(parts)
    raise ValueError(f"unknown stage: {stage}")
