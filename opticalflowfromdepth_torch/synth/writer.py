"""Shard writer: a synthesized sample -> self-contained npz files (port of
``opticalflowfromdepth_tpu/synth/writer.py``, its packed path).

Per (group g, augment a) one file ``{stem}_g{g}_a{a}.npz`` with both
supervised sides:

    img0_1/img1_1       [H, W, 3] uint8   side 1 = augmented img0
    depth0_1/depth1_1   [H, W] f16
    flow_1/back_flow_1  [H, W, 2] f16 (or int16 at 1/64 px, ``flow_int16``)
    img0_2/... (side 2 = augmented img1), label (the augment type)

and one ``{stem}_group.npz`` with the 44-channel group tensor
(`preprocess.py:437-447`): 61 files an image. The port's
``data.datasets.AugmentedShards`` reads them.

:class:`ShardWriter` writes through the port's npz codec
(``data/native_io.py:ShardEncoder``): each distinct array of an image is
deflated (u8) or stored (f16) once on C++ threads, however many files
hold it. With ``use_native=False`` a Python pool writes the files with
``zipfile`` instead, one job a file.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
import zipfile
from typing import Dict, List

import numpy as np

FLOW_Q = 64.0   # int16 flows are fixed point, 1/64 px (the KITTI encoding)


def _hwc8(img_chw: np.ndarray) -> np.ndarray:
    return np.clip(np.moveaxis(img_chw, 0, -1), 0, 255).astype(np.uint8)


def _hw16(x_chw: np.ndarray) -> np.ndarray:
    arr = np.moveaxis(x_chw, 0, -1).astype(np.float16)
    return arr[..., 0] if arr.shape[-1] == 1 else arr


def write_group(out_dir: str, stem: str, group_44: np.ndarray) -> str:
    path = os.path.join(out_dir, f"{stem}_group.npz")
    np.savez_compressed(path, group=group_44.astype(np.float16))
    return path


def write_augmented(out_dir: str, stem: str, g: int, a: int,
                    pair_12: np.ndarray, set1_8: np.ndarray,
                    set2_8: np.ndarray, aug_type: int) -> str:
    """One (group, augment) file from f32 tensors: ``pair_12`` the stacked
    pair [12, H, W], ``set1_8`` / ``set2_8`` its ``AugmentedSets``."""
    path = os.path.join(out_dir, f"{stem}_g{g}_a{a}.npz")
    np.savez_compressed(
        path,
        # side 1: image1 is the augmented img0, image2 the pair's img1
        img0_1=_hwc8(set1_8[0:3]), depth0_1=_hw16(set1_8[3:4]),
        img1_1=_hwc8(pair_12[4:7]), depth1_1=_hw16(pair_12[7:8]),
        flow_1=_hw16(set1_8[4:6]), back_flow_1=_hw16(set1_8[6:8]),
        # side 2: image1 is the pair's img0, image2 the augmented img1
        img0_2=_hwc8(pair_12[0:3]), depth0_2=_hw16(pair_12[3:4]),
        img1_2=_hwc8(set2_8[4:7]), depth1_2=_hw16(set2_8[7:8]),
        flow_2=_hw16(set2_8[0:2]), back_flow_2=_hw16(set2_8[2:4]),
        label=np.int32(aug_type))
    return path


def write_sample(out_dir: str, stem: str, sample: Dict[str, np.ndarray]
                 ) -> int:
    """Write what ``synth.pipeline.synthesize_sample`` produced (f32, on
    the host): 1 group file + 5 x 12 augmented; returns 61."""
    os.makedirs(out_dir, exist_ok=True)
    write_group(out_dir, stem, np.asarray(sample["group"]))
    pairs = np.asarray(sample["pairs"])          # [5, 12, H, W]
    set1 = np.asarray(sample["aug_set1"])        # [5, 12, 8, H, W]
    set2 = np.asarray(sample["aug_set2"])
    aug_types = np.asarray(sample["aug_types"])  # [12]
    for g in range(pairs.shape[0]):
        for a in range(set1.shape[1]):
            write_augmented(out_dir, stem, g, a, pairs[g], set1[g, a],
                            set2[g, a], int(aug_types[a]))
    return 1 + pairs.shape[0] * set1.shape[1]


def _savez_fast(path: str, level: int = 1, store_floats: bool = False,
                **arrays) -> None:
    """``np.savez_compressed`` at a chosen deflate level (numpy's is 6;
    level 1 is several times faster for a few percent). ``store_floats``
    stores the f16 and int16 arrays uncompressed: their bits barely
    deflate."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=level) as zf:
        for name, arr in arrays.items():
            arr = np.asanyarray(arr)
            zf.compression = zipfile.ZIP_STORED \
                if store_floats and arr.dtype != np.uint8 \
                else zipfile.ZIP_DEFLATED
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)


def _q16(flow_hwc: np.ndarray) -> np.ndarray:
    """Flow -> int16 fixed point (1/64 px, +-511.98 px); warns where it
    clips."""
    f32 = flow_hwc.astype(np.float32)
    peak = float(np.max(np.abs(f32), initial=0.0))
    if peak * FLOW_Q > 32767:
        warnings.warn(
            f"--flow_int16: |flow| up to {peak:.1f} px exceeds the ±512 px "
            "int16 range; values will be clipped (use f16 shards for "
            "extreme-motion synthesis)", RuntimeWarning, stacklevel=2)
    return np.clip(np.round(f32 * FLOW_Q), -32768, 32767).astype(np.int16)


def sample_plan(out_dir: str, stem: str, sample: Dict[str, np.ndarray],
                flow_int16: bool = False):
    """The 61 files of one packed sample (``synth.pipeline.
    synthesize_sample_packed`` on the host) as (path, [(key, array)]).
    A parent's image, depth and flow appear in ~12 files as the same
    array objects."""
    from .pipeline import GEO_POSITIONS, PHO_POSITIONS

    group = np.asarray(sample["group_f16"])
    yield os.path.join(out_dir, f"{stem}_group.npz"), [("group", group)]

    pimg = np.asarray(sample["pairs_img_u8"])    # [5, 2, 3, H, W]
    pflt = np.asarray(sample["pairs_flt_f16"])   # [5, 6, H, W]
    gimg = np.asarray(sample["geo_img_u8"])      # [5, G, 2, 3, H, W]
    gflt = np.asarray(sample["geo_flt_f16"])     # [5, G, 2, 5, H, W]
    phimg = np.asarray(sample["pho_img_u8"])     # [5, P, 2, 3, H, W]
    aug_types = np.asarray(sample["aug_types"])

    def hwc(img_chw):  # u8 [3, H, W] -> [H, W, 3]
        return np.moveaxis(img_chw, 0, -1)

    def hw(x_chw):     # f16 [C, H, W] -> [H, W, C] or [H, W]
        arr = np.moveaxis(x_chw, 0, -1)
        return arr[..., 0] if arr.shape[-1] == 1 else arr

    enc = _q16 if flow_int16 else (lambda a: a)

    for g in range(pimg.shape[0]):
        img0, img1 = hwc(pimg[g, 0]), hwc(pimg[g, 1])
        depth0, depth1 = hw(pflt[g, 0:1]), hw(pflt[g, 1:2])
        flow, back = enc(hw(pflt[g, 2:4])), enc(hw(pflt[g, 4:6]))
        for slot, a in enumerate(GEO_POSITIONS):
            f1 = gflt[g, slot, 0]  # [5, H, W]: depth, flow(2), back(2)
            f2 = gflt[g, slot, 1]
            yield os.path.join(out_dir, f"{stem}_g{g}_a{a}.npz"), [
                ("img0_1", hwc(gimg[g, slot, 0])),
                ("depth0_1", hw(f1[0:1])), ("img1_1", img1),
                ("depth1_1", depth1), ("flow_1", enc(hw(f1[1:3]))),
                ("back_flow_1", enc(hw(f1[3:5]))),
                ("img0_2", img0), ("depth0_2", depth0),
                ("img1_2", hwc(gimg[g, slot, 1])),
                ("depth1_2", hw(f2[0:1])), ("flow_2", enc(hw(f2[1:3]))),
                ("back_flow_2", enc(hw(f2[3:5]))),
                ("label", np.int32(aug_types[a]))]
        for slot, a in enumerate(PHO_POSITIONS):
            yield os.path.join(out_dir, f"{stem}_g{g}_a{a}.npz"), [
                ("img0_1", hwc(phimg[g, slot, 0])),
                ("depth0_1", depth0), ("img1_1", img1),
                ("depth1_1", depth1), ("flow_1", flow),
                ("back_flow_1", back),
                ("img0_2", img0), ("depth0_2", depth0),
                ("img1_2", hwc(phimg[g, slot, 1])),
                ("depth1_2", depth1), ("flow_2", flow),
                ("back_flow_2", back),
                ("label", np.int32(aug_types[a]))]


def write_sample_packed(out_dir: str, stem: str,
                        sample: Dict[str, np.ndarray], level: int = 1,
                        flow_int16: bool = False) -> int:
    """Write one packed sample's 61 files on this thread; returns the
    number written. Geometric augmentations carry their own 8 channels,
    photometric ones reuse the pair's depth and flow."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for path, entries in sample_plan(out_dir, stem, sample, flow_int16):
        _savez_fast(path, level, **dict(entries))
        n += 1
    return n


class ShardWriter:
    """Writes packed samples with ``workers`` threads. ``submit`` queues an
    image's 61 files; ``drain`` waits for every file and returns the count
    of files (a second ``drain`` returns it again; ``submit`` after it
    raises). ``write_s``: the seconds the threads spent writing, summed
    over them; ``wait_s``: the seconds the caller waited for them (in
    ``submit`` and ``drain``).

    ``use_native`` (the default): one :class:`~..data.native_io.
    ShardEncoder` (deflate level 1; f16 and f32 stored unless
    ``store_floats`` is off), which reads the host arrays in place until
    it is drained. ``submit`` drains it first when the image would make
    more than ``BACKLOG`` pending, so at most that many images' arrays stay
    referenced (the JAX writer's rule).
    ``use_native=False``: a Python pool of ``zipfile`` jobs, one a file;
    ``submit`` returns once at most ``BACKLOG`` earlier images are still
    being written."""

    BACKLOG = 2      # images whose files may still be in flight

    def __init__(self, out_dir: str, workers: int = 4,
                 flow_int16: bool = False, store_floats: bool = True,
                 use_native: bool = True):
        self.out_dir = out_dir
        self.flow_int16 = flow_int16
        self.store_floats = store_floats
        self.enc = None
        self.pool = None
        if use_native:
            from ..data.native_io import ShardEncoder
            self.enc = ShardEncoder(threads=workers, level=1,
                                    store_floats=store_floats)
        else:
            from concurrent.futures import ThreadPoolExecutor
            self.pool = ThreadPoolExecutor(max_workers=workers)
        self.images: List[list] = []     # each pending image's jobs
        self.pending = 0                 # images queued in the encoder
        self.files = 0
        self.wait_s = 0.0
        self._py_write_s = 0.0
        self._lock = threading.Lock()
        self._drained = False

    @property
    def write_s(self) -> float:
        return self.enc.busy_s if self.enc is not None else self._py_write_s

    def _job(self, path, entries) -> None:
        t = time.perf_counter()
        _savez_fast(path, 1, self.store_floats, **dict(entries))
        with self._lock:
            self._py_write_s += time.perf_counter() - t

    def _wait(self, keep: int) -> None:
        t = time.perf_counter()
        if self.enc is not None:
            if self.pending > keep:
                self.enc.drain()
                self.pending = 0
        else:
            while len(self.images) > keep:
                for f in self.images.pop(0):
                    f.result()
        self.wait_s += time.perf_counter() - t

    def submit(self, stem: str, sample: Dict[str, np.ndarray]) -> None:
        if self._drained:
            raise RuntimeError("ShardWriter.submit after drain")
        self._wait(self.BACKLOG - 1 if self.enc is not None
                   else self.BACKLOG)
        os.makedirs(self.out_dir, exist_ok=True)
        plan = sample_plan(self.out_dir, stem, sample, self.flow_int16)
        if self.enc is not None:
            for path, entries in plan:
                self.enc.file(path, entries)
                self.files += 1
            self.pending += 1
            return
        jobs = [self.pool.submit(self._job, path, entries)
                for path, entries in plan]
        self.files += len(jobs)
        self.images.append(jobs)

    def drain(self) -> int:
        if not self._drained:
            self._drained = True
            try:
                self._wait(0)
            finally:
                if self.enc is not None:
                    self.enc.close()
                else:
                    self.pool.shutdown()
        return self.files
