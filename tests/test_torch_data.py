"""The port's shard reader and loader on the CPU against the JAX package's.

The same seeded npz shards (the synthesis writer's keys, f16 and int16
flows) are read by both ``AugmentedShards`` with the same seed: the draws
(side, flips, crop) come in the same order, so the samples must be equal.
``Loader`` with one worker thread (several share the dataset's generator
in a varying order) must give equal batches. ``to_device`` gives the
step's NCHW tensors.

Re-augmentation and every stage of ``fetch_train_dataset`` (on fake
benchmark trees and on shards the port's synthesis wrote) against the JAX
package's, sample for sample: both sides' augmentors get generators of the
same seed (an augmentor built from ``aug_params`` is unseeded in both
packages). Images must be equal. Flows and depths within 1e-5 of the
largest value (measured: 3.6e-6): the JAX side resizes them through cv2
with IPP, which adds in another order (``tests/test_torch_augmentor.py``).
``valid`` may differ where such a rounding moves a depth onto or off
exactly 100: at most ``VALID_BUDGET`` of the pixels (measured: 0).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from opticalflowfromdepth_tpu.data import datasets as jds
from opticalflowfromdepth_tpu.data import loader as jloader
from opticalflowfromdepth_tpu.synth.writer import FLOW_Q, write_augmented
from opticalflowfromdepth_torch.data import datasets as tds
from opticalflowfromdepth_torch.data import frame_io as tloader_io
from opticalflowfromdepth_torch.data import loader as tloader

torch.set_num_threads(2)


def _write_shards(root, n=4, h=40, w=56, seed=0, int16=False):
    rng = np.random.default_rng(seed)
    for i in range(n):
        pair = rng.uniform(0, 255, (12, h, w)).astype(np.float32)
        pair[8:12] = rng.normal(0, 5, (4, h, w))
        pair[[3, 7]] = rng.uniform(20, 90, (2, h, w))
        sets = [rng.uniform(0, 255, (8, h, w)).astype(np.float32)
                for _ in range(2)]
        sets[0][3] = rng.uniform(20, 90, (h, w))
        pair[3, :3, :3] = sets[0][3, :3, :3] = 100.0   # depth 100: invalid
        sets[0][4:8] = rng.normal(0, 5, (4, h, w))
        sets[1][0:4] = rng.normal(0, 5, (4, h, w))
        path = write_augmented(str(root), f"img{i}", i % 5, i, pair, *sets,
                               aug_type=(i * 3) % 8)
        if int16:          # the --flow_int16 shards: 1/64 px fixed point
            with np.load(path) as z:
                data = {k: z[k] for k in z.files}
            for k in data:
                if "flow" in k:
                    data[k] = np.round(data[k].astype(np.float32) * FLOW_Q
                                       ).astype(np.int16)
            np.savez_compressed(path, **data)


@pytest.mark.parametrize("int16", [False, True])
@pytest.mark.parametrize("crop", [None, (32, 48)])
def test_augmented_shards_match_jax(tmp_path, int16, crop):
    _write_shards(tmp_path, int16=int16)
    ref = jds.AugmentedShards(str(tmp_path), crop_size=crop, seed=3)
    got = tds.AugmentedShards(str(tmp_path), crop_size=crop, seed=3)
    assert len(got) == len(ref) == 8
    for i in range(len(got)):
        r, g = ref[i], got[i]
        assert set(r) == set(g)
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=f"{i} {k}")
    if crop is None:
        assert all(got[i]["valid"].sum() == 40 * 56 - 9 for i in range(8))


def test_one_hot_and_dequantize_match_jax():
    from opticalflowfromdepth_tpu.synth.writer import dequantize_flow
    for lab in range(4):
        np.testing.assert_array_equal(tds.one_hot(lab), jds.one_hot(lab))
    a = np.arange(-40, 40, dtype=np.int16).reshape(4, 10, 2)
    np.testing.assert_array_equal(tds.dequantize_flow(a), dequantize_flow(a))
    f = a.astype(np.float16)
    np.testing.assert_array_equal(tds.dequantize_flow(f), dequantize_flow(f))


VALID_BUDGET = 0.005     # share of pixels whose valid may differ


def _assert_sample_close(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        if k in ("image1", "image2", "label"):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        elif k == "valid":
            assert np.mean(g != w) <= VALID_BUDGET, (what, np.mean(g != w))
        else:
            tol = 1e-5 * max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                       err_msg=f"{what} {k}")


def _parts(ds):
    """The distinct datasets of a stage, each with the index of its first
    sample."""
    if not isinstance(ds, (jds.ConcatDataset, tds.ConcatDataset)):
        return [(ds, 0)]
    seen, out, start = set(), [], 0
    for d, n in zip(ds.datasets, ds.sizes):
        if id(d) not in seen:
            seen.add(id(d))
            out.append((d, start))
        start += n
    return out


def _seed_augmentors(ds, seed):
    for k, (d, _) in enumerate(_parts(ds)):
        if getattr(d, "augmentor", None) is not None:
            d.augmentor.rng = np.random.default_rng(seed + k)


@pytest.mark.parametrize("int16", [False, True])
def test_re_augment_matches_jax(tmp_path, int16):
    _write_shards(tmp_path, h=60, w=80, int16=int16)
    aug = dict(crop_size=(32, 48), min_scale=-0.2, max_scale=0.5,
               do_flip=True)
    ref = jds.AugmentedShards(str(tmp_path), re_augment=True,
                              aug_params=aug, seed=3)
    got = tds.AugmentedShards(str(tmp_path), re_augment=True,
                              aug_params=aug, seed=3)
    for k, ds in enumerate((ref, got)):
        ds.augmentor.rng = np.random.default_rng(11)
    for i in range(len(got)):
        r, g = ref[i], got[i]
        assert g["image1"].shape == (32, 48, 3)
        _assert_sample_close(g, r, f"sample {i}")


def _image(path, rng, hw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(
        path)


def _pfm(path, flow):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = np.concatenate([flow, np.zeros_like(flow[..., :1])], -1)
    with open(path, "wb") as f:
        f.write(f"PF\n{data.shape[1]} {data.shape[0]}\n-1.0\n".encode())
        np.flipud(data).astype("<f4").tofile(f)


def _kitti(path, rng, hw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    flow = np.round(rng.normal(0, 6, hw + (2,)) * 64) / 64
    tloader_io.write_flow_kitti(path, flow.astype(np.float32),
                                rng.random(hw) < 0.5)


@pytest.fixture(scope="module")
def train_trees(tmp_path_factory):
    """Chairs, Things (TRAIN), Sintel, KITTI and HD1K trees in the
    reference's layout, written by the port's writers."""
    root = tmp_path_factory.mktemp("train_trees")
    rng = np.random.default_rng(21)
    hw, khw = (48, 64), (44, 72)
    chairs = root / "FlyingChairs_release/data"
    for i in range(3):
        for k in (1, 2):
            _image(str(chairs / f"{i + 1:05d}_img{k}.ppm"), rng, hw)
        tloader_io.write_flo(str(chairs / f"{i + 1:05d}_flow.flo"),
                             rng.normal(0, 5, hw + (2,)).astype(np.float32))
    things = root / "FlyingThings3D"
    for dstype in ("frames_cleanpass", "frames_finalpass"):
        for i in range(3):
            _image(str(things / dstype / f"TRAIN/A/0000/left/{i:04d}.png"),
                   rng, hw)
    for direction in ("into_future", "into_past"):
        for i in range(3):
            flow = rng.normal(0, 8, hw + (2,)).astype(np.float32)
            if i == 1:
                flow[0, 0, 0] = 1500.0          # invalid: |flow| >= 1000
            _pfm(str(things / f"optical_flow/TRAIN/A/0000/{direction}/left/"
                              f"OpticalFlow_{i:04d}_L.pfm"), flow)
    sintel = root / "Sintel/training"
    for dstype in ("clean", "final"):
        for i in range(3):
            _image(str(sintel / dstype / f"alley_1/frame_{i + 1:04d}.png"),
                   rng, hw)
    for i in range(2):
        os.makedirs(sintel / "flow/alley_1", exist_ok=True)
        tloader_io.write_flo(str(sintel / f"flow/alley_1/frame_{i + 1:04d}"
                                          f".flo"),
                             rng.normal(0, 5, hw + (2,)).astype(np.float32))
    kitti = root / "KITTI/training"
    for i in range(2):
        for t in (10, 11):
            _image(str(kitti / f"image_2/{i:06d}_{t}.png"), rng, khw)
        _kitti(str(kitti / f"flow_occ/{i:06d}_10.png"), rng, khw)
    hd1k = root / "HD1k"
    for seq in range(2):
        for i in range(3):
            _image(str(hd1k / f"hd1k_input/image_2/{seq:06d}_{i:04d}.png"),
                   rng, khw)
            _kitti(str(hd1k / f"hd1k_flow_gt/flow_occ/{seq:06d}_{i:04d}"
                              f".png"), rng, khw)
    return str(root)


@pytest.fixture(scope="module")
def port_shards(tmp_path_factory):
    """Shards the port's synthesis wrote (64x96; ReDWeb-like and DIML-like
    procedural images, two each)."""
    from opticalflowfromdepth_torch.tools.convergence_smoke import \
        synthesize_shards
    roots = {}
    for k, seed in (("redweb", 0), ("diml", 7)):
        roots[k] = str(tmp_path_factory.mktemp(k))
        assert synthesize_shards(roots[k], 2, 64, 96, seed=seed,
                                 device="cpu") == 122
    return roots


STAGES = ("chairs", "things", "sintel", "kitti", "finetunekitti15",
          "augmentedredweb", "augmenteddiml", "mixed", "depthtoflow")


@pytest.mark.parametrize("stage", STAGES)
def test_fetch_train_dataset_matches_jax(train_trees, port_shards, stage):
    kw = dict(shards_root=port_shards, data_root=train_trees, seed=5)
    crop = (32, 48)
    want = jds.fetch_train_dataset(stage, crop, **kw)
    got = tds.fetch_train_dataset(stage, crop, **kw)
    assert len(got) == len(want) > 0
    parts = _parts(got)
    assert len(parts) == len(_parts(want))
    _seed_augmentors(want, 40)
    _seed_augmentors(got, 40)
    for (_, start), (_, n) in zip(parts, ((d, len(d)) for d, _ in parts)):
        for i in sorted({start, start + 1, start + n - 1}):
            g, w = got[i], want[i]
            assert g["image1"].shape == (32, 48, 3), (stage, i)
            _assert_sample_close(g, w, f"{stage} {i}")


def test_stages_refuse_what_they_cannot_build(train_trees):
    with pytest.raises(ValueError, match="shards_root"):
        tds.fetch_train_dataset("mixed", (32, 48), data_root=train_trees)
    with pytest.raises(ValueError, match="unknown stage"):
        tds.fetch_train_dataset("imagenet", (32, 48))
    hd1k = tds.HD1K(root=f"{train_trees}/HD1k")
    assert len(hd1k) == len(jds.HD1K(root=f"{train_trees}/HD1k")) == 4
    assert hd1k.augmentor is None and hd1k.sparse
    _assert_sample_close(hd1k[3], jds.HD1K(root=f"{train_trees}/HD1k")[3],
                         "hd1k")


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_loader_matches_jax(tmp_path, rank, world):
    _write_shards(tmp_path)
    batches = []
    for mod in (jds, tds):
        ds = mod.AugmentedShards(str(tmp_path), crop_size=(32, 48), seed=1)
        cls = jloader.Loader if mod is jds else tloader.Loader
        it = iter(cls(ds, batch_size=4, num_workers=1, seed=2,
                      process_index=rank, process_count=world))
        batches.append([next(it) for _ in range(3)])
        it.close()
    for r, g in zip(*batches):
        assert set(r) == set(g)
        assert g["image1"].shape == (4 // world, 32, 48, 3)
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_to_device_gives_the_step_tensors(tmp_path):
    _write_shards(tmp_path, n=2)
    ds = tds.AugmentedShards(str(tmp_path), crop_size=(32, 48), seed=0)
    batch = tloader.collate([ds[0], ds[1]])
    out = tloader.to_device(batch, "cpu")
    assert set(out) == {"image1", "image2", "flow", "valid", "label"}
    assert out["image1"].shape == (2, 3, 32, 48)
    assert out["flow"].shape == (2, 2, 32, 48)
    assert out["valid"].shape == (2, 32, 48)
    assert out["label"].shape == (2, 4)
    assert all(t.dtype == torch.float32 for t in out.values())
    np.testing.assert_array_equal(out["flow"].numpy().transpose(0, 2, 3, 1),
                                  batch["flow"])


def test_loader_raises_what_a_sample_raises(tmp_path):
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError(f"sample {i}")

    it = iter(tloader.Loader(Broken(), batch_size=2, num_workers=1))
    with pytest.raises(KeyError, match="sample"):
        next(it)
