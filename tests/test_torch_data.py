"""The port's shard reader and loader on the CPU against the JAX package's.

The same seeded npz shards (the synthesis writer's keys, f16 and int16
flows) are read by both ``AugmentedShards`` with the same seed: the draws
(side, flips, crop) come in the same order, so the samples must be equal.
``Loader`` with one worker thread (several share the dataset's generator
in a varying order) must give equal batches. ``to_device`` gives the
step's NCHW tensors.
"""

import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.data import datasets as jds
from opticalflowfromdepth_tpu.data import loader as jloader
from opticalflowfromdepth_tpu.synth.writer import FLOW_Q, write_augmented
from opticalflowfromdepth_torch.data import datasets as tds
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


def test_re_augment_is_refused(tmp_path):
    _write_shards(tmp_path, n=1)
    with pytest.raises(NotImplementedError, match="FlowAugmentor"):
        tds.AugmentedShards(str(tmp_path), re_augment=True)


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
