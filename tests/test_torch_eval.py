"""The port's evaluation plane on the CPU against the JAX package's.

``data/frame_io`` (``.flo`` byte for byte, ``.pfm``, KITTI PNGs both ways
against JAX's cv2 reader and writer, the PNG decoder's five row filters
against cv2), every benchmark dataset class, every validator and both
submissions on the same fake trees (written by the port's writers) with
the same deterministic numpy ``infer_fn``, the eval metrics, one
RAFT-basic f32 validation of the port's model against the JAX model on
the same weights, and the CLI's ``--val`` and ``--submission`` on the CPU
for both models.
"""

import functools
import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image

from opticalflowfromdepth_tpu.data import datasets as jds
from opticalflowfromdepth_tpu.data import frame_io as jio
from opticalflowfromdepth_tpu.eval import submission as jsub
from opticalflowfromdepth_tpu.eval import validators as jval
from opticalflowfromdepth_tpu.eval.infer import raft_infer_fn as j_raft_infer
from opticalflowfromdepth_tpu.models.raft import RAFT as JRAFT
from opticalflowfromdepth_tpu.train import loss as jloss
from opticalflowfromdepth_torch.data import datasets as tds
from opticalflowfromdepth_torch.data import frame_io as tio
from opticalflowfromdepth_torch.eval import cli
from opticalflowfromdepth_torch.eval import submission as tsub
from opticalflowfromdepth_torch.eval import validators as tval
from opticalflowfromdepth_torch.eval.infer import raft_infer_fn
from opticalflowfromdepth_torch.models.gmflow import GMFlow
from opticalflowfromdepth_torch.models.raft import RAFT
from opticalflowfromdepth_torch.train import loss as tloss
from opticalflowfromdepth_torch.weights import raft_state_dict_from_flax

torch.set_num_threads(2)
SINTEL_HW, KITTI_HW = (60, 90), (36, 70)   # both need padding


# --------------------------------------------------------------------------
# frame_io
# --------------------------------------------------------------------------

def test_flo_byte_identical_both_ways(tmp_path):
    flow = np.random.default_rng(0).normal(0, 30, (7, 11, 2)).astype(
        np.float32)
    tio.write_flo(str(tmp_path / "t.flo"), flow)
    jio.write_flo(str(tmp_path / "j.flo"), flow)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo"
                                                 ).read_bytes()
    np.testing.assert_array_equal(tio.read_flo(str(tmp_path / "j.flo")), flow)
    np.testing.assert_array_equal(jio.read_flo(str(tmp_path / "t.flo")), flow)
    assert np.array_equal(tio.read_gen(str(tmp_path / "t.flo")),
                          jio.read_gen(str(tmp_path / "t.flo")))


def _write_pfm(path, data, little_endian):
    color = data.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n" if little_endian else b"2.5\n")
        np.flipud(data).astype("<f4" if little_endian else ">f4").tofile(f)


@pytest.mark.parametrize("color", [True, False])
@pytest.mark.parametrize("little_endian", [True, False])
def test_pfm_equal_to_jax(tmp_path, color, little_endian):
    rng = np.random.default_rng(1)
    data = rng.normal(0, 50, (6, 9, 3) if color else (6, 9)).astype(
        np.float32)
    path = str(tmp_path / "x.pfm")
    _write_pfm(path, data, little_endian)
    got, scale = tio.read_pfm(path)
    want, jscale = jio.read_pfm(path)
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, want)
    assert scale == jscale == (1.0 if little_endian else 2.5)
    np.testing.assert_array_equal(tio.read_gen(path), jio.read_gen(path))


def _kitti_flow(rng, h, w):
    """A KITTI-range flow (with values past the 16-bit range, which clip),
    a sparse valid mask."""
    flow = rng.normal(0, 80, (h, w, 2)).astype(np.float32)
    flow[0, :3] = [[600.0, -600.0], [-513.0, 511.99], [1e-3, -1e-3]]
    valid = (rng.uniform(size=(h, w)) > 0.4).astype(np.float32)
    return flow, valid


@pytest.mark.parametrize("with_valid", [True, False])
def test_kitti_png_port_written_read_by_jax_cv2(tmp_path, with_valid):
    pytest.importorskip("cv2")
    flow, valid = _kitti_flow(np.random.default_rng(2), 13, 21)
    path = str(tmp_path / "t.png")
    tio.write_flow_kitti(path, flow, valid if with_valid else None)
    jflow, jvalid = jio.read_flow_kitti(path)
    tflow, tvalid = tio.read_flow_kitti(path)
    np.testing.assert_array_equal(tflow, jflow)
    np.testing.assert_array_equal(tvalid, jvalid)
    assert tflow.dtype == tvalid.dtype == np.float32
    np.testing.assert_array_equal(tvalid, valid if with_valid else 1.0)
    inside = np.abs(flow) < 511
    assert np.abs(tflow - flow)[inside].max() <= 1 / 64
    assert tflow[0, 0].tolist() == [(65535 - 2 ** 15) / 64, -512.0]


def test_kitti_png_jax_written_read_by_port(tmp_path):
    pytest.importorskip("cv2")
    flow, valid = _kitti_flow(np.random.default_rng(3), 17, 12)
    path = str(tmp_path / "j.png")
    jio.write_flow_kitti(path, flow, valid)
    for a, b in zip(tio.read_flow_kitti(path), jio.read_flow_kitti(path)):
        np.testing.assert_array_equal(a, b)


def _png(img, kinds):
    """A PNG of ``img`` (uint8/uint16, gray or RGB) whose row r is filtered
    with ``kinds[r]``: the encoder side of each filter, written out here."""
    h = img.shape[0]
    depth = 16 if img.dtype == np.uint16 else 8
    bpp = (1 if img.ndim == 2 else 3) * depth // 8
    data = (img.astype(">u2") if depth == 16 else img).view(np.uint8)
    data = data.reshape(h, -1).astype(np.int32)
    rows, prior = [], np.zeros(data.shape[1], np.int32)
    for r in range(h):
        x = data[r]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        b, kind = prior, kinds[r]
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        rows.append(np.concatenate([[kind], (x - pred) & 255]).astype(
            np.uint8))
        prior = x
    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, depth,
                       0 if img.ndim == 2 else 2, 0, 0, 0)
    return (tio.PNG_SIGNATURE + tio._png_chunk(b"IHDR", ihdr)
            + tio._png_chunk(b"IDAT", zlib.compress(np.stack(rows).tobytes()))
            + tio._png_chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("depth,color", [(8, False), (8, True), (16, False),
                                         (16, True)])
def test_png_row_filters_decode_as_cv2(tmp_path, kind, depth, color):
    """One hand-built PNG per row filter (and one mixing all five), decoded
    equal to ``cv2.imread(..., IMREAD_ANYDEPTH | IMREAD_COLOR)`` (BGR, gray
    as three equal channels) and to the image itself."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    dtype = np.uint16 if depth == 16 else np.uint8
    shape = (9, 13, 3) if color else (9, 13)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    img[3:6] = img[2]          # flat runs, where the predictors tie
    kinds = rng.integers(0, 5, 9) if kind == "mixed" else [kind] * 9
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png(img, kinds))
    got = tio.read_png(path)
    want = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    assert got.dtype == dtype and got.shape == shape
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, want[..., ::-1] if color
                                  else want[..., 0])


def test_png_refuses_interlaced_and_palette(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    data = bytearray(_png(img, [0] * 4))
    ihdr = 8 + 8                           # the IHDR body
    for patch, match in (({12: 1}, "interlaced"), ({9: 3}, "colour type")):
        bad = bytearray(data)
        for off, val in patch.items():
            bad[ihdr + off] = val
        path = tmp_path / "bad.png"
        path.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match=match):
            tio.read_png(str(path))


def test_port_imports_no_cv2():
    """The port does not depend on cv2: no module of it, and not
    ``chip_smoke.py``, imports it."""
    import ast
    import pathlib
    repo = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((repo / "opticalflowfromdepth_torch").rglob("*.py"))
    files.append(repo / "chip_smoke.py")
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.name}: {n}" for n in names if n.split(".")[0] ==
                    "cv2"]
    assert len(files) > 20 and not bad, bad


def test_read_disp_kitti_equal_to_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    disp = np.random.default_rng(5).integers(0, 65536, (11, 17)).astype(
        np.uint16)
    path = str(tmp_path / "d.png")
    cv2.imwrite(path, disp)
    got = tio.read_disp_kitti(path)
    np.testing.assert_array_equal(got, jio.read_disp_kitti(path))
    np.testing.assert_array_equal(got, disp.astype(np.float32) / 256.0)


# --------------------------------------------------------------------------
# fake benchmark trees, written by the port's writers
# --------------------------------------------------------------------------

def _save_image(path, rng, hw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(
        path)


def _quantized(flow):
    """On KITTI's 1/64 px grid, so a PNG round trip is exact."""
    return (np.round(flow * 64) / 64).astype(np.float32)


@pytest.fixture(scope="module")
def bench_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    rng = np.random.default_rng(10)
    h, w = SINTEL_HW
    scenes = (("alley_1", 4), ("bamboo_2", 3))
    for scene, n in scenes:
        for dstype in ("clean", "final"):
            for i in range(n):
                _save_image(str(root / "Sintel/training" / dstype / scene
                                / f"frame_{i + 1:04d}.png"), rng, (h, w))
        for sub in ("flow", "occlusions"):
            (root / "Sintel/training" / sub / scene).mkdir(parents=True)
        for i in range(n - 1):
            # speeds in all three buckets, some leaving the frame
            flow = rng.normal(0, 1, (h, w, 2)).astype(np.float32) * \
                rng.choice([3.0, 20.0, 60.0], (h, w, 1)).astype(np.float32)
            tio.write_flo(str(root / "Sintel/training/flow" / scene
                              / f"frame_{i + 1:04d}.flo"), flow)
            occ = (rng.uniform(size=(h, w)) > 0.7).astype(np.uint8) * 255
            Image.fromarray(occ).save(root / "Sintel/training/occlusions"
                                      / scene / f"frame_{i + 1:04d}.png")
    for dstype in ("clean", "final"):
        for scene, n in (("alley_9", 3), ("bandage_9", 2)):
            for i in range(n):
                _save_image(str(root / "Sintel/test" / dstype / scene
                                / f"frame_{i + 1:04d}.png"), rng, (h, w))

    kh, kw = KITTI_HW
    for base, img_dir, n in (("KITTI", "image_2", 163),
                             ("KITTI12", "colored_0", 3)):
        for i in range(n):
            for t in (10, 11):
                _save_image(str(root / base / "training" / img_dir
                                / f"{i:06d}_{t}.png"), rng, (kh, kw))
            flow, valid = _kitti_flow(rng, kh, kw)
            flow = _quantized(np.clip(flow, -500, 500))
            os.makedirs(root / base / "training/flow_occ", exist_ok=True)
            tio.write_flow_kitti(str(root / base / "training/flow_occ"
                                     / f"{i:06d}_10.png"), flow, valid)
    for i in range(2):
        for t in (10, 11):
            _save_image(str(root / "KITTI/testing/image_2"
                            / f"{i:06d}_{t}.png"), rng, (kh, kw))

    chairs = root / "FlyingChairs_release/data"
    chairs.mkdir(parents=True)
    for i in range(4):
        for k in (1, 2):
            Image.fromarray(rng.integers(0, 256, (24, 32, 3), np.uint8)).save(
                chairs / f"{i + 1:05d}_img{k}.ppm")
        tio.write_flo(str(chairs / f"{i + 1:05d}_flow.flo"),
                      rng.normal(0, 5, (24, 32, 2)).astype(np.float32))
    (root / "FlyingChairs_release/chairs_split.txt").write_text("1\n2\n1\n2\n")

    things = root / "FlyingThings3D"
    for seq in ("A/0000", "B/0001"):
        for i in range(6, 10):
            _save_image(str(things / "frames_cleanpass/TEST" / seq / "left"
                            / f"{i:04d}.png"), rng, (24, 32))
        for direction, tag in (("into_future", "IntoFuture"),
                               ("into_past", "IntoPast")):
            d = things / "optical_flow/TEST" / seq / direction / "left"
            d.mkdir(parents=True)
            for i in range(6, 10):
                flow = rng.normal(0, 8, (24, 32, 3)).astype(np.float32)
                flow[..., 2] = 0
                if seq == "B/0001" and i == 7:
                    flow[0, 0, 0] = 450.0      # skipped: over 400 px
                _write_pfm(str(d / f"OpticalFlow{tag}_{i:04d}_L.pfm"), flow,
                           True)
    return str(root)


DATASETS = {
    "sintel training clean, occlusion": lambda m, r: m.MpiSintel(
        split="training", dstype="clean", root=f"{r}/Sintel",
        load_occlusion=True),
    "sintel training final": lambda m, r: m.MpiSintel(
        split="training", dstype="final", root=f"{r}/Sintel"),
    "sintel test": lambda m, r: m.MpiSintel(split="test", dstype="final",
                                            root=f"{r}/Sintel"),
    "chairs validation": lambda m, r: m.FlyingChairs(
        split="validation", root=f"{r}/FlyingChairs_release/data"),
    "chairs training": lambda m, r: m.FlyingChairs(
        split="training", root=f"{r}/FlyingChairs_release/data"),
    "things test": lambda m, r: m.FlyingThings3D(
        root=f"{r}/FlyingThings3D", test_set=True),
    "kitti training": lambda m, r: m.KITTI(split="training",
                                           root=f"{r}/KITTI"),
    "kitti testing": lambda m, r: m.KITTI(split="testing", root=f"{r}/KITTI"),
    "kitti12 training": lambda m, r: m.KITTI12(split="training",
                                               root=f"{r}/KITTI12"),
    "finetunekitti15 validation": lambda m, r: m.FineTuneKITTI15(
        split="validation", root=f"{r}/KITTI"),
    "finetunekitti15 training": lambda m, r: m.FineTuneKITTI15(
        split="training", root=f"{r}/KITTI"),
}


@pytest.mark.parametrize("name", list(DATASETS))
def test_dataset_equal_to_jax(bench_root, name):
    """The same pairs in the same order and, for the first and last few
    samples, the same arrays, bit for bit."""
    got, want = (DATASETS[name](m, bench_root) for m in (tds, jds))
    assert len(got) == len(want) > 0
    assert got.image_list == want.image_list
    assert got.flow_list == want.flow_list
    assert [list(e) for e in got.extra_info] == [list(e) for e in
                                                 want.extra_info]
    for i in sorted({0, 1, len(got) - 2, len(got) - 1} - {-1}):
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "extra_info":
                assert list(a[k]) == list(b[k])
            else:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_datasets_refuse_augmentation_and_partial_occlusions(bench_root,
                                                             tmp_path):
    # augmentation is ported: the augmented datasets return crops
    sintel_aug = tds.MpiSintel(aug_params={"crop_size": (8, 8)},
                               root=f"{bench_root}/Sintel")
    kitti_aug = tds.KITTI(aug_params={"crop_size": (8, 8)},
                          root=f"{bench_root}/KITTI")
    for ds in (sintel_aug, kitti_aug):
        sample = ds[0]
        assert sample["image1"].shape == (8, 8, 3)
        assert sample["flow"].shape == (8, 8, 2)
        assert sample["valid"].shape == (8, 8)
    sintel = tmp_path / "Sintel/training"
    for sub in ("clean/s", "flow/s", "occlusions/s"):
        (sintel / sub).mkdir(parents=True)
    for i in range(3):
        _save_image(str(sintel / f"clean/s/frame_{i:04d}.png"),
                    np.random.default_rng(i), (8, 8))
    for i in range(2):
        tio.write_flo(str(sintel / f"flow/s/frame_{i:04d}.flo"),
                      np.zeros((8, 8, 2), np.float32))
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(
        sintel / "occlusions/s/frame_0000.png")
    for m in (tds, jds):
        with pytest.raises(ValueError, match="partially populated"):
            m.MpiSintel(root=str(tmp_path / "Sintel"), load_occlusion=True)


# --------------------------------------------------------------------------
# metrics, validators, submissions
# --------------------------------------------------------------------------

def test_eval_metrics_match_jax():
    rng = np.random.default_rng(6)
    pred, gt = (rng.normal(0, 8, (2, 9, 11, 2)).astype(np.float32)
                for _ in range(2))
    valid = (rng.uniform(size=(2, 9, 11)) > 0.3).astype(np.float32)
    t = [torch.from_numpy(a) for a in (pred, gt)]
    nchw = [a.permute(0, 3, 1, 2) for a in t]
    for jf, tf in ((jloss.epe_metric, tloss.epe_metric),
                   (jloss.fl_all_metric, tloss.fl_all_metric)):
        want = float(jf(jnp.asarray(pred), jnp.asarray(gt),
                        jnp.asarray(valid)))
        got = tf(*nchw, torch.from_numpy(valid))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == pytest.approx(want, rel=1e-6)
    zero = torch.zeros(2, 9, 11)
    assert float(tloss.epe_metric(*nchw, zero)) == 0.0


def numpy_infer(image1, image2, flow_init=None):
    """A deterministic function of the padded pair (and of the warm start's
    init), so that every pixel and every call counts."""
    flow = (image1[..., :2] - image2[..., 1:]) / 16.0 \
        + np.float32([1.5, -2.0])
    if flow_init is not None:
        flow = flow + np.asarray(flow_init).mean(axis=(1, 2))[:, None, None]
    return flow.astype(np.float32)


def numpy_infer_low(image1, image2, flow_init=None):
    flow = numpy_infer(image1, image2, flow_init)
    return flow[:, ::8, ::8] * 0.125, flow


VALIDATIONS = {
    "chairs": ("validate_chairs", {}),
    "things": ("validate_things", dict(max_samples=5)),
    "things all": ("validate_things", {}),
    "sintel clean, speed, matched": ("validate_sintel", dict(
        with_speed_metric=True, evaluate_matched_unmatched=True)),
    "sintel final, padding 16": ("validate_sintel", dict(
        dstype="final", padding_factor=16)),
    "kitti": ("validate_kitti", {}),
    "kitti12": ("validate_kitti12", {}),
    "finetunekitti15": ("validate_finetunekitti15", {}),
}


@pytest.mark.parametrize("name", list(VALIDATIONS))
def test_validator_equal_to_jax(bench_root, name):
    fn, kwargs = VALIDATIONS[name]
    got = getattr(tval, fn)(numpy_infer, root=bench_root, **kwargs)
    want = getattr(jval, fn)(numpy_infer, root=bench_root, **kwargs)
    assert sorted(got) == sorted(want) and got
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-12), k


def test_validate_sintel_count_time_and_in_boundary_mask(bench_root):
    calls = []

    def counting(image1, image2):
        calls.append(image1.shape)
        return numpy_infer(image1, image2)

    res = tval.validate_sintel(counting, root=bench_root, count_time=True,
                               timing_runs=3)
    assert res["inference_time_ms"] > 0
    assert len(calls) == 5 + 3 + 5 and set(calls) == {(1, 64, 96, 3)}
    flow = np.random.default_rng(7).normal(0, 30, (20, 30, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(tval.in_boundary_mask(flow),
                                  jval.in_boundary_mask(flow))
    assert set(tval.VALIDATORS) == set(jval.VALIDATORS)


@pytest.mark.parametrize("which", ["sintel", "kitti"])
def test_padded_ground_truth_scores_zero(bench_root, which):
    """An infer_fn that returns the (padded) ground truth of each pair in
    order scores EPE 0 and Fl-all 0: the readers and the padding agree."""
    if which == "sintel":
        ds = tds.MpiSintel(root=f"{bench_root}/Sintel")
        mode, fn = "sintel", tval.validate_sintel
    else:
        ds = tds.KITTI(root=f"{bench_root}/KITTI")
        mode, fn = "kitti", tval.validate_kitti
    flows = iter([ds[i]["flow"] for i in range(len(ds))])

    def truth(image1, image2):
        from opticalflowfromdepth_torch.eval.padder import InputPadder
        gt = next(flows)
        padded = InputPadder(gt.shape, mode=mode).pad(gt[None])[0]
        assert padded.shape[:3] == image1.shape[:3]
        return padded

    res = fn(truth, root=bench_root)
    assert all(v == 0.0 for k, v in res.items() if k.endswith(("epe", "f1")))


def _same_tree(a, b):
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    return names


@pytest.mark.parametrize("warm_start", [False, True])
def test_sintel_submission_equal_to_jax(bench_root, tmp_path, warm_start):
    """The same files, byte for byte: the same flows, and with warm start
    the same forward-splatted inits."""
    calls = []

    def recording(image1, image2, flow_init=None):
        calls.append(flow_init is not None)
        return numpy_infer_low(image1, image2, flow_init)

    tsub.create_sintel_submission(recording, root=bench_root,
                                  output_path=str(tmp_path / "t"),
                                  warm_start=warm_start)
    jsub.create_sintel_submission(numpy_infer_low, root=bench_root,
                                  output_path=str(tmp_path / "j"),
                                  warm_start=warm_start)
    names = _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
    assert len(names) == 6 and "final/alley_9/frame0002.flo" in names
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n
                                                     ).read_bytes(), n
    assert tio.read_flo(str(tmp_path / "t" / names[0])).shape == \
        SINTEL_HW + (2,)
    # per dstype: alley_9 (2 pairs), bandage_9 (1 pair)
    assert calls == [False, warm_start, False] * 2


def test_sintel_submission_takes_a_single_output(bench_root, tmp_path):
    """GMFlow's infer function returns the flow alone: the writer takes
    it as the flow, and writes the same files as for ``(low-res, flow)``
    with the same flow."""
    tsub.create_sintel_submission(numpy_infer, root=bench_root,
                                  output_path=str(tmp_path / "one"))
    tsub.create_sintel_submission(numpy_infer_low, root=bench_root,
                                  output_path=str(tmp_path / "two"))
    names = _same_tree(str(tmp_path / "one"), str(tmp_path / "two"))
    assert len(names) == 6
    for n in names:
        assert (tmp_path / "one" / n).read_bytes() == (tmp_path / "two" / n
                                                       ).read_bytes(), n


def test_sintel_submission_refuses_warm_start_without_low_res(bench_root,
                                                              tmp_path):
    with pytest.raises(ValueError, match="no low-res flow"):
        tsub.create_sintel_submission(numpy_infer, root=bench_root,
                                      output_path=str(tmp_path / "t"),
                                      warm_start=True)


def test_jax_sintel_submission_fails_on_a_single_output(bench_root,
                                                        tmp_path):
    """The known difference: the JAX writer unpacks ``(low-res flow,
    flow)`` from every call, so a single-output function (GMFlow's) makes
    it raise on the same tree."""
    with pytest.raises(ValueError, match="unpack"):
        jsub.create_sintel_submission(numpy_infer, root=bench_root,
                                      output_path=str(tmp_path / "j"))


def test_kitti_submission_equal_to_jax(bench_root, tmp_path):
    """The same file names and, decoded, the same 16-bit values (the two
    PNG encoders compress differently)."""
    pytest.importorskip("cv2")
    tsub.create_kitti_submission(numpy_infer, root=bench_root,
                                 output_path=str(tmp_path / "t"))
    jsub.create_kitti_submission(numpy_infer, root=bench_root,
                                 output_path=str(tmp_path / "j"))
    names = _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
    assert names == ["000000_10.png", "000001_10.png"]
    for n in names:
        got = tio.read_png(str(tmp_path / "t" / n))
        assert got.shape == KITTI_HW + (3,) and got.dtype == np.uint16
        for a, b in zip(jio.read_flow_kitti(str(tmp_path / "t" / n)),
                        jio.read_flow_kitti(str(tmp_path / "j" / n))):
            np.testing.assert_array_equal(a, b)


def test_forward_interpolate_equal_to_jax():
    flow = np.random.default_rng(8).normal(0, 3, (12, 20, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(tsub.forward_interpolate(flow),
                                  jsub.forward_interpolate(flow))
    assert not tsub.forward_interpolate(np.full((6, 6, 2), 50.0,
                                                np.float32)).any()


# --------------------------------------------------------------------------
# models through the validators and the CLI
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _raft_basic():
    """JAX RAFT-basic variables (the update block re-drawn from torch's
    default U(+-1/sqrt(fan_in)), as the reference initialises it, which
    keeps f32 rounding from growing over the GRU steps) and the port's
    model carrying them."""
    dummy = jnp.zeros((1, 64, 96, 3), jnp.float32)
    jmodel = JRAFT(corr_impl="fused")
    v = jax.tree_util.tree_map(np.asarray, jax.jit(functools.partial(
        jmodel.init, iters=1, train=False))(jax.random.PRNGKey(7), dummy,
                                            dummy))
    rng = np.random.default_rng(11)
    flat = traverse_util.flatten_dict(v["params"])
    for k, a in flat.items():
        if k[0] == "update_block":
            shape = flat[k[:-1] + ("kernel",)].shape
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            flat[k] = rng.uniform(-bound, bound, a.shape).astype(np.float32)
    v = dict(v, params=traverse_util.unflatten_dict(flat))
    model = RAFT(corr_impl="fused")
    model.load_state_dict(raft_state_dict_from_flax(
        v["params"], v.get("batch_stats"), False), strict=True)
    return jmodel, v, model


def test_raft_basic_sintel_validation_matches_jax(bench_root):
    """RAFT-basic, f32, 3 iterations, on the 5 Sintel pairs (60x90, padded
    to 64x96): every metric of the port's model within 2e-4 px (the EPEs)
    or 2 pixels in 27000 (the outlier rates) of the JAX model's."""
    jmodel, v, model = _raft_basic()
    got = tval.validate_sintel(raft_infer_fn(model, iters=3, device="cpu"),
                               root=bench_root, with_speed_metric=True)
    want = jval.validate_sintel(j_raft_infer(jmodel, v, iters=3),
                                root=bench_root, with_speed_metric=True)
    assert sorted(got) == sorted(want)
    for k, val in want.items():
        limit = 2 / (5 * 60 * 90) if k.endswith("px") else 2e-4
        assert abs(got[k] - val) <= limit, (k, got[k], val)


def test_cli_val_and_submission_raft(bench_root, tmp_path, capsys):
    ckpt = tmp_path / "raft_small.pth"
    model = RAFT(small=True, generator=torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict()}, ckpt)
    base = ["--model", "raft", "--small", "--ckpt", str(ckpt), "--iters",
            "2", "--device", "cpu", "--data_root", bench_root]
    res = cli.main(base + ["--val", "sintel", "kitti",
                           "--evaluate_matched_unmatched",
                           "--with_speed_metric"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == res and np.isfinite(list(res.values())).all()
    assert {"sintel_clean_epe", "sintel_clean_matched", "sintel_clean_s40+",
            "kitti_epe", "kitti_f1"} <= set(res)
    cli.main(base + ["--submission", "sintel", "--warm_start",
                     "--output_path", str(tmp_path / "sintel")])
    flo = tio.read_flo(str(tmp_path / "sintel/clean/alley_9/frame0002.flo"))
    assert flo.shape == SINTEL_HW + (2,) and np.isfinite(flo).all()
    cli.main(base + ["--submission", "kitti", "--output_path",
                     str(tmp_path / "kitti")])
    flow, valid = tio.read_flow_kitti(str(tmp_path / "kitti/000001_10.png"))
    assert flow.shape == KITTI_HW + (2,) and (valid == 1).all()


def test_cli_val_and_submission_gmflow(bench_root, tmp_path, capsys):
    ckpt = tmp_path / "gmflow.pth"
    torch.save(GMFlow(generator=torch.Generator().manual_seed(1)).state_dict(),
               ckpt)
    base = ["--model", "gmflow", "--ckpt", str(ckpt), "--device", "cpu",
            "--padding_factor", "16", "--data_root", bench_root]
    res = cli.main(base + ["--val", "sintel", "kitti"])
    assert json.loads(capsys.readouterr().out) == res
    assert set(res) == {"sintel_clean_epe", "sintel_clean_1px",
                        "sintel_clean_3px", "sintel_clean_5px", "kitti_epe",
                        "kitti_f1"}
    assert np.isfinite(list(res.values())).all()
    cli.main(base + ["--submission", "kitti", "--output_path",
                     str(tmp_path / "kitti")])
    assert sorted(os.listdir(tmp_path / "kitti")) == ["000000_10.png",
                                                      "000001_10.png"]
    assert tio.read_png(str(tmp_path / "kitti/000000_10.png")).shape == \
        KITTI_HW + (3,)


def test_cli_gmflow_sintel_submission(bench_root, tmp_path):
    """``--submission sintel --model gmflow`` writes the ``.flo`` files;
    ``--warm_start`` without RAFT's low-res flow is refused."""
    ckpt = tmp_path / "gmflow.pth"
    torch.save(GMFlow(generator=torch.Generator().manual_seed(1)).state_dict(),
               ckpt)
    base = ["--model", "gmflow", "--ckpt", str(ckpt), "--device", "cpu",
            "--padding_factor", "16", "--data_root", bench_root,
            "--submission", "sintel", "--output_path", str(tmp_path / "s")]
    cli.main(base)
    names = _same_tree(str(tmp_path / "s"), str(tmp_path / "s"))
    assert len(names) == 6 and all(n.endswith(".flo") for n in names)
    flo = tio.read_flo(str(tmp_path / "s/final/alley_9/frame0002.flo"))
    assert flo.shape == SINTEL_HW + (2,) and np.isfinite(flo).all()
    with pytest.raises(SystemExit):
        cli.main(base + ["--warm_start"])


def test_cli_asks_for_the_card_by_default(bench_root, tmp_path, monkeypatch):
    ckpt = tmp_path / "raft_small.pth"
    torch.save(RAFT(small=True).state_dict(), ckpt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--model", "raft", "--small", "--ckpt", str(ckpt),
                  "--data_root", bench_root, "--val", "kitti"])
