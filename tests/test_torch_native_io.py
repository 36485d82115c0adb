"""The port's npz codec (``csrc/shardio.cc`` through ``data/native_io.py``)
on the CPU: every case of ``tests/test_native_io.py`` against the port's
module, then the port's codec against ``np.load`` and against the JAX
package's native codec in both directions, the writer against JAX's
``AsyncShardWriter``, and the faults the codec must not have: a race
between blobs registered for the next image and the files of this one, a
closed encoder, and entry counts beyond zip32.
"""

import os
import sys
import threading
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_torch import _build
from opticalflowfromdepth_torch.data import datasets as tds
from opticalflowfromdepth_torch.data import native_io
from opticalflowfromdepth_torch.synth import writer as twriter
from opticalflowfromdepth_tpu.data import native_io as jax_io

torch.set_num_threads(2)


def _roundtrip(tmp_path, save_fn, arrays):
    path = os.path.join(tmp_path, "t.npz")
    save_fn(path, **arrays)
    got = native_io.load_npz(str(path))
    assert set(got) == set(arrays)
    for k, ref in arrays.items():
        np.testing.assert_array_equal(got[k], np.asarray(ref), err_msg=k)
        assert got[k].dtype == np.asarray(ref).dtype, k
        assert got[k].shape == np.shape(ref), k


def _mixed(rng):
    return {
        "img": rng.integers(0, 256, (37, 53, 3)).astype(np.uint8),
        "flow": rng.normal(size=(37, 53, 2)).astype(np.float16),
        "depth": rng.uniform(1, 100, (37, 53)).astype(np.float32),
        "big": rng.normal(size=(5, 7, 3, 2)).astype(np.float64),
        "idx": rng.integers(-5, 5, (11,)).astype(np.int32),
        "label": np.int64(3),
        "flag": np.array(True),
    }


# ---------------------------------------------------------------------------
# the cases of tests/test_native_io.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("save_fn", [np.savez, np.savez_compressed])
def test_roundtrip_mixed_dtypes(tmp_path, save_fn):
    _roundtrip(tmp_path, save_fn, _mixed(np.random.default_rng(0)))


def test_roundtrip_shard_like(tmp_path):
    """Exactly the writer's schema (``synth/writer.py``)."""
    rng = np.random.default_rng(1)
    arrays = {}
    for s in ("1", "2"):
        arrays[f"img0_{s}"] = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
        arrays[f"img1_{s}"] = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
        arrays[f"flow_{s}"] = rng.normal(size=(64, 96, 2)).astype(np.float16)
        arrays[f"back_flow_{s}"] = rng.normal(size=(64, 96, 2)).astype(
            np.float16)
        arrays[f"depth0_{s}"] = rng.uniform(1, 100, (64, 96)).astype(np.float16)
        arrays[f"depth1_{s}"] = rng.uniform(1, 100, (64, 96)).astype(np.float16)
    arrays["label"] = np.asarray(6)
    _roundtrip(tmp_path, np.savez_compressed, arrays)


def test_fortran_order(tmp_path):
    x = np.asfortranarray(np.arange(24, dtype=np.float32).reshape(4, 6))
    path = os.path.join(tmp_path, "f.npz")
    np.savez(path, x=x)
    got = native_io.load_npz(str(path))["x"]
    np.testing.assert_array_equal(got, x)
    assert got.flags.f_contiguous


def test_corrupt_file_raises(tmp_path):
    path = os.path.join(tmp_path, "bad.npz")
    with open(path, "wb") as f:
        f.write(b"this is not a zip file" * 10)
    with pytest.raises(IOError, match="not a zip file"):
        native_io.load_npz(str(path))


def test_truncated_file_raises(tmp_path):
    path = os.path.join(tmp_path, "t.npz")
    np.savez_compressed(path, x=np.zeros((100, 100), np.float32))
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(IOError):
        native_io.load_npz(str(path))


def test_prefetch_pool_out_of_order(tmp_path):
    rng = np.random.default_rng(2)
    paths, refs = [], []
    for i in range(12):
        p = os.path.join(tmp_path, f"s{i}.npz")
        arr = rng.normal(size=(33, 47, 2)).astype(np.float32)
        np.savez_compressed(p, flow=arr, i=np.int32(i))
        paths.append(p)
        refs.append(arr)

    with native_io.Prefetcher(num_threads=3) as pool:
        tickets = [pool.submit(p) for p in paths]
        # take in reverse order: tickets resolve independently of order
        for i in reversed(range(12)):
            got = pool.take(tickets[i])
            np.testing.assert_array_equal(got["flow"], refs[i])
            assert int(got["i"]) == i
        with pytest.raises(KeyError):     # taken already
            pool.take(tickets[0])
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit(paths[0])


def test_pool_propagates_errors(tmp_path):
    bad = os.path.join(tmp_path, "nope.npz")
    with native_io.Prefetcher(num_threads=1) as pool:
        t = pool.submit(bad)
        with pytest.raises(IOError, match="cannot open"):
            pool.take(t)


def test_encoder_roundtrip_np_load_and_native(tmp_path):
    """save_npz output loads with np.load (stored and deflated entries)
    and with the port's decoder; a 0-d array stays 0-d."""
    rng = np.random.default_rng(1)
    arrays = {
        "img": rng.integers(0, 256, (41, 57, 3)).astype(np.uint8),
        "flow": rng.normal(size=(41, 57, 2)).astype(np.float16),
        "q16": (rng.normal(0, 300, (41, 57, 2)) * 64).astype(np.int16),
        "depth": rng.uniform(1, 100, (41, 57)).astype(np.float32),
        "label": np.int32(6),
    }
    for store_floats in (True, False):
        path = os.path.join(tmp_path, f"e{int(store_floats)}.npz")
        native_io.save_npz(path, arrays, store_floats=store_floats)
        with np.load(path) as z:
            for k, v in arrays.items():
                np.testing.assert_array_equal(z[k], v, err_msg=k)
                assert z[k].dtype == np.asarray(v).dtype, k
        got = native_io.load_npz(path)
        for k, v in arrays.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            assert got[k].shape == np.shape(v), k
        with zipfile.ZipFile(path) as zf:
            assert zf.testzip() is None


def test_encoder_blob_dedup_and_many_files(tmp_path):
    """One blob shared by many files; every file reads back and the shared
    entry is identical. More files than threads."""
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    uniq = [rng.normal(size=(64, 96, 2)).astype(np.float16)
            for _ in range(16)]
    with native_io.ShardEncoder(threads=3) as enc:
        for i in range(16):
            enc.file(os.path.join(tmp_path, f"f{i}.npz"),
                     [("shared", shared), ("u", uniq[i])])
        enc.drain()
        assert (enc.blobs, enc.entries) == (17, 32)
        assert enc.busy_s > 0
    for i in range(16):
        with np.load(os.path.join(tmp_path, f"f{i}.npz")) as z:
            np.testing.assert_array_equal(z["shared"], shared)
            np.testing.assert_array_equal(z["u"], uniq[i])


def test_encoder_error_reported(tmp_path):
    with native_io.ShardEncoder(threads=2) as enc:
        enc.file(os.path.join(tmp_path, "no_such_dir", "x.npz"),
                 [("a", np.zeros((4, 4), np.float32))])
        enc.file(os.path.join(tmp_path, "ok.npz"),
                 [("a", np.zeros((4, 4), np.float32))])
        with pytest.raises(IOError, match="1 file.*cannot open"):
            enc.drain()
        enc.drain()                       # the failure was reported once
    assert native_io.load_npz(os.path.join(tmp_path, "ok.npz"))["a"].shape \
        == (4, 4)


def _packed_sample(h=48, w=64):
    """A packed sample made by the JAX package (as its test makes it)."""
    from opticalflowfromdepth_tpu.synth.pipeline import (
        synthesize_sample_packed)
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (3, h, w)).astype(np.float32))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dep = jnp.asarray((130 + 70 * np.sin(xx / 19) * np.cos(yy / 23))[None])
    return jax.tree.map(np.asarray, synthesize_sample_packed(
        jax.random.PRNGKey(0), img, dep))


def _same_trees(a, b, scalar_shape=()):
    """The same files with equal arrays (dtype, shape, values); 0-d arrays
    of ``a`` have ``scalar_shape`` in ``b``."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for f in names:
        with np.load(os.path.join(a, f)) as za, \
                np.load(os.path.join(b, f)) as zb:
            assert sorted(za.files) == sorted(zb.files), f
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (f, k)
                assert zb[k].shape == (za[k].shape or scalar_shape), (f, k)
                np.testing.assert_array_equal(za[k], zb[k], err_msg=f + k)
    return names


@pytest.mark.parametrize("flow_int16", [False, True])
def test_async_writer_native_matches_python(tmp_path, flow_int16):
    """The port's ShardWriter through the codec writes the same 61 files,
    with equal arrays, as JAX's AsyncShardWriter(use_native=True) and as
    its own Python pool (use_native=False); fewer blobs than entries."""
    from opticalflowfromdepth_tpu.synth.writer import AsyncShardWriter
    packed = _packed_sample()
    nat, py, jx = (str(tmp_path / d) for d in ("nat", "py", "jax"))
    wr = twriter.ShardWriter(nat, workers=2, flow_int16=flow_int16)
    wr.submit("t", packed)
    enc = wr.enc
    assert wr.drain() == 61 and wr.drain() == 61     # a second drain: no-op
    with pytest.raises(RuntimeError):
        wr.submit("u", packed)
    assert wr.write_s > 0 and wr.wait_s > 0
    assert enc.entries == 61 * 13 - 12 and enc.blobs < enc.entries
    # the parents' image, depth and flow once a group, the rest per file
    assert enc.blobs == 1 + 5 * (6 + 9 * 8 + 3 * 2 + 12)
    pw = twriter.ShardWriter(py, workers=2, flow_int16=flow_int16,
                             use_native=False)
    pw.submit("t", packed)
    assert pw.drain() == 61 and pw.enc is None
    jw = AsyncShardWriter(jx, workers=2, flow_int16=flow_int16)
    assert jw.enc is not None
    jw.submit("t", packed)
    assert jw.drain() == 61
    assert len(_same_trees(nat, py)) == 61
    # JAX's encoder writes a 0-d array (the label) as shape (1,): it passes
    # np.ascontiguousarray's at-least-1-d result; np.load and the port read
    # what the header says
    _same_trees(nat, jx, scalar_shape=(1,))


# ---------------------------------------------------------------------------
# the port's codec against np.load and the JAX package's codec
# ---------------------------------------------------------------------------

def _interop_arrays(rng):
    """What both codecs take: simple little-endian dtypes, every rank the
    shards use, a strided view (the writer's HWC views of CHW data)."""
    chw = rng.integers(0, 256, (3, 29, 31)).astype(np.uint8)
    return {
        "img": np.moveaxis(chw, 0, -1),
        "flow": rng.normal(size=(29, 31, 2)).astype(np.float16),
        "q16": (rng.normal(0, 300, (29, 31, 2)) * 64).astype(np.int16),
        "depth": rng.uniform(1, 100, (29, 31)).astype(np.float32),
        "f64": rng.normal(size=(3, 4)),
        "idx": rng.integers(-9, 9, (7,)).astype(np.int64),
        "label": np.int32(5),
        "flag": np.array(False),
    }


def _methods(path):
    with zipfile.ZipFile(path) as zf:
        return {i.filename: i.compress_type for i in zf.infolist()}


@pytest.mark.parametrize("store_floats", [True, False])
def test_codec_against_jax_codec_both_ways(tmp_path, store_floats):
    """Files of JAX's save_npz and ShardEncoder decode through the port's
    load_npz as through np.load; the port's decode through JAX's load_npz
    and np.load; each entry's zip method is the same under both."""
    arrays = _interop_arrays(np.random.default_rng(3))
    port, jx = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    native_io.save_npz(port, arrays, store_floats=store_floats)
    jax_io.save_npz(jx, arrays, store_floats=store_floats)
    assert _methods(port) == _methods(jx)
    stored = {k for k, m in _methods(port).items() if m == 0}
    assert stored == ({"flow.npy", "depth.npy", "f64.npy"} if store_floats
                      else set())
    for path in (port, jx):
        with np.load(path) as z:
            ref = {k: z[k] for k in z.files}
        for got in (native_io.load_npz(path), jax_io.load_npz(path)):
            assert set(got) == set(arrays) == set(ref)
            for k, v in arrays.items():
                assert got[k].dtype == ref[k].dtype == np.asarray(v).dtype
                assert got[k].shape == ref[k].shape, (path, k)
                np.testing.assert_array_equal(got[k], v, err_msg=k)
                np.testing.assert_array_equal(ref[k], v, err_msg=k)
    # JAX's encoder over many files, read by the port
    shared = arrays["img"]
    jenc = jax_io.ShardEncoder(threads=2, store_floats=store_floats)
    try:
        for i in range(4):
            jenc.file(str(tmp_path / f"j{i}.npz"),
                      [("shared", shared), ("i", np.int32(i)),
                       ("f", arrays["flow"] * i)])
        jenc.drain()
    finally:
        jenc.close()
    for i in range(4):
        got = native_io.load_npz(tmp_path / f"j{i}.npz")
        np.testing.assert_array_equal(got["shared"], shared)
        assert got["i"].shape == (1,) and got["i"][0] == i   # see above
        np.testing.assert_array_equal(got["f"], arrays["flow"] * i)


def test_layouts_round_trip(tmp_path):
    """Views the encoder packs itself (transposed, reversed, broadcast,
    empty, 0-d, big-endian) come back equal, through both decoders."""
    cases = {
        "t3": np.arange(24.).reshape(2, 3, 4).transpose(2, 0, 1),
        "rev": np.arange(10)[::-3],
        "scalar": np.float32(3.5),
        "mixed": np.arange(120, dtype=np.int16).reshape(3, 4, 10)[:, ::-1, 1::3],
        "bcast": np.broadcast_to(np.arange(3, dtype=np.uint8), (4, 3)),
        "empty": np.zeros((2, 0, 3), np.float16),
        "c128": np.arange(6, dtype=np.complex128).reshape(2, 3).T,
        "be": np.arange(5, dtype=">i4"),
        "t4": np.arange(360).reshape(3, 4, 5, 6).transpose(1, 3, 0, 2)[::-1],
    }
    path = str(tmp_path / "l.npz")
    native_io.save_npz(path, cases)
    got = native_io.load_npz(path)
    with np.load(path) as z:
        for k, v in cases.items():
            assert got[k].shape == np.shape(v) and got[k].dtype == \
                np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_decoder_checks_crc_and_refuses_objects(tmp_path):
    path = str(tmp_path / "s.npz")
    np.savez(path, x=np.arange(1000, dtype=np.int32))
    raw = bytearray(open(path, "rb").read())
    raw[600] ^= 1                       # one bit of the stored payload
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(IOError, match="CRC-32 mismatch"):
        native_io.load_npz(path)
    np.savez(path, o=np.array([{"a": 1}], dtype=object))
    with pytest.raises(IOError, match="not supported"):
        native_io.load_npz(path)
    with pytest.raises(ValueError):
        native_io.save_npz(path, {"o": np.array([None], dtype=object)})


# ---------------------------------------------------------------------------
# the faults the codec must not have
# ---------------------------------------------------------------------------

def test_encoder_race_next_image_blobs_while_files_in_flight(tmp_path):
    """8 threads over 20 images, no drain between them: image k+1's blobs
    are registered while image k's files are being written (the JAX
    encoder's registry was read there without its lock). Every file must
    read back right. Shortened switch interval, bounded in time."""
    rng = np.random.default_rng(7)
    images = []
    for _ in range(20):
        images.append({
            "img0": rng.integers(0, 256, (3, 48, 64)).astype(np.uint8),
            "img1": rng.integers(0, 256, (48, 64, 3)).astype(np.uint8),
            "flow": rng.normal(size=(2, 48, 64)).astype(np.float16),
            "own": [rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
                    for _ in range(6)],
        })
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    done = threading.Event()

    def run():
        with native_io.ShardEncoder(threads=8) as enc:
            for k, im in enumerate(images):
                flow_hwc = np.moveaxis(im["flow"], 0, -1)
                for j, own in enumerate(im["own"]):
                    enc.file(str(tmp_path / f"i{k}_f{j}.npz"), [
                        ("img0", np.moveaxis(im["img0"], 0, -1)),
                        ("img1", im["img1"]), ("flow", flow_hwc),
                        ("own", own), ("k", np.int32(k))])
                if k == 12:
                    enc.drain()         # the encoder keeps working after it
            enc.drain()
        done.set()

    try:
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive() and done.is_set()
    for k, im in enumerate(images):
        for j, own in enumerate(im["own"]):
            got = native_io.load_npz(tmp_path / f"i{k}_f{j}.npz")
            np.testing.assert_array_equal(got["img0"],
                                          np.moveaxis(im["img0"], 0, -1))
            np.testing.assert_array_equal(got["img1"], im["img1"])
            np.testing.assert_array_equal(got["flow"],
                                          np.moveaxis(im["flow"], 0, -1))
            np.testing.assert_array_equal(got["own"], own)
            assert int(got["k"]) == k


def test_closed_encoder_raises(tmp_path):
    enc = native_io.ShardEncoder(threads=2)
    enc.file(str(tmp_path / "a.npz"), [("x", np.ones(3))])
    enc.close()                          # finishes the queued file
    enc.close()
    assert native_io.load_npz(tmp_path / "a.npz")["x"].shape == (3,)
    with pytest.raises(RuntimeError, match="closed"):
        enc.file(str(tmp_path / "b.npz"), [("x", np.ones(3))])
    with pytest.raises(RuntimeError, match="closed"):
        enc.blob(np.ones(3))
    with pytest.raises(RuntimeError, match="closed"):
        enc.drain()


def test_zip32_entry_count_fails_drain(tmp_path):
    """65,536 one-byte entries do not fit a zip32 directory: the file
    fails with IOError and is not written; 65,534 fit."""
    one = np.zeros(1, np.uint8)
    with native_io.ShardEncoder(threads=2) as enc:
        enc.file(str(tmp_path / "many.npz"),
                 [(f"a{i}", one) for i in range(65536)])
        assert enc.blobs == 1            # one array object, one blob
        with pytest.raises(IOError, match="65536 entries"):
            enc.drain()
        assert not os.path.exists(tmp_path / "many.npz")
        enc.file(str(tmp_path / "fits.npz"),
                 [(f"a{i}", one) for i in range(65534)])
        enc.drain()
    with zipfile.ZipFile(tmp_path / "fits.npz") as zf:
        assert len(zf.infolist()) == 65534


def test_corrupt_and_truncated_shards_fall_through(tmp_path):
    """AugmentedShards skips a shard the codec cannot decode and reads the
    next index instead, drawing from its generator as before."""
    rng = np.random.default_rng(4)

    def shard(path, k):
        arrays = {"label": np.int32(k % 8)}
        for s in ("1", "2"):
            arrays.update({
                f"img0_{s}": rng.integers(0, 256, (24, 32, 3), dtype=np.uint8),
                f"img1_{s}": rng.integers(0, 256, (24, 32, 3), dtype=np.uint8),
                f"depth0_{s}": rng.uniform(1, 9, (24, 32)).astype(np.float16),
                f"depth1_{s}": rng.uniform(1, 9, (24, 32)).astype(np.float16),
                f"flow_{s}": rng.normal(size=(24, 32, 2)).astype(np.float16),
                f"back_flow_{s}": rng.normal(size=(24, 32, 2)).astype(
                    np.float16)})
        native_io.save_npz(path, arrays)

    for k in range(3):
        shard(str(tmp_path / f"s{k}_g0_a{k}.npz"), k)
    good = tds.AugmentedShards(str(tmp_path), seed=0)
    want = [good[i] for i in range(3)]
    names = sorted(os.listdir(tmp_path))
    raw = open(tmp_path / names[0], "rb").read()
    with open(tmp_path / names[0], "wb") as f:      # truncated
        f.write(raw[: len(raw) // 3])
    with open(tmp_path / names[1], "wb") as f:      # not a zip at all
        f.write(b"garbage" * 50)
    ds = tds.AugmentedShards(str(tmp_path), seed=0)
    for i in range(3):
        got = ds[i]        # every index falls through to the one good shard
        np.testing.assert_array_equal(got["label"], want[2]["label"])
    assert ds.files == good.files


def test_failed_build_raises(monkeypatch):
    """A codec that does not build raises; no reader or writer falls back
    to np.load or zipfile."""
    monkeypatch.setattr(_build, "GXX_FLAGS",
                        _build.GXX_FLAGS + ("-DOFD_NO_SUCH_FLAG", "-Werror",
                                            "--no-such-option"))
    with pytest.raises(RuntimeError, match="failed for csrc/shardio.cc"):
        _build.build(["shardio"])

    def no_codec():
        raise RuntimeError("the codec did not build")

    monkeypatch.setattr(native_io, "_lib", no_codec)
    assert not native_io.available()
    with pytest.raises(RuntimeError, match="did not build"):
        native_io.load_npz("x.npz")
    with pytest.raises(RuntimeError, match="did not build"):
        twriter.ShardWriter("out")
