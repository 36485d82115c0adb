"""The port's forward warp on the CPU against the JAX package's.

``forward_warp_plain`` (what ``forward_warp`` runs on a CPU tensor) must
equal JAX's ``forward_warp`` bit for bit: the output is a gather of the
input, so there is no tolerance. The cases are those of
``tests/test_forward_warp.py`` (the serial numpy oracle of the reference's
raster scan, ties, zero flow, the permutation, flip against the generic
warp), plus the edges the card's kernel is held to in ``chip_smoke.py``
[3h]: a rotation about an off-image pivot, every pixel onto 4 targets,
-0.0 against +0.0, depths >= 1000, batches; and ``concat_flow`` and
``back_flow``. Then the kernel's host side: ``plan``, and the variants
of the kernel that ``tools/warp_variants.py`` builds.
"""

import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.core.special_flow import flip_flow as jflip_flow
from opticalflowfromdepth_tpu.ops import forward_warp as jfw
from opticalflowfromdepth_torch.core.special_flow import flip_flow
from opticalflowfromdepth_torch.ops import forward_warp as tfw

torch.set_num_threads(2)


def np_forward_warp(obj, flow, depth):
    """The reference's serial raster scan (`fw_cuda_kernel.cu:25-49`)."""
    c, h, w = obj.shape
    out = np.zeros_like(obj)
    dlut = np.full((h, w), 1000.0, np.float32)
    valid = np.zeros((1, h, w), np.float32)
    collision = np.zeros((1, h, w), np.float32)
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    px = np.clip(gx + flow[0], 0, w - 1).astype(np.int64)
    py = np.clip(gy + flow[1], 0, h - 1).astype(np.int64)
    for j in range(h):
        for i in range(w):
            x, y = px[j, i], py[j, i]
            if depth[0, j, i] < dlut[y, x]:
                out[:, y, x] = obj[:, j, i]
                dlut[y, x] = depth[0, j, i]
            valid[0, y, x] = 1
            collision[0, y, x] = 0.0 if dlut[y, x] != 1000.0 else 1.0
    return out, valid, collision


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _assert_same_bits(got, want):
    for g, w, name in zip(got, want, ("out", "valid", "collision")):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == np.asarray(w).shape, name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


def _both(obj, flow, depth):
    """(the port's plain warp, JAX's warp) of one [C, H, W] case."""
    got = tfw.forward_warp(*(torch.from_numpy(np.ascontiguousarray(a))
                             for a in (obj, flow, depth)))
    want = jfw.forward_warp(jnp.asarray(obj), jnp.asarray(flow),
                            jnp.asarray(depth))
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jax_and_the_oracle(seed):
    rng = np.random.default_rng(seed)
    h, w, c = 13, 19, 4
    obj = rng.normal(size=(c, h, w)).astype(np.float32)
    flow = rng.uniform(-6, 6, size=(2, h, w)).astype(np.float32)
    depth = rng.uniform(1, 100, size=(1, h, w)).astype(np.float32)
    got, want = _both(obj, flow, depth)
    _assert_same_bits(got, want)
    _assert_same_bits(got, np_forward_warp(obj, flow, depth))


def test_ties_break_by_raster_order():
    """Constant depth, integer flows: the first writer in raster order
    wins (the oracle's strict <)."""
    rng = np.random.default_rng(3)
    h, w, c = 9, 11, 2
    obj = rng.normal(size=(c, h, w)).astype(np.float32)
    flow = rng.integers(-4, 5, size=(2, h, w)).astype(np.float32)
    depth = np.full((1, h, w), 7.0, np.float32)
    got, want = _both(obj, flow, depth)
    _assert_same_bits(got, want)
    _assert_same_bits(got, np_forward_warp(obj, flow, depth))


def test_zero_flow_is_identity():
    rng = np.random.default_rng(4)
    obj = rng.normal(size=(3, 8, 8)).astype(np.float32)
    depth = rng.uniform(1, 99, size=(1, 8, 8)).astype(np.float32)
    got, want = _both(obj, np.zeros((2, 8, 8), np.float32), depth)
    _assert_same_bits(got, want)
    np.testing.assert_array_equal(got[0].numpy(), obj)
    assert got[1].min() == 1 and got[2].max() == 0


def test_integer_translation_is_a_permutation():
    obj = np.arange(5 * 6, dtype=np.float32).reshape(1, 5, 6)
    flow = np.zeros((2, 5, 6), np.float32)
    flow[0] = 2.0
    depth = np.full((1, 5, 6), 3.0, np.float32)
    got, want = _both(obj, flow, depth)
    _assert_same_bits(got, want)
    np.testing.assert_array_equal(got[0][0, :, 2:].numpy(), obj[0, :, :4])
    assert got[1][0, :, 2:].min() == 1 and got[1][0, :, :2].max() == 0


def _rotation_flow(h, w, cx, cy, deg):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    t = math.radians(deg)
    x1 = (xx - cx) * math.cos(t) - (yy - cy) * math.sin(t) + cx
    y1 = (xx - cx) * math.sin(t) + (yy - cy) * math.cos(t) + cy
    return np.stack([x1 - xx, y1 - yy]).astype(np.float32)


@pytest.mark.parametrize("case", ["rotation off the image", "four targets",
                                  "signed zeros", "collisions",
                                  "constant depth"])
def test_edge_cases_match_jax(case):
    """The edges of ``chip_smoke.py`` [3h]: a rotation about a pivot off
    the image (whole regions clamp onto the border), every pixel onto 4
    targets, -0.0 against +0.0 depths, depths >= 1000 (collisions, no
    writes), constant depth (raster-order ties everywhere)."""
    rng = np.random.default_rng(7)
    h, w, c = 33, 17, 6
    obj = rng.normal(size=(c, h, w)).astype(np.float32)
    depth = rng.uniform(1, 100, size=(1, h, w)).astype(np.float32)
    flow = rng.uniform(-20, 20, size=(2, h, w)).astype(np.float32)
    if case == "rotation off the image":
        flow = _rotation_flow(h, w, 1.9 * w, -0.7 * h, 25.0)
    elif case == "four targets":
        yy, xx = np.mgrid[0:h, 0:w]
        flow = np.stack([(xx % 2) * (w // 2) - xx, (yy % 2) * (h // 2) - yy]
                        ).astype(np.float32)
    elif case == "signed zeros":
        depth = np.where(rng.uniform(size=depth.shape) < 0.5, -0.0,
                         0.0).astype(np.float32)
        flow = np.round(flow / 5)
    elif case == "collisions":
        depth[rng.uniform(size=depth.shape) < 0.4] = 1000.0
        depth[rng.uniform(size=depth.shape) < 0.1] = 5000.0
    else:
        depth[:] = 42.0
    got, want = _both(obj, flow, depth)
    _assert_same_bits(got, want)
    if case != "signed zeros":
        # the oracle's float < has -0.0 == +0.0; the JAX key, and so the
        # port's, orders -0.0 first
        _assert_same_bits(got, np_forward_warp(obj, flow, depth))
    if case == "four targets":
        assert int(got[1].sum()) == 4
    if case == "collisions":
        assert got[2].sum() > 0


def test_batch_entries_are_independent():
    """[B, C, H, W]: each entry is the JAX warp of that entry alone."""
    rng = np.random.default_rng(8)
    b, c, h, w = 3, 5, 12, 10
    obj = rng.normal(size=(b, c, h, w)).astype(np.float32)
    flow = rng.uniform(-5, 5, size=(b, 2, h, w)).astype(np.float32)
    depth = rng.uniform(1, 100, size=(b, 1, h, w)).astype(np.float32)
    depth[1] = 3.0
    got = tfw.forward_warp(torch.from_numpy(obj), torch.from_numpy(flow),
                           torch.from_numpy(depth))
    for i in range(b):
        want = jfw.forward_warp(jnp.asarray(obj[i]), jnp.asarray(flow[i]),
                                jnp.asarray(depth[i]))
        _assert_same_bits([t[i] for t in got], want)


@pytest.mark.parametrize("horizontal", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_flip_is_the_generic_warp_and_jaxs(horizontal, seed):
    rng = np.random.default_rng(seed)
    h, w, c = 11, 17, 5
    obj = rng.normal(size=(c, h, w)).astype(np.float32)
    depth = rng.uniform(1, 100, size=(1, h, w)).astype(np.float32)
    depth[0, rng.integers(0, h, 7), rng.integers(0, w, 7)] = 1000.0
    sf, _ = flip_flow(h, w, horizontal=horizontal)
    jsf, _ = jflip_flow(h, w, horizontal=horizontal)
    np.testing.assert_array_equal(sf.numpy(), np.asarray(jsf))
    t_obj, t_depth = torch.from_numpy(obj), torch.from_numpy(depth)
    got = tfw.forward_warp_flip(t_obj, t_depth, horizontal=horizontal)
    _assert_same_bits(got, tfw.forward_warp(t_obj, sf, t_depth))
    _assert_same_bits(got, jfw.forward_warp_flip(
        jnp.asarray(obj), jnp.asarray(depth), horizontal=horizontal))


@pytest.mark.parametrize("seed", [5, 6])
def test_concat_and_back_flow_match_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = 10, 12
    f_ab = rng.uniform(-3, 3, size=(2, h, w)).astype(np.float32)
    f_bc = rng.uniform(-3, 3, size=(2, h, w)).astype(np.float32)
    bf_ab = -f_ab
    depth = rng.uniform(1, 99, size=(1, h, w)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (f_ab, bf_ab, f_bc, depth)]
    j = [jnp.asarray(a) for a in (f_ab, bf_ab, f_bc, depth)]
    got = tfw.concat_flow(*t)
    want = jfw.concat_flow(*j)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w_))
    got = tfw.back_flow(t[0], t[3])
    want = jfw.back_flow(j[0], j[3])
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w_))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(9)
    obj = torch.from_numpy(rng.normal(size=(1, 2, 6, 7)).astype(np.float32))
    flow = torch.zeros(1, 2, 6, 7)
    depth = torch.ones(1, 1, 6, 7)
    before = tfw.forward_warp.launches
    tfw.forward_warp(obj, flow, depth)
    assert tfw.forward_warp.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfw._forward_warp_cuda(obj, flow, depth)


# --------------------------------------------------------------------------
# the kernel's host-side plan and its warp grouping (the kernel itself runs
# only on the card: tests/test_torch_cuda.py)
# --------------------------------------------------------------------------

def _csrc_constant(name):
    src = (pathlib.Path(tfw.__file__).resolve().parent.parent / "csrc"
           / "forward_warp.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_plan_constants_are_the_kernels():
    assert _csrc_constant("kThreads") == tfw.THREADS
    assert _csrc_constant("kVec") == tfw.VEC
    assert _csrc_constant("kBlocksPerSm") == tfw.BLOCKS_PER_SM


@pytest.mark.parametrize("vec,bps", [(None, None), (1, 6), (4, 2)])
@pytest.mark.parametrize("b,h,w", [(15, 384, 512), (1, 384, 512),
                                   (1, 33, 17), (15, 33, 17), (2, 6, 7),
                                   (1, 1, 1)])
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_plan_keeps_every_block_resident_and_warps_in_step(b, h, w, sms, vec,
                                                           bps):
    """The kernel's constants and two of ``tools/warp_variants.py``'s: at
    most ``bps`` blocks a SM (a cooperative launch must have them all
    resident), a thread a unit of ``vec`` targets until they are reached
    and no block without a unit; the z-test's loop, a pixel a thread a
    step while a warp's first pixel is in range, visits every pixel once,
    and every lane of a warp takes the same number of steps (its shuffles
    name the whole warp)."""
    vec, bps = vec or tfw.VEC, bps or tfw.BLOCKS_PER_SM
    units = -(-b * h * w // vec)
    blocks = tfw.plan(b, h, w, sms, vec, bps)
    if (vec, bps) == (tfw.VEC, tfw.BLOCKS_PER_SM):
        assert blocks == tfw.plan(b, h, w, sms)
    assert 1 <= blocks <= sms * bps
    assert blocks * tfw.THREADS >= min(units, sms * bps * tfw.THREADS)
    assert (blocks - 1) * tfw.THREADS < units
    stride = blocks * tfw.THREADS
    first = np.arange(stride)
    end = -(-b * h * w // 32) * 32
    steps = np.maximum(0, -(-(end - first) // stride))
    assert (steps.reshape(-1, 32) == steps.reshape(-1, 32)[:, :1]).all()
    visited = np.concatenate([np.arange(f, end, stride) for f in first])
    assert np.array_equal(np.sort(visited), np.arange(end))


@pytest.mark.parametrize("name", ["vec1_bps6", "vec4_bps2_p0",
                                  "vec2_bps4_p01", "vec2_bps6_pl4"])
def test_warp_variants_change_only_their_constants_and_cut(name):
    """``tools/warp_variants.py``'s sources: the kernel's with kVec,
    kBlocksPerSm and kPlanes set, and a cut variant returns right after the grid sync
    that ends its last phase."""
    from opticalflowfromdepth_torch.tools import warp_variants as wv
    src = (pathlib.Path(tfw.__file__).resolve().parent.parent / "csrc"
           / "forward_warp.cu").read_text()
    got = wv.variant_source(src, name)
    vec, bps = (int(x) for x in re.findall(r"\d", name)[:2])
    assert re.search(rf"constexpr int kVec = {vec};", got)
    assert re.search(rf"constexpr int kBlocksPerSm = {bps};", got)
    planes = re.search(r"_pl(\d)", name)
    assert re.search(r"constexpr int kPlanes = "
                     + (planes.group(1) if planes
                        else str(_csrc_constant("kPlanes"))) + ";", got)
    cut = re.search(r"_(p0|p01)$", name)
    if not cut:
        assert len(got.splitlines()) == len(src.splitlines())
        return
    phase = got.split("grid.sync();\n    return;\n")
    assert len(phase) == 2 and phase[0].count("grid.sync();") == \
        (1 if cut.group(1) == "p0" else 2) - 1
    assert ("phase 1: the z-test" in phase[0]) == (cut.group(1) == "p01")
