"""The port's ops on the CPU against the JAX package's functions.

Same numpy inputs (from a seed) go through the JAX function (Pallas
kernels in interpret mode) and the port's plain PyTorch version, forward
and backward. The CUDA kernels themselves run only on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``); here their wrappers
must refuse tensors that are not on the CPU.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.models import raft as jraft
from opticalflowfromdepth_tpu.ops import correlation as jcorr
from opticalflowfromdepth_tpu.ops import fused_corr as jfused
from opticalflowfromdepth_tpu.ops import instance_norm as jin
from opticalflowfromdepth_tpu.ops import sampling as jsampling
from opticalflowfromdepth_torch.models import raft as traft
from opticalflowfromdepth_torch.ops import correlation as tcorr
from opticalflowfromdepth_torch.ops import fused_corr as tfused
from opticalflowfromdepth_torch.ops import instance_norm as tin
from opticalflowfromdepth_torch.ops import sampling as tsampling

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _corr_inputs(b=2, h=12, w=16, c=32, seed=0, spread=6.0):
    rng = np.random.default_rng(seed)
    f1 = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    f2 = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx, yy], -1)[None].repeat(b, 0)
    coords = base + rng.uniform(-spread, spread, (b, h, w, 2)).astype(
        np.float32)
    return f1, f2, coords


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# fused correlation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("levels,radius,h,w", [(4, 4, 12, 16), (2, 3, 12, 16),
                                               (4, 4, 6, 9)])
def test_fused_corr_plain_matches_jax(levels, radius, h, w):
    """(6, 9): N = 54 queries, ragged against the JAX block of 64."""
    f1, f2, coords = _corr_inputs(h=h, w=w)
    ref = jfused.fused_corr_lookup(jnp.asarray(f1), jnp.asarray(f2),
                                   jnp.asarray(coords), levels, radius,
                                   jnp.float32, 64, True)
    got = tfused.fused_corr_lookup(_t(f1), _t(f2), _t(coords), levels,
                                   radius, torch.float32)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_fused_corr_far_out_of_range_is_zero():
    f1, f2, coords = _corr_inputs(spread=0.0)
    for shift in (1000.0, -1000.0):
        got = tfused.fused_corr_lookup(_t(f1), _t(f2), _t(coords + shift))
        assert torch.count_nonzero(got) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_levels_cat_matches_jax(dtype):
    f1, f2, _ = _corr_inputs(h=13, w=11)
    ref = jfused.corr_levels_cat(jnp.asarray(f2), 4, jnp.dtype(dtype))
    got = tfused.corr_levels_cat(_t(f2), 4, getattr(torch, dtype))
    assert tuple(got.shape) == ref.shape
    assert tfused.cat_meta(13, 11, 4) == jfused.cat_meta(13, 11, 4)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=1e-6 if dtype == "float32" else 1e-2)


def test_fused_corr_bf16_plain_matches_jax():
    f1, f2, coords = _corr_inputs(seed=4)
    ref = jfused.fused_corr_lookup(jnp.asarray(f1), jnp.asarray(f2),
                                   jnp.asarray(coords), 4, 4,
                                   jnp.bfloat16, 64, True)
    got = tfused.fused_corr_lookup(_t(f1), _t(f2), _t(coords), 4, 4,
                                   torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # the two sides share bf16 inputs and f32 accumulation; they differ
    # only in the last rounding of the bf16 output
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=2e-2, rtol=2e-2)


def _valid_rows(h, w, levels):
    """Indices of the packed rows that hold a real y (not the padding)."""
    rows = []
    for (hl, wl, hp, off) in tfused.cat_meta(h, w, levels):
        for x in range(wl):
            rows.extend(off + x * hp + y for y in range(hl))
    return np.asarray(rows)


@pytest.mark.parametrize("levels,radius,h,w", [(4, 4, 12, 16), (2, 3, 6, 9)])
def test_fused_corr_bwd_plain_matches_jax_kernel(levels, radius, h, w):
    """Against the Pallas backward (interpret mode). The JAX kernel also
    writes gradients into the padded rows of each level, which its caller
    slices off; the window form never touches them, so only the valid
    rows are compared (the port's padded rows are exactly 0)."""
    f1, f2, coords = _corr_inputs(h=h, w=w, seed=5)
    b, c = f1.shape[0], f1.shape[-1]
    k2 = (2 * radius + 1) ** 2
    g = np.random.default_rng(6).normal(
        0, 1, (b, h * w, levels * k2)).astype(np.float32)
    f1f = f1.reshape(b, h * w, c)
    cf = coords.reshape(b, h * w, 2)
    f2cat = jfused.corr_levels_cat(jnp.asarray(f2), levels, jnp.float32)
    ref1, ref2, _ = jfused._cat_bwd(h, w, levels, radius, 64, True,
                                    (jnp.asarray(f1f), f2cat, jnp.asarray(cf)),
                                    jnp.asarray(g))
    got1, got2 = tfused.fused_corr_lookup_cat_bwd_plain(
        _t(g), _t(f1f), _t(np.array(f2cat)), _t(cf), h, w, levels, radius)
    np.testing.assert_allclose(got1.numpy(), np.asarray(ref1), atol=5e-5,
                               rtol=5e-5)
    valid = _valid_rows(h, w, levels)
    np.testing.assert_allclose(got2.numpy()[:, valid],
                               np.asarray(ref2)[:, valid], atol=5e-5,
                               rtol=5e-5)
    pad = np.setdiff1d(np.arange(got2.shape[1]), valid)
    assert pad.size and torch.count_nonzero(got2[:, pad]) == 0


def test_fused_corr_autograd_matches_corr_pyramid_vjp():
    """The lookup's gradients through ``corr_levels_cat`` against
    ``jax.vjp`` of the dense ``CorrPyramid`` (5e-5, as
    ``tests/test_fused_corr.py``)."""
    f1, f2, coords = _corr_inputs(b=2, h=10, w=12, c=16, seed=3)
    g = np.random.default_rng(8).normal(0, 1, (2, 10, 12, 4 * 81)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b: jcorr.CorrPyramid(a, b, 4, 4)(
        jnp.asarray(coords)), jnp.asarray(f1), jnp.asarray(f2))
    ref1, ref2 = vjp(jnp.asarray(g))
    t1, t2 = _t(f1).requires_grad_(), _t(f2).requires_grad_()
    out = tfused.fused_corr_lookup(t1, t2, _t(coords), 4, 4, torch.float32)
    out.backward(_t(g))
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(ref1), atol=5e-5,
                               rtol=5e-5)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(ref2), atol=5e-5,
                               rtol=5e-5)


def test_fused_corr_bwd_far_out_of_range_is_zero():
    f1, f2, coords = _corr_inputs(spread=0.0)
    b, h, w, c = f1.shape
    g = torch.ones(b, h * w, 4 * 81)
    f2cat = tfused.corr_levels_cat(_t(f2), 4, torch.float32)
    for shift in (1e4, -1e4):
        df1, df2 = tfused.fused_corr_lookup_cat_bwd_plain(
            g, _t(f1).reshape(b, h * w, c), f2cat,
            _t(coords + shift).reshape(b, h * w, 2), h, w)
        assert torch.count_nonzero(df1) == 0 and torch.count_nonzero(df2) == 0


def test_fused_corr_wrapper_refuses_non_cpu_tensors():
    """A tensor that is not on the CPU never reaches the plain version."""
    f1 = torch.empty(1, 48, 32, device="meta")
    rows = sum(wl * hp for (_, wl, hp, _) in tfused.cat_meta(6, 8, 4))
    f2cat = torch.empty(1, rows, 32, device="meta")
    coords = torch.empty(1, 48, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_corr_lookup_cat(f1, f2cat, coords, 6, 8, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_corr_lookup_cat_bwd(torch.empty(1, 48, 324,
                                                     device="meta"),
                                         f1, f2cat, coords, 6, 8, 4, 4)
    assert tfused.fused_corr_lookup_cat.launches == 0
    assert tfused.fused_corr_lookup_cat.bwd_launches == 0


# --------------------------------------------------------------------------
# dense pyramid and on-demand lookup
# --------------------------------------------------------------------------

@pytest.mark.parametrize("levels,radius", [(4, 4), (2, 3)])
def test_corr_pyramid_matches_jax(levels, radius):
    f1, f2, coords = _corr_inputs(seed=1)
    ref = jcorr.CorrPyramid(jnp.asarray(f1), jnp.asarray(f2), levels,
                            radius)(jnp.asarray(coords))
    got = tcorr.CorrPyramid(_t(f1), _t(f2), levels, radius)(_t(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("levels,radius", [(4, 4), (2, 3)])
def test_on_demand_corr_matches_jax(levels, radius):
    f1, f2, coords = _corr_inputs(seed=2)
    ref = jcorr.on_demand_corr(jnp.asarray(f1), jnp.asarray(f2),
                               jnp.asarray(coords), levels, radius)
    got = tcorr.on_demand_corr(_t(f1), _t(f2), _t(coords), levels, radius)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_window_delta_is_x_major():
    np.testing.assert_array_equal(tcorr._window_delta(3).numpy(),
                                  np.asarray(jcorr._window_delta(3)))


# --------------------------------------------------------------------------
# instance norm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(2, 12, 10, 64), (1, 7, 9, 96)])
def test_instance_norm_plain_matches_jax(shape, relu):
    """H*W = 120 and 63: neither is a multiple of the JAX block of 64."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 3, shape).astype(np.float32)
    got = tin.instance_norm(_t(x.transpose(0, 3, 1, 2)), 1e-5, relu)
    got = [t.numpy().transpose(0, 2, 3, 1) for t in got]
    for ref in (jin._instance_norm_fwd_pallas(jnp.asarray(x), 1e-5, relu,
                                              block=64, interpret=True),
                jin._instance_norm_xla(jnp.asarray(x), 1e-5, relu)):
        for g, r, what in zip(got, ref, ("y", "mean", "rstd")):
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-5,
                                       atol=1e-5, err_msg=what)


def test_instance_norm_bf16_normalizes_in_f32():
    """bf16 in, bf16 out; the value is the f32 normalization rounded once,
    as the Pallas kernel does (so within one bf16 ulp, 2^-8 relative)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 2, (2, 64, 5, 7)).astype(np.float32)
                         ).to(torch.bfloat16)
    y, mean, rstd = tin.instance_norm(x, 1e-5, True)
    assert y.dtype == torch.bfloat16 and mean.dtype == torch.float32
    ref = torch.relu((x.float() - mean) * rstd)
    np.testing.assert_allclose(y.float().numpy(), ref.numpy(),
                               rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_grad_matches_jax_in_bwd(relu):
    """The autograd backward against the JAX package's ``_in_bwd``."""
    rng = np.random.default_rng(2)
    x = rng.normal(0.5, 3, (2, 9, 7, 24)).astype(np.float32)   # NHWC
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    _, res = jin._in_fwd(jnp.asarray(x), 1e-5, relu)
    (ref,) = jin._in_bwd(1e-5, relu, res, jnp.asarray(g))
    xt = _t(x.transpose(0, 3, 1, 2)).requires_grad_()
    y, _, _ = tin.instance_norm(xt, 1e-5, relu)
    y.backward(_t(g.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_instance_norm_refuses_non_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tin.instance_norm(torch.empty(1, 8, 4, 4, device="meta"))
    assert tin.instance_norm.launches == 0


# --------------------------------------------------------------------------
# RAFT helpers
# --------------------------------------------------------------------------

def test_resize_and_upflow8_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 4, (2, 5, 7, 2)).astype(np.float32)
    ref = jsampling.resize_bilinear_align_corners(jnp.asarray(x), 13, 9)
    got = tsampling.resize_bilinear_align_corners(_t(x), 13, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    ref = jraft.upflow8(jnp.asarray(x))
    got = traft.upflow8(_t(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), atol=1e-4)


def test_convex_upsample_and_coords_grid_match_jax():
    rng = np.random.default_rng(4)
    flow = rng.normal(0, 3, (2, 5, 6, 2)).astype(np.float32)
    mask = rng.normal(0, 1, (2, 5, 6, 576)).astype(np.float32)
    ref = jraft.convex_upsample(jnp.asarray(flow), jnp.asarray(mask))
    got = traft.convex_upsample(_t(flow.transpose(0, 3, 1, 2)),
                                _t(mask.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), atol=1e-5)
    np.testing.assert_array_equal(
        traft.coords_grid(2, 3, 4).numpy().transpose(0, 2, 3, 1),
        np.asarray(jraft.coords_grid(2, 3, 4)))


def test_unblock_pixels_matches_jax():
    x = np.arange(2 * 3 * 4 * 16 * 5, dtype=np.float32).reshape(2, 3, 4, 16,
                                                                 5)
    ref = jraft.unblock_pixels(jnp.asarray(x), 4)            # NHWC
    got = traft.unblock_pixels(_t(x.transpose(0, 3, 4, 1, 2)), 4)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(ref))


# --------------------------------------------------------------------------
# the port imports no JAX
# --------------------------------------------------------------------------

def test_port_imports_no_jax():
    files = sorted((REPO / "opticalflowfromdepth_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    banned = ("jax", "flax", "opticalflowfromdepth_tpu")
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{f.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] in banned]
    assert len(files) > 15 and not bad, bad
    scanned = {str(f.relative_to(REPO)) for f in files}
    synthesis = [f"opticalflowfromdepth_torch/{m}.py" for m in (
        "core/geometry", "core/rng", "core/camera", "core/convert",
        "core/depth_utils", "core/special_flow", "ops/forward_warp",
        "ops/inpaint", "synth/pipeline", "synth/writer", "synth/cli",
        "data/source", "data/frame_io")]
    assert set(synthesis) <= scanned, set(synthesis) - scanned


# --------------------------------------------------------------------------
# the kernels' build cache
# --------------------------------------------------------------------------

def test_build_cache_key_covers_the_headers(tmp_path, monkeypatch):
    """A library is named by the hash of its source, every shared header
    ``csrc/*.cuh`` and the flags: editing a header (or adding one) names
    another library, so a stale build never loads."""
    from opticalflowfromdepth_torch import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("#define A 1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src, first = _build._paths("k")
    assert src == tmp_path / "k.cu" and first.name.startswith("k-")
    assert _build._paths("k")[1] == first
    (tmp_path / "h.cuh").write_text("#define A 2\n")
    second = _build._paths("k")[1]
    (tmp_path / "other.cuh").write_text("\n")
    third = _build._paths("k")[1]
    assert len({first, second, third}) == 3
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._paths("k")[1] not in {first, second, third}
