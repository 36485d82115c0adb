"""The lookup backward's arithmetic (``ops/fused_corr.py``) on the CPU
against the JAX package's Pallas kernel.

The card's kernel forms the dense ``d_corr`` and takes its two products,
as the TPU kernel does. Its tensor-core route (bf16 at C = 128 or 256)
splits ``d_corr`` into bf16 hi + lo and sums both products in f32 tile by
tile; ``fused_corr_lookup_cat_bwd_plain`` repeats that arithmetic, and
here it is held against ``_cat_bwd`` (interpret mode) on bf16 features,
within the tolerance that ``chip_smoke.py`` [3c] holds the kernel to
(``1e-3 + 2^-7 |ref|``), on shapes whose coarsest level every query's
window covers (each of its rows sums over every query). A single bf16
rounding of ``d_corr`` fails that tolerance: the split is there for it.
Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.ops import fused_corr as jfused
from opticalflowfromdepth_torch.ops import fused_corr as tfused

torch.set_num_threads(2)

RTOL, ATOL = 2 ** -7, 1e-3      # chip_smoke.py [3c], bf16


def _inputs(b, h, w, c, seed, spread, levels=4, radius=4):
    """bf16 f1 [B, N, C], f2cat, f32 coords and a bf16 cotangent, as numpy
    float32 arrays holding bf16 values."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    f1 = bf(rng.normal(size=(b, h * w, c)))
    f2 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    f2cat = np.asarray(jfused.corr_levels_cat(jnp.asarray(f2), levels,
                                              jnp.bfloat16), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx, yy], -1).reshape(1, h * w, 2).repeat(b, 0)
    coords = base + rng.uniform(-spread, spread, base.shape).astype(
        np.float32)
    k2 = (2 * radius + 1) ** 2
    g = bf(rng.normal(size=(b, h * w, levels * k2)))
    return f1, f2cat, coords, g


def _valid_rows(h, w, levels):
    rows = []
    for (hl, wl, hp, off) in tfused.cat_meta(h, w, levels):
        for x in range(wl):
            rows.extend(off + x * hp + y for y in range(hl))
    return np.asarray(rows)


def _jax_bwd(f1, f2cat, coords, g, h, w, levels=4, radius=4):
    """JAX's Pallas backward in interpret mode on the bf16 operands."""
    df1, df2, _ = jfused._cat_bwd(
        h, w, levels, radius, 64, True,
        (jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2cat, jnp.bfloat16),
         jnp.asarray(coords)), jnp.asarray(g, jnp.bfloat16))
    return np.asarray(df1, np.float32), np.asarray(df2, np.float32)


def _ours(f1, f2cat, coords, g, h, w, rounding):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    df1, df2 = tfused.fused_corr_lookup_cat_bwd_plain(
        t(g).bfloat16(), t(f1).bfloat16(), t(f2cat).bfloat16(), t(coords),
        h, w, d_corr_rounding=rounding)
    assert df1.dtype == df2.dtype == torch.bfloat16
    return df1.float().numpy(), df2.float().numpy()


def _excess(got, ref):
    return float((np.abs(got - ref) / (ATOL + RTOL * np.abs(ref))).max())


# (b, h, w, c, spread): the coarsest level (h/8 x w/8) lies inside every
# query's 10 x 10 window of it, so each of its rows sums over all queries
SHAPES = {"c256_16x24": (2, 16, 24, 256, 6.0),
          "c128_24x32": (1, 24, 32, 128, 8.0)}


@pytest.fixture(scope="module", params=sorted(SHAPES))
def case(request):
    b, h, w, c, spread = SHAPES[request.param]
    f1, f2cat, coords, g = _inputs(b, h, w, c, 3, spread)
    return (h, w, (f1, f2cat, coords, g), _jax_bwd(f1, f2cat, coords, g, h,
                                                    w))


def test_hi_lo_split_matches_jax_kernel(case):
    """The tensor-core route's arithmetic (what the default "route" takes
    at these widths) within [3c]'s bf16 tolerance of the Pallas kernel,
    valid rows; the padded rows exactly 0."""
    h, w, args, (ref1, ref2) = case
    got1, got2 = _ours(*args, h, w, "route")
    split1, split2 = _ours(*args, h, w, "hi_lo")
    np.testing.assert_array_equal(got1, split1)
    np.testing.assert_array_equal(got2, split2)
    valid = _valid_rows(h, w, 4)
    assert _excess(got1, ref1) <= 1.0
    assert _excess(got2[:, valid], ref2[:, valid]) <= 1.0
    pad = np.setdiff1d(np.arange(got2.shape[1]), valid)
    assert pad.size and not np.any(got2[:, pad])


def test_single_bf16_rounding_of_d_corr_fails_the_tolerance(case):
    """Rounding ``d_corr`` to bf16 once, with the same f32 sums, leaves
    both gradients outside the tolerance that the split meets."""
    h, w, args, (ref1, ref2) = case
    got1, got2 = _ours(*args, h, w, "bf16")
    valid = _valid_rows(h, w, 4)
    assert _excess(got1, ref1) > 1.0
    assert _excess(got2[:, valid], ref2[:, valid]) > 1.0


def test_f32_d_corr_matches_jax_kernel(case):
    """The CUDA-core route's arithmetic (``d_corr`` in f32, one product
    each) within the same tolerance."""
    h, w, args, (ref1, ref2) = case
    got1, got2 = _ours(*args, h, w, "none")
    valid = _valid_rows(h, w, 4)
    assert _excess(got1, ref1) <= 1.0
    assert _excess(got2[:, valid], ref2[:, valid]) <= 1.0


@pytest.mark.parametrize("dtype,c,route", [
    (torch.bfloat16, 256, "tensor_cores"), (torch.bfloat16, 128,
                                            "tensor_cores"),
    (torch.bfloat16, 64, "cuda_cores"), (torch.float32, 256, "cuda_cores")])
def test_route_follows_dtype_and_width(dtype, c, route):
    """The plain version's default repeats the route the kernel takes."""
    assert tfused.route(dtype, c) == route
    f1, f2cat, coords, g = _inputs(1, 6, 8, c, 4, 3.0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    args = (t(g), t(f1), t(f2cat), torch.from_numpy(coords), 6, 8)
    got = tfused.fused_corr_lookup_cat_bwd_plain(*args)
    want = tfused.fused_corr_lookup_cat_bwd_plain(
        *args, d_corr_rounding="hi_lo" if route == "tensor_cores" else "none")
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("h,w,levels", [(46, 62, 4), (7, 9, 4), (6, 9, 4),
                                        (1, 3, 4), (20, 2, 3)])
def test_level_tiles_cover_each_row_once_within_a_level(h, w, levels):
    """The kernels' row tiles: 64 rows at most, none across a level's end,
    every packed row in exactly one; levels pooled to nothing (1x3 and
    20x2 pool to 0 rows) give none."""
    meta = tfused.cat_meta(h, w, levels)
    rows = sum(wl * hp for (_, wl, hp, _) in meta)
    covered = np.zeros(rows, int)
    levels_of = [(off, off + wl * hp) for (hl, wl, hp, off) in meta
                 if hl and wl]
    for r0, n in tfused.level_tiles(meta):
        assert 0 < n <= tfused.KERNEL_TILE
        start, end = next(lv for lv in levels_of if lv[0] <= r0 < lv[1])
        assert (r0 - start) % tfused.KERNEL_TILE == 0 and r0 + n <= end
        covered[r0:r0 + n] += 1
    assert np.all(covered == 1)


def test_level_pooled_to_nothing_gives_zero_and_matches_jax():
    """A 7x9 map has no level 3 (7 >> 3 == 0): its lookups are 0 and the
    backward of the other levels holds against the Pallas kernel."""
    h, w = 7, 9
    assert tfused.cat_meta(h, w, 4)[3][:2] == (0, 1)
    f1, f2cat, coords, g = _inputs(1, h, w, 256, 6, 3.0)
    ref1, ref2 = _jax_bwd(f1, f2cat, coords, g, h, w)
    got1, got2 = _ours(f1, f2cat, coords, g, h, w, "route")
    valid = _valid_rows(h, w, 4)
    assert _excess(got1, ref1) <= 1.0
    assert _excess(got2[:, valid], ref2[:, valid]) <= 1.0
