"""The lookup's whole operand surface (``ops/fused_corr.py``) on the CPU
against the JAX package's Pallas kernels in interpret mode.

The JAX function takes any C, radius and level count; so do the port's
kernels (``csrc/fused_corr.cu``: C in 256-column chunks with a scalar tail,
the taps in blocks, a level table that holds every map's non-empty
levels), and their plain versions, which ``chip_smoke.py`` [3l] holds the
kernels to, are held here against ``_cat_fwd`` / ``_cat_bwd``: C in {4,
520, 1024} at radius 0 and 5 with 9 levels on a map whose last levels
pool to nothing, and an ``f2cat`` of zero rows. The forward in f32 within
2e-5, the backward on bf16 operands within ``test_torch_corr_bwd.py``'s
tolerance. Then :func:`route` on every class. Inputs come from numpy
seeds.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.ops import fused_corr as jfused
from opticalflowfromdepth_torch.ops import fused_corr as tfused
from test_torch_corr_bwd import _excess

torch.set_num_threads(2)
B, H, W, LEVELS = 2, 9, 13, 9     # 4 non-empty levels: 9x13, 4x6, 2x3, 1x1


def _inputs(c, radius, seed, h=H, w=W, levels=LEVELS, dtype=np.float32):
    """f1 [B, N, C], the packed f2cat, coordinates around the grid (+- 6
    px) and a cotangent, as numpy arrays holding ``dtype``'s values."""
    rng = np.random.default_rng(seed)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    cast = lambda a: np.asarray(jnp.asarray(a, jd), np.float32)
    n = max(h * w, 6)
    f1 = cast(rng.normal(size=(B, n, c)))
    f2 = rng.normal(size=(B, h, w, c)).astype(np.float32)
    f2cat = np.asarray(jfused.corr_levels_cat(jnp.asarray(f2), levels, jd),
                       np.float32)
    yy, xx = np.divmod(np.arange(n), max(w, 1))
    base = np.stack([xx, yy], -1).astype(np.float32)[None].repeat(B, 0)
    coords = base + rng.uniform(-6, 6, base.shape).astype(np.float32)
    g = cast(rng.normal(size=(B, n, levels * (2 * radius + 1) ** 2)))
    return f1, f2cat, coords, g


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


CLASSES = [(c, r) for c in (4, 520, 1024) for r in (0, 5)]


@pytest.mark.parametrize("c,radius", CLASSES)
def test_plain_lookup_matches_jax(c, radius):
    f1, f2cat, coords, _ = _inputs(c, radius, seed=c + radius)
    meta = tfused.cat_meta(H, W, LEVELS)
    assert tfused.live_levels(meta) == 4 and meta[4][:2] == (0, 0)
    ref = np.asarray(jfused.fused_corr_lookup_cat(
        jnp.asarray(f1), jnp.asarray(f2cat), jnp.asarray(coords), H, W,
        LEVELS, radius, 256, True))
    got = tfused.fused_corr_lookup_cat(_t(f1), _t(f2cat), _t(coords), H, W,
                                       LEVELS, radius)
    k2 = (2 * radius + 1) ** 2
    assert got.shape == (B, H * W, LEVELS * k2)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)
    assert not np.any(got.numpy()[..., 4 * k2:])      # the pooled levels


@pytest.mark.parametrize("c,radius", CLASSES)
def test_plain_lookup_backward_matches_jax(c, radius):
    f1, f2cat, coords, g = _inputs(c, radius, seed=7 * c + radius,
                                   dtype="bf16")
    df1, df2, _ = jfused._cat_bwd(
        H, W, LEVELS, radius, 64, True,
        (jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2cat, jnp.bfloat16),
         jnp.asarray(coords)), jnp.asarray(g, jnp.bfloat16))
    bf = torch.bfloat16
    got1, got2 = tfused.fused_corr_lookup_cat_bwd(
        _t(g, bf), _t(f1, bf), _t(f2cat, bf), _t(coords), H, W, LEVELS,
        radius)
    assert got1.dtype == got2.dtype == bf
    valid = [off + x * hp + y for (hl, wl, hp, off)
             in tfused.cat_meta(H, W, LEVELS) for x in range(wl)
             for y in range(hl)]
    assert _excess(got1.float().numpy(), np.asarray(df1, np.float32)) <= 1.0
    assert _excess(got2.float().numpy()[:, valid],
                   np.asarray(df2, np.float32)[:, valid]) <= 1.0
    pad = sorted(set(range(f2cat.shape[1])) - set(valid))
    assert pad and not torch.count_nonzero(got2[:, pad])


def test_zero_rows_give_zeros_as_jax():
    """A map pooled away at every level (h2 = 0): ``f2cat`` has no rows,
    the lookups and the features' gradient are 0."""
    f1, f2cat, coords, g = _inputs(8, 2, seed=1, h=0, w=5, levels=3)
    assert f2cat.shape == (B, 0, 8)
    ref = np.asarray(jfused.fused_corr_lookup_cat(
        jnp.asarray(f1), jnp.asarray(f2cat), jnp.asarray(coords), 0, 5, 3,
        2, 256, True))
    got = tfused.fused_corr_lookup_cat(_t(f1), _t(f2cat), _t(coords), 0, 5,
                                       3, 2)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.shape == (B, 6, 75) and not torch.count_nonzero(got)
    df1, df2, _ = jfused._cat_bwd(0, 5, 3, 2, 64, True,
                                  (jnp.asarray(f1), jnp.asarray(f2cat),
                                   jnp.asarray(coords)), jnp.asarray(g))
    got1, got2 = tfused.fused_corr_lookup_cat_bwd(
        _t(g), _t(f1), _t(f2cat), _t(coords), 0, 5, 3, 2)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(df1))
    assert got2.shape == (B, 0, 8) and np.asarray(df2).shape == (B, 0, 8)


@pytest.mark.parametrize("dtype,c,radius,levels,route", [
    (torch.bfloat16, 256, 4, 4, "tensor_cores"),
    (torch.bfloat16, 128, 3, 4, "tensor_cores"),
    (torch.bfloat16, 256, 0, 4, "tensor_cores"),
    (torch.bfloat16, 256, 4, 9, "tensor_cores"),
    (torch.bfloat16, 256, 5, 4, "cuda_cores"),
    (torch.bfloat16, 256, 6, 4, "cuda_cores"),
    (torch.bfloat16, 256, 4, 0, "cuda_cores"),
    (torch.bfloat16, 4, 4, 4, "cuda_cores"),
    (torch.bfloat16, 36, 4, 4, "cuda_cores"),
    (torch.bfloat16, 520, 4, 4, "cuda_cores"),
    (torch.bfloat16, 1024, 4, 4, "cuda_cores"),
    (torch.float32, 256, 4, 4, "cuda_cores"),
    (torch.float32, 128, 0, 9, "cuda_cores")])
def test_route_names_the_kernel(dtype, c, radius, levels, route):
    """bf16 at C = 128 or 256 with radius <= 4 and a non-empty level takes
    the tensor cores, everything else the CUDA cores; the plain backward's
    default repeats the route's arithmetic."""
    assert tfused.route(dtype, c, radius, levels) == route
    if levels == 0:
        return
    f1, f2cat, coords, g = _inputs(c, radius, seed=3, h=6, w=8, levels=4,
                                   dtype="bf16")
    args = (_t(g, dtype), _t(f1, dtype), _t(f2cat, dtype), _t(coords), 6, 8,
            4, radius)
    got = tfused.fused_corr_lookup_cat_bwd_plain(*args)
    want = tfused.fused_corr_lookup_cat_bwd_plain(
        *args, d_corr_rounding="hi_lo" if route == "tensor_cores" else "none")
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("h,w,levels,live", [(270, 480, 9, 9),
                                             (46, 62, 12, 6), (9, 13, 9, 4),
                                             (0, 5, 3, 0), (1, 2 ** 30, 40, 1),
                                             (2 ** 31 - 1, 2 ** 31 - 1, 40,
                                              31)])
def test_level_table_holds_every_non_empty_level(h, w, levels, live):
    """The non-empty levels are a prefix of the table (level l of an h-row
    map has h >> l rows), and no map has more of them than the kernels'
    level table (``MAX_LEVELS`` of the ``.cu``) holds."""
    meta = tfused.cat_meta(h, w, levels)
    assert tfused.live_levels(meta) == live
    assert all(hl > 0 and wl > 0 for (hl, wl, _, _) in meta[:live])
    assert all(hl == 0 or wl == 0 for (hl, wl, _, _) in meta[live:])
    src = (pathlib.Path(tfused.__file__).parent.parent / "csrc"
           / "fused_corr.cu").read_text()
    table = int(re.search(r"#define MAX_LEVELS (\d+)", src).group(1))
    assert live <= 31 < table
