"""The lookup forward's tile plan and arithmetic on the CPU
(``ops/fused_corr.py``).

On the tensor cores (bf16, C = 128 or 256) the card's kernel takes 8x8
query tiles of the query image; per tile and level it reads the box of
rows its windows cover once, and the queries whose windows overflow the
box take a per-query path. :func:`tile_plan` repeats the kernel's plan.
Here every query must lie in exactly one tile, the plan's box test
(``fast``: the window clipped to the level lies inside the box) must agree
with a brute-force enumeration of every query's in-level taps, and
``fused_corr_lookup_cat_plain`` (the oracle the card holds the kernel to,
``chip_smoke.py`` [3a]) must match the JAX package's Pallas kernel in
interpret mode on smooth coordinates and on coordinates whose windows
overflow a tile's box. Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.ops import fused_corr as jfused
from opticalflowfromdepth_torch.ops import fused_corr as tfused

torch.set_num_threads(2)


def _coords(b, h, w, kind, seed):
    """Level-0 centres ``[B, h*w, 2]``: the grid plus i.i.d. +- ``kind``
    px, or a smooth flow (a coarse 3x4 field of +- 20 px upsampled
    bilinearly, the columns right of 0.55 w moved 10 px further)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx, yy], -1)[None].repeat(b, 0)
    if kind == "smooth":
        coarse = torch.from_numpy(rng.uniform(-20, 20, (b, 2, 3, 4)).astype(
            np.float32))
        flow = torch.nn.functional.interpolate(
            coarse, size=(h, w), mode="bilinear", align_corners=True)
        flow[:, 0, :, int(0.55 * w):] += 10.0
        off = flow.permute(0, 2, 3, 1).numpy()
    else:
        off = rng.uniform(-kind, kind, (b, h, w, 2)).astype(np.float32)
    return (base + off).reshape(b, h * w, 2)


@pytest.mark.parametrize("n,h2,w2", [(46 * 62, 46, 62), (13 * 21, 13, 21),
                                     (63, 7, 9), (100, 5, 7), (1, 1, 1)])
def test_query_tiles_cover_every_query_once(n, h2, w2):
    """(100, 5, 7): the queries are not the map's pixels, so the tiles are
    runs of 64 (an image one tile wide)."""
    wq = tfused.query_width(n, h2, w2)
    assert wq == (w2 if n == h2 * w2 else tfused.QUERY_TILE)
    q = tfused.query_tiles(n, wq)
    assert q.shape[1] == tfused.QUERY_TILE ** 2
    got = np.sort(q[q >= 0].numpy())
    np.testing.assert_array_equal(got, np.arange(n))
    # a tile is square in the query image: its queries lie within 8 rows
    # and 8 columns
    for row in q:
        row = row[row >= 0]
        if len(row):
            assert int((row // wq).max() - (row // wq).min()) < 8
            assert int((row % wq).max() - (row % wq).min()) < 8


def _brute_force(coords, h2, w2, levels, radius):
    """Per level, per query: the set of its window's in-level taps."""
    k1 = 2 * radius + 2
    out = []
    for li, (hl, wl, _hp, _off) in enumerate(
            tfused.cat_meta(h2, w2, levels)):
        taps = []
        for bq in coords.reshape(-1, 2).tolist():
            if hl == 0 or wl == 0:
                taps.append(set())
                continue
            s = 1.0 / 2 ** li
            x0 = np.floor(np.float32(bq[0]) * np.float32(s))
            y0 = np.floor(np.float32(bq[1]) * np.float32(s))
            ix0 = int(min(max(x0, -radius - 2), wl + radius)) - radius
            iy0 = int(min(max(y0, -radius - 2), hl + radius)) - radius
            taps.append({(x, y) for x in range(ix0, ix0 + k1)
                         for y in range(iy0, iy0 + k1)
                         if 0 <= x < wl and 0 <= y < hl})
        out.append(taps)
    return out


@pytest.mark.parametrize("kind,h,w", [("smooth", 23, 31), (6.0, 13, 21),
                                      (40.0, 9, 80), (1e4, 9, 10)])
def test_tile_plan_box_agrees_with_brute_force(kind, h, w):
    """The box lies in the level and is at most BOX a side; a query takes
    the tile path exactly when every in-level tap of its window lies in
    the box; a query with no tap in the level takes neither path; where
    the live windows span at most BOX, the box is their span and every
    live query takes the tile path. (40.0, 9, 80): windows spread wider
    than BOX, so some queries take the per-query path."""
    b, levels, radius = 2, 4, 4
    coords = torch.from_numpy(_coords(b, h, w, kind, seed=7))
    plans = tfused.tile_plan(coords, h, w, levels, radius)
    truth = _brute_force(coords.numpy(), h, w, levels, radius)
    q = tfused.query_tiles(h * w, w)
    meta = tfused.cat_meta(h, w, levels)
    n_slow = 0
    for li, (p, (hl, wl, _hp, _off)) in enumerate(zip(plans, meta)):
        if hl == 0 or wl == 0:
            assert p is None
            continue
        for bi in range(b):
            for ti in range(q.shape[0]):
                x0, bw = int(p["x0"][bi, ti]), int(p["bw"][bi, ti])
                y0, hb = int(p["y0"][bi, ti]), int(p["hb"][bi, ti])
                assert 0 <= bw <= tfused.BOX and 0 <= hb <= tfused.BOX
                if bw and hb:
                    assert 0 <= x0 and x0 + bw <= wl
                    assert 0 <= y0 and y0 + hb <= hl
                live_taps = []
                for si in range(q.shape[1]):
                    qi = int(q[ti, si])
                    if qi < 0:
                        assert not p["live"][bi, ti, si]
                        continue
                    taps = truth[li][bi * h * w + qi]
                    inside = all(x0 <= x < x0 + bw and y0 <= y < y0 + hb
                                 for x, y in taps)
                    assert bool(p["live"][bi, ti, si]) == bool(taps)
                    assert bool(p["fast"][bi, ti, si]) == (bool(taps)
                                                          and inside)
                    if taps:
                        live_taps.append(taps)
                n_slow += int(p["slow"][bi, ti].sum())
                if live_taps:
                    xs = [x for t in live_taps for x, _ in t]
                    ys = [y for t in live_taps for _, y in t]
                    if max(ys) - min(ys) < tfused.BOX and \
                            max(xs) - min(xs) < tfused.BOX:
                        assert (x0, bw, y0, hb) == (
                            min(xs), max(xs) + 1 - min(xs),
                            min(ys), max(ys) + 1 - min(ys))
                        assert not p["slow"][bi, ti].any()
    if kind == 40.0:
        assert n_slow > 0


def _jax_lookup(f1, f2, coords, levels, radius):
    return np.asarray(jfused.fused_corr_lookup(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords), levels,
        radius, jnp.float32, 64, True))


@pytest.mark.parametrize("kind,h,w", [("smooth", 14, 22), (40.0, 9, 80)])
def test_plain_matches_jax_on_tile_cases(kind, h, w):
    """The oracle of the card's kernel against JAX's Pallas kernel
    (interpret mode) on smooth coordinates and on coordinates whose
    windows overflow a tile's box (the plan sends some queries down the
    per-query path), f32, within the tolerance of the existing parity
    test (``test_torch_ops.py``)."""
    b, c, levels, radius = 2, 32, 4, 4
    rng = np.random.default_rng(11)
    f1 = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    f2 = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    coords = _coords(b, h, w, kind, seed=12)
    plans = tfused.tile_plan(torch.from_numpy(coords), h, w, levels, radius)
    slow = sum(int(p["slow"].sum()) for p in plans if p)
    assert (slow > 0) == (kind == 40.0)
    ref = _jax_lookup(f1, f2, coords.reshape(b, h, w, 2), levels, radius)
    got = tfused.fused_corr_lookup(torch.from_numpy(f1),
                                   torch.from_numpy(f2),
                                   torch.from_numpy(coords).reshape(
                                       b, h, w, 2), levels, radius,
                                   torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_route():
    assert tfused.route(torch.bfloat16, 256) == "tensor_cores"
    assert tfused.route(torch.bfloat16, 128) == "tensor_cores"
    assert tfused.route(torch.bfloat16, 64) == "cuda_cores"
    assert tfused.route(torch.float32, 256) == "cuda_cores"
