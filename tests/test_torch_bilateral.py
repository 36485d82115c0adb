"""The port's sparse bilateral filter (``ops/bilateral.py``) on the CPU:
the cases of ``tests/test_bilateral.py``, then the port against the JAX
functions and against a numpy loop of the reference's semantics, on seeded
48x64 depths with steps, spikes and zeros.

Tolerance: exact. One stated exception: at a 7x7 window (49 taps) the JAX
``weighted_median`` sums its cumulative coefficients with XLA's CPU
``reduce_window``, in another order than the reference's ``np.cumsum``,
so its sums near 0.5 round otherwise and its median moves across the 0.5
boundary at some pixels (the test prints how many: 276-282 of these
depths' 3,072). The budget there: at most 15% of the pixels may differ
from JAX (XLA may vectorise the window otherwise on another CPU), and at
every pixel the port equals the numpy loop (``np.cumsum``,
``np.digitize``) exactly.
At 3x3 and 5x5 windows (9 and 25 taps) the port equals JAX bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_torch.ops import bilateral as T
from opticalflowfromdepth_tpu.ops import bilateral as J

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# the cases of tests/test_bilateral.py
# ---------------------------------------------------------------------------

def test_weighted_median_simple():
    depth = _t([[3.0, 1.0, 2.0, 100.0]])
    coef = _t([[1.0, 1.0, 1.0, 0.0]])
    # sorted by depth: [1, 2, 3, 100], coef [1,1,1,0]/3, cum [.33,.67,1,1]
    assert float(T.weighted_median(depth, coef)[0]) == 2.0


def _median_oracle(depth, coef):
    """The reference's per-patch loop: stable sort, np.cumsum of the
    normalised coefficients, np.digitize(0.5, cum)."""
    order = depth.argsort(kind="stable")
    cum = np.cumsum(coef[order] / max(coef.sum(), np.float32(1e-12)))
    return depth[order][min(np.digitize(0.5, cum), len(depth) - 1)]


@pytest.mark.parametrize("k", [9, 25, 49])
def test_weighted_median_matches_numpy_oracle(k):
    rng = np.random.default_rng(k)
    depth = rng.uniform(1, 100, (400, k)).astype(np.float32)
    depth[:, : k // 3] = np.round(depth[:, : k // 3])       # ties
    coef = (rng.random((400, k)) > 0.3).astype(np.float32)
    coef[:, 0] = 1.0  # never all-zero
    got = T.weighted_median(_t(depth), _t(coef)).numpy()
    want = np.array([_median_oracle(d, c) for d, c in zip(depth, coef)])
    np.testing.assert_array_equal(got, want)
    jax_got = np.asarray(J.weighted_median(jnp.asarray(depth),
                                           jnp.asarray(coef)))
    if k < 32:     # see the module docstring for 49 taps
        np.testing.assert_array_equal(got, jax_got)


def test_discontinuity_map_flags_edges():
    depth = np.full((16, 16), 10.0, np.float32)
    depth[:, 8:] = 50.0  # sharp edge
    disc = T.depth_discontinuity(_t(depth), 0.04).numpy()
    assert disc[5, 7] == 1.0 or disc[5, 8] == 1.0
    assert disc[5, 2] == 0.0 and disc[5, 13] == 0.0


def test_filter_preserves_flat_regions():
    depth = np.full((24, 24), 20.0, np.float32)
    out = T.sparse_bilateral_filtering(_t(depth), filter_sizes=(5, 5))
    np.testing.assert_allclose(out.numpy(), 20.0, atol=1e-5)


def test_filter_smooths_isolated_spike_near_edge():
    depth = np.full((24, 24), 10.0, np.float32)
    depth[:, 12:] = 50.0
    depth[6, 11] = 49.0  # spike on the near side of the edge
    out = T.sparse_bilateral_filtering(_t(depth), filter_sizes=(7,)).numpy()
    assert out[6, 11] in (10.0, 50.0)
    assert out[6, 2] == 10.0 and out[6, 21] == 50.0


# ---------------------------------------------------------------------------
# the port against JAX and the numpy loop
# ---------------------------------------------------------------------------

def _depth(seed, h=48, w=64):
    """Smooth depth with two steps, 5% spikes and 3% zeros (holes)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 10 + 3 * np.sin(xx / 7) * np.cos(yy / 5)
    d[:, w // 2:] += 40
    d[h // 2:, : w // 3] = 5.0
    d += rng.uniform(0, 0.5, (h, w))
    d[rng.random((h, w)) < 0.05] *= 3
    d[rng.random((h, w)) < 0.03] = 0.0
    return d.astype(np.float32)


def _step_oracle(depth, disc, ws):
    """``bilateral_filter_step`` as a loop over pixels, with the JAX
    package's discontinuity map (held to the port's below)."""
    def edge_reset(x):
        return np.pad(x[1:-1, 1:-1], 1, mode="edge")
    depth, disc = edge_reset(depth), edge_reset(disc)
    m = ws // 2
    dp, hp = np.pad(depth, m, mode="edge"), np.pad(disc, m, mode="edge")
    out = depth.copy()
    for y in range(depth.shape[0]):
        for x in range(depth.shape[1]):
            win_d = dp[y:y + ws, x:x + ws].ravel()
            win_h = hp[y:y + ws, x:x + ws].ravel()
            coef = (1.0 - win_h).astype(np.float32)
            if not (win_h > 0).any() or coef.max() == 0:
                continue
            out[y, x] = _median_oracle(win_d, coef)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("filter_sizes", [(5, 5), (7,)])
def test_filter_matches_jax_and_the_reference_loop(seed, filter_sizes):
    d = _depth(seed)
    got = T.sparse_bilateral_filtering(_t(d), filter_sizes).numpy()
    want = np.asarray(J.sparse_bilateral_filtering(jnp.asarray(d),
                                                   filter_sizes))
    assert (got != d).sum() > 1000          # the filter does change pixels
    oracle = d
    for ws in filter_sizes:
        disc = T.depth_discontinuity(_t(oracle), 0.04).numpy()
        np.testing.assert_array_equal(disc, np.asarray(
            J.depth_discontinuity(jnp.asarray(oracle), 0.04)))
        oracle = _step_oracle(oracle, disc, ws)
    np.testing.assert_array_equal(got, oracle)
    if filter_sizes == (5, 5):
        np.testing.assert_array_equal(got, want)
    else:                                   # the docstring's budget
        print(f"7x7: {(got != want).sum()} of {got.size} pixels differ "
              "from JAX")
        assert (got != want).mean() <= 0.15


def test_filter_keeps_dtype_shape_and_runs_per_window_size():
    d = _t(_depth(5))
    one = T.bilateral_filter_step(d, T.depth_discontinuity(d, 0.04), 5)
    two = T.sparse_bilateral_filtering(d, (5, 3))
    assert one.shape == two.shape == d.shape and two.dtype == torch.float32
    np.testing.assert_array_equal(
        T.bilateral_filter_step(one, T.depth_discontinuity(one, 0.04),
                                3).numpy(), two.numpy())
