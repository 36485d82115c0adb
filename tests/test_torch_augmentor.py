"""The port's cv2-free augmentors on the CPU against cv2 and the JAX
package's augmentors.

* u8 RGB -> HSV against ``cv2.cvtColor`` over all 2^24 colours, and
  HSV -> RGB over every u8 HSV triple (H < 180) through both of cv2's
  paths (a row's first ``32 k`` pixels take its vector path, the rest its
  scalar one): bit for bit.
* ``resize_linear`` against ``cv2.resize(src, None, fx, fy,
  INTER_LINEAR)`` at the augmentors' scales (2^-0.2 to 2^0.5, with an
  independent stretch of 2^+-0.2) for 1, 2 and 3 channels: u8 bit for bit
  with and without IPP, f32 bit for bit without IPP and within 1e-5 of
  the largest value with it (cv2's IPP adds in another order; measured
  5.0e-6).
* ``color_jitter``, ``FlowAugmentor`` (with back flow and depths) and
  ``SparseFlowAugmentor`` against the JAX classes with generators of the
  same seed: the same draws in the same order, so images equal; flows and
  depths within 1e-5 of the largest value (the JAX side resizes them
  through cv2 with IPP, the default).
"""

import numpy as np
import pytest

from opticalflowfromdepth_torch.data import augmentor as taug
from opticalflowfromdepth_torch.data.source import resize_linear

cv2 = pytest.importorskip("cv2")
jaug = pytest.importorskip("opticalflowfromdepth_tpu.data.augmentor")


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def test_rgb_to_hsv_every_colour():
    c = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255],
                   -1).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(taug.rgb_to_hsv_u8(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [256, 1], ids=["vector", "scalar"])
def test_hsv_to_rgb_every_triple(width):
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                          indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, width, 3)
    np.testing.assert_array_equal(taug.hsv_to_rgb_u8(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("width", [1, 31, 32, 33, 47, 64, 97])
def test_hsv_round_trip_at_ragged_widths(width):
    rng = np.random.default_rng(width)
    img = rng.integers(0, 256, (23, width, 3)).astype(np.uint8)
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    np.testing.assert_array_equal(taug.rgb_to_hsv_u8(img), hsv)
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + 37) % 180
    np.testing.assert_array_equal(taug.hsv_to_rgb_u8(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def _scales(rng, n):
    """(fx, fy) over the augmentors' range: 2^U(-0.2, 0.5), stretched."""
    s = 2 ** rng.uniform(-0.2, 0.5, n)
    return zip(s * 2 ** rng.uniform(-0.2, 0.2, n),
               s * 2 ** rng.uniform(-0.2, 0.2, n))


@pytest.mark.parametrize("ipp", [False, True], ids=["no_ipp", "ipp"])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_resize_linear_matches_cv2(channels, ipp):
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    rng = np.random.default_rng(channels)
    worst = 0.0
    try:
        for i, (fx, fy) in enumerate(_scales(rng, 40)):
            h, w = (int(v) for v in rng.integers(5, 70, 2))
            shape = (h, w) if channels == 1 else (h, w, channels)
            u8 = rng.integers(0, 256, shape).astype(np.uint8)
            got = resize_linear(u8, fx, fy)
            want = cv2.resize(u8, None, fx=fx, fy=fy,
                              interpolation=cv2.INTER_LINEAR)
            assert got.shape == want.shape and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"{i} u8")
            f = rng.normal(0, 40, shape).astype(np.float32)
            got = resize_linear(f, fx, fy)
            want = cv2.resize(f, None, fx=fx, fy=fy,
                              interpolation=cv2.INTER_LINEAR)
            assert got.shape == want.shape and got.dtype == np.float32
            if not ipp:
                np.testing.assert_array_equal(got, want, err_msg=f"{i} f32")
            worst = max(worst, float(np.abs(got - want).max()
                                     / np.abs(want).max()))
    finally:
        cv2.ipp.setUseIPP(was)
    assert worst <= 1e-5, worst


def test_resize_linear_size_rules(no_ipp):
    """The size is cvRound(w * fx) (half to even), the sampling 1 / fx; an
    output of the input's size is a copy; an exact 2x reduction is cv2's
    2x2 mean (u8 with 2 channels rounds half to even, f32 with 1 channel
    adds in pairs 4 columns at a time)."""
    rng = np.random.default_rng(0)
    for (h, w, fx, fy) in [(10, 5, 1.3, 1.05), (12, 14, 0.5, 0.5),
                           (4, 30, 0.5, 0.5), (9, 9, 1.04, 0.97)]:
        for c in (1, 2, 3):
            shape = (h, w) if c == 1 else (h, w, c)
            for x in (rng.integers(0, 256, shape).astype(np.uint8),
                      rng.normal(0, 9, shape).astype(np.float32)):
                want = cv2.resize(x, None, fx=fx, fy=fy,
                                  interpolation=cv2.INTER_LINEAR)
                np.testing.assert_array_equal(resize_linear(x, fx, fy), want)
    assert resize_linear(np.zeros((2, 5), np.uint8), 1.3, 1.0).shape \
        == (2, 6)          # 6.5 rounds to 6
    with pytest.raises(TypeError):
        resize_linear(np.zeros((4, 4)), 1.5, 1.5)


def _same_rng_pair(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _img(rng, h, w):
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("seed", range(6))
def test_color_jitter_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    img = _img(rng, 40 + seed, 33 + 7 * seed)
    a, b = _same_rng_pair(seed)
    jitter = (0.4, 0.4, 0.4, 0.5 / 3.14)
    np.testing.assert_array_equal(taug.color_jitter(a, img, *jitter),
                                  jaug.color_jitter(b, img, *jitter))
    assert a.random() == b.random()          # the same number of draws


def _dense_inputs(rng, h, w):
    flow = rng.normal(0, 6, (h, w, 2)).astype(np.float32)
    back = rng.normal(0, 6, (h, w, 2)).astype(np.float32)
    d1 = rng.uniform(20, 200, (h, w, 1)).astype(np.float32)
    d2 = rng.uniform(20, 200, (h, w, 1)).astype(np.float32)
    d1[:4, :4] = 100.0
    return _img(rng, h, w), _img(rng, h, w), flow, back, d1, d2


def _assert_close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if got.dtype == np.uint8:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        tol = 1e-5 * max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("seed", range(8))
def test_flow_augmentor_matches_jax(seed):
    rng = np.random.default_rng(seed)
    inputs = _dense_inputs(rng, 120, 160)
    eraser = 0.5 if seed % 2 else 0.0
    a, b = _same_rng_pair(seed)
    got = taug.FlowAugmentor((64, 96), eraser_aug_prob=eraser, rng=a)(
        *inputs)
    want = jaug.FlowAugmentor((64, 96), eraser_aug_prob=eraser, rng=b)(
        *inputs)
    for name, g, w in zip(("img1", "img2", "flow", "back_flow", "depth1",
                           "depth2"), got, want):
        _assert_close(g, w, f"seed {seed} {name}")
    assert a.random() == b.random()


def test_flow_augmentor_fit_and_optional_arrays():
    """Images smaller than the crop take the resize that makes it fit;
    back flow and depths may be left out."""
    rng = np.random.default_rng(3)
    img1, img2, flow = _dense_inputs(rng, 40, 50)[:3]
    for seed in range(4):
        a, b = _same_rng_pair(seed)
        got = taug.FlowAugmentor((48, 56), rng=a)(img1, img2, flow)
        want = jaug.FlowAugmentor((48, 56), rng=b)(img1, img2, flow)
        assert got[3:] == want[3:] == (None, None, None)
        for g, w in zip(got[:3], want[:3]):
            _assert_close(g, w, f"fit seed {seed}")
        assert got[0].shape == (48, 56, 3)


@pytest.mark.parametrize("seed", range(6))
def test_sparse_flow_augmentor_matches_jax(seed):
    rng = np.random.default_rng(50 + seed)
    h, w = 90, 140
    img1, img2 = _img(rng, h, w), _img(rng, h, w)
    flow = rng.normal(0, 8, (h, w, 2)).astype(np.float32)
    valid = (rng.random((h, w)) < 0.4).astype(np.float32)
    a, b = _same_rng_pair(seed)
    kw = dict(do_flip=bool(seed % 2))
    got = taug.SparseFlowAugmentor((56, 96), rng=a, **kw)(img1, img2, flow,
                                                           valid)
    want = jaug.SparseFlowAugmentor((56, 96), rng=b, **kw)(img1, img2, flow,
                                                            valid)
    for name, g, wnt in zip(("img1", "img2", "flow", "valid"), got, want):
        assert g.dtype == wnt.dtype, name
        np.testing.assert_array_equal(g, wnt, err_msg=f"seed {seed} {name}")
    assert a.random() == b.random()


def test_unseeded_augmentors_draw_from_a_fresh_generator():
    """As in the JAX package, ``rng=None`` takes an unseeded generator."""
    x = taug.FlowAugmentor((8, 8))
    y = taug.FlowAugmentor((8, 8))
    assert isinstance(x.rng, np.random.Generator) and x.rng is not y.rng
