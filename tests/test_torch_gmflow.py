"""The port's GMFlow on the CPU against the JAX one, stage by stage and whole,
same weights, f32 (bf16 for the kernel path of one layer and of one
FeatureTransformer).

JAX variables come from ``GMFlow.init`` and are carried into the port by
``gmflow_state_dict_from_flax`` (``strict=True``); the port's weights go
the other way through ``port_gmflow``. Inputs are seeded numpy arrays at
64x96 (windows of 4x6 tokens at 1/8 with 2 splits, 2x3 at 1/4 with 8).
Stage tolerances are the 2e-4 to 1e-3 of ``ROADMAP.md``; the whole-model
ones start from ``tests/test_torch_parity.py``'s (2e-2 px; refine 0.2 px
max, 1e-2 px median) and are stated with what the two reach.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import traverse_util

import opticalflowfromdepth_tpu.models.gmflow as J
from opticalflowfromdepth_tpu.ops.sampling import flow_warp as j_flow_warp
from opticalflowfromdepth_tpu.tools.port_torch_weights import (
    port_gmflow, to_variables)
from opticalflowfromdepth_torch.models import gmflow as T
from opticalflowfromdepth_torch.ops.sampling import flow_warp
from opticalflowfromdepth_torch.weights import gmflow_state_dict_from_flax

torch.set_num_threads(2)
H, W = 64, 96
RECIPES = {1: ((2,), (-1,), (-1,)), 2: ((2, 8), (-1, 4), (-1, 1))}


def _images(seed=0, b=1):
    """Smooth images (bilinear upsampled 8x12 noise) in [0, 255]."""
    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.uniform(0, 255, (2 * b, 3, 8, 12)).astype(
        np.float32))
    img = F.interpolate(low, size=(H, W), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    return np.ascontiguousarray(img[:b]), np.ascontiguousarray(img[b:])


@functools.lru_cache(maxsize=None)
def _jax(num_scales: int):
    model = J.GMFlow(num_scales=num_scales,
                     upsample_factor=8 if num_scales == 1 else 4)
    sp, cr, pr = RECIPES[num_scales]
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    v = jax.jit(functools.partial(
        model.init, attn_splits_list=sp, corr_radius_list=cr,
        prop_radius_list=pr))(jax.random.PRNGKey(num_scales), dummy, dummy)
    return model, jax.tree_util.tree_map(np.asarray, v)


@functools.lru_cache(maxsize=None)
def _port(num_scales: int) -> T.GMFlow:
    _, v = _jax(num_scales)
    model = T.GMFlow(num_scales=num_scales,
                     upsample_factor=8 if num_scales == 1 else 4)
    model.load_state_dict(gmflow_state_dict_from_flax(v["params"],
                                                      num_scales),
                          strict=True)
    return model.eval()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, atol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= atol, f"{what}: max |diff| {err:.3e} > {atol:g}"


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def test_position_and_window_utilities_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 12, 8)).astype(np.float32)
    y = rng.normal(size=(2, 8, 12, 8)).astype(np.float32)
    _close(T.position_embedding_sine(8, 12, 64),
           J.position_embedding_sine(8, 12, 64), 1e-5, "position")
    for k in (1, 2, 4):
        _close(T.split_feature(_t(x), k), J.split_feature(jnp.asarray(x), k),
               0, f"split {k}")
        _close(T.merge_splits(T.split_feature(_t(x), k), k), x, 0,
               f"merge {k}")
    for splits in (1, 2):
        got = T.feature_add_position(_t(x), _t(y), splits, 8)
        want = J.feature_add_position(jnp.asarray(x), jnp.asarray(y),
                                      splits, 8)
        for g_, w_ in zip(got, want):
            _close(g_, w_, 1e-5, f"feature_add_position {splits}")


@pytest.mark.parametrize("num_scales", [1, 2])
def test_cnn_encoder_matches_jax(num_scales):
    """Bias-free convs and instance norms (the CUDA kernel's plain
    version here), the trident conv with two scales: 2e-4."""
    _, v = _jax(num_scales)
    x = np.concatenate(J.normalize_img(*(jnp.asarray(a)
                                         for a in _images(2))), 0)
    want = J.CNNEncoder(128, num_scales).apply(
        {"params": v["params"]["backbone"]}, x)
    with torch.no_grad():
        got = _port(num_scales).backbone(_t(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == num_scales
    for g_, w_ in zip(got, want):
        _close(g_.permute(0, 2, 3, 1), w_, 2e-4, "backbone")


@pytest.mark.parametrize("splits", [2, 8])
def test_feature_transformer_matches_jax(splits):
    """Six blocks over the concatenated pair, Swin windows shifted in the
    odd blocks (splits 2 at 1/8, 8 at 1/4): 5e-4 on features of |x| ~20."""
    _, v = _jax(1)
    hw = (8, 12) if splits == 2 else (16, 24)
    rng = np.random.default_rng(3)
    f0, f1 = (rng.normal(size=(1,) + hw + (128,)).astype(np.float32)
              for _ in range(2))
    want = J.FeatureTransformer(6, 128, 4).apply(
        {"params": v["params"]["transformer"]}, jnp.asarray(f0),
        jnp.asarray(f1), attn_num_splits=splits)
    with torch.no_grad():
        got = _port(1).transformer(_t(f0), _t(f1), splits)
    for g_, w_ in zip(got, want):
        _close(g_, w_, 5e-4, f"transformer splits={splits}")


@pytest.mark.parametrize("block,name", [(1, "self_attn"),
                                        (1, "cross_attn_ffn")])
def test_transformer_layer_bf16_kernel_path(monkeypatch, block, name):
    """bf16, the TPU path, one layer so that rounding does not compound:
    the JAX TransformerLayer through the Pallas flash kernel (interpret
    mode; shifted windows, the [2B] batch of the transformer) against the
    port's bf16 layer. With the same casts both round the same values:
    at least 98% of the outputs are the same bf16 number, none more than
    one step (2^-7 of max|x|) apart; measured 99.99% (self attention) and
    98.47% (with the FFN), max 1.6e-2 against a step of 4.1e-2 / 4.6e-2.
    The port's f32 layer on the same inputs fails that (0% the same): the
    test tells the casts apart."""
    monkeypatch.setenv("OFD_FLASH", "interpret")
    _, v = _jax(1)
    h, w = 8, 12
    rng = np.random.default_rng(11)
    src, tgt = (np.asarray(jnp.asarray(rng.normal(size=(2, h * w, 128)),
                                       jnp.bfloat16).astype(jnp.float32))
                for _ in range(2))
    no_ffn = name == "self_attn"
    want = np.asarray(J.TransformerLayer(
        128, no_ffn=no_ffn, with_shift=True, dtype=jnp.bfloat16).apply(
            {"params": v["params"]["transformer"][f"block_{block}"][name]},
            jnp.asarray(src, jnp.bfloat16), jnp.asarray(tgt, jnp.bfloat16),
            h, w, J.shift_window_attn_mask(h, w, 4, 6, 2, 3), 2),
        np.float32)
    prefix = f"transformer.layers.{block}.{name}."
    sd = {k[len(prefix):]: t for k, t in _port(1).state_dict().items()
          if k.startswith(prefix)}
    same = {}
    for dt in (torch.bfloat16, torch.float32):
        layer = T.TransformerLayer(128, no_ffn, 4, True, dtype=dt)
        layer.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = layer(_t(src).to(dt), _t(tgt).to(dt), h, w, 2)
        assert got.dtype == dt
        d = np.abs(got.float().numpy() - want)
        same[dt] = (d == 0).mean()
        if dt == torch.bfloat16:
            assert d.max() <= 2 ** -7 * np.abs(want).max(), d.max()
    assert same[torch.bfloat16] >= 0.98 and same[torch.float32] < 0.01, same


def test_feature_transformer_bf16_kernel_path(monkeypatch):
    """bf16, the TPU path: the JAX FeatureTransformer through the Pallas
    flash kernel (interpret mode) against the port's bf16 plain path. The
    single layers agree bit for bit but for rare rounding flips (the test
    above); six residual blocks carry each flip on (a step is 0.125 at
    |x| ~ 20). Held: the port's mean difference within 0.7x of the port's
    f32 transformer's (measured 0.040 / 0.042 against 0.075 / 0.093), and
    its max within the f32 one's (0.68 / 0.64 against 1.08 / 1.52)."""
    monkeypatch.setenv("OFD_FLASH", "interpret")
    _, v = _jax(1)
    rng = np.random.default_rng(4)
    f0, f1 = (rng.normal(size=(1, 8, 12, 128)).astype(np.float32)
              for _ in range(2))
    want = J.FeatureTransformer(6, 128, 4, dtype=jnp.bfloat16).apply(
        {"params": v["params"]["transformer"]},
        jnp.asarray(f0, jnp.bfloat16), jnp.asarray(f1, jnp.bfloat16),
        attn_num_splits=2)
    port = T.FeatureTransformer(6, 128, 4, dtype=torch.bfloat16)
    port.load_state_dict({k[len("transformer."):]: t for k, t in
                          _port(1).state_dict().items()
                          if k.startswith("transformer.")}, strict=True)
    with torch.no_grad():
        got = port(_t(f0).bfloat16(), _t(f1).bfloat16(), 2)
        f32 = _port(1).transformer(_t(f0), _t(f1), 2)
    for g_, w_, r_ in zip(got, want, f32):
        assert g_.dtype == torch.bfloat16
        w_ = np.asarray(w_, np.float32)
        d = np.abs(g_.float().numpy() - w_)
        own = np.abs(w_ - r_.numpy())
        assert d.mean() <= 0.7 * own.mean(), (d.mean(), own.mean())
        assert d.max() <= own.max(), (d.max(), own.max())


@pytest.mark.parametrize("bidir", [False, True])
def test_global_matching_matches_jax(bidir):
    """softmax(f0 f1^T / sqrt(C)) @ grid - grid through the flash call (f32
    plain) against the JAX dense path: 1e-3 px on flows of |x| ~ 8."""
    rng = np.random.default_rng(5)
    f0, f1 = (rng.normal(size=(1, 8, 12, 128)).astype(np.float32) * 3
              for _ in range(2))
    want = J.global_correlation_softmax(jnp.asarray(f0), jnp.asarray(f1),
                                        bidir)[0]
    got, prob = T.global_correlation_softmax(_t(f0), _t(f1), bidir)
    assert prob is None
    _close(got, want, 1e-3, "global matching")


def test_local_matching_matches_jax():
    rng = np.random.default_rng(6)
    f0, f1 = (rng.normal(size=(1, 16, 24, 128)).astype(np.float32) * 3
              for _ in range(2))
    want, wprob = J.local_correlation_softmax(jnp.asarray(f0),
                                              jnp.asarray(f1), 4)
    got, prob = T.local_correlation_softmax(_t(f0), _t(f1), 4)
    _close(got, want, 1e-3, "local matching")
    _close(prob, wprob, 1e-4, "local matching prob")


@pytest.mark.parametrize("local", [False, True])
def test_flow_propagation_matches_jax(local):
    """Global branch (key = k_proj(query), the reference's quirk; one flash
    call with the flow as v) and the 3x3 local window: 2e-4 px."""
    _, v = _jax(1)
    rng = np.random.default_rng(7)
    hw = (16, 24) if local else (8, 12)
    feat = rng.normal(size=(1,) + hw + (128,)).astype(np.float32) * 3
    flow = rng.normal(0, 5, (1,) + hw + (2,)).astype(np.float32)
    want = J.FeatureFlowAttention(128).apply(
        {"params": v["params"]["feature_flow_attn"]}, jnp.asarray(feat),
        jnp.asarray(flow), local_window_attn=local, local_window_radius=1)
    with torch.no_grad():
        got = _port(1).feature_flow_attn(_t(feat), _t(flow), local, 1)
    _close(got, want, 2e-4, f"propagation local={local}")


def test_samplers_match_jax():
    """``bilinear_gather`` and ``grid_sample`` (one image, zero padding,
    both corner conventions) against the JAX ones, samples leaving the
    image included: 1e-5."""
    from opticalflowfromdepth_tpu.ops import sampling as js
    from opticalflowfromdepth_torch.ops import sampling as ts
    rng = np.random.default_rng(9)
    img = rng.normal(size=(5, 12, 20)).astype(np.float32)
    x = rng.uniform(-3, 23, (7, 9)).astype(np.float32)
    y = rng.uniform(-3, 15, (7, 9)).astype(np.float32)
    _close(ts.bilinear_gather(_t(img), _t(x), _t(y)),
           js.bilinear_gather(jnp.asarray(img), jnp.asarray(x),
                              jnp.asarray(y)), 1e-5, "bilinear_gather")
    grid = rng.uniform(-1.2, 1.2, (6, 8, 2)).astype(np.float32)
    for ac in (True, False):
        _close(ts.grid_sample(_t(img), _t(grid), ac),
               js.grid_sample(jnp.asarray(img), jnp.asarray(grid), ac), 1e-5,
               f"grid_sample align_corners={ac}")


@pytest.mark.parametrize("bias,dilation", [(False, 1), (True, 2)])
def test_conv_bias_and_dilation_match_jax(bias, dilation):
    """The port's ``Conv`` (NCHW, SAME padding scaled by the dilation)
    against the JAX ``Conv`` with the same kernel: 1e-5."""
    from opticalflowfromdepth_tpu.models.layers import Conv as JConv
    from opticalflowfromdepth_torch.models.layers import Conv as TConv
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 11, 13, 4)).astype(np.float32)
    jconv = JConv(6, (3, 3), 1, dilation, use_bias=bias)
    v = jax.tree_util.tree_map(np.asarray, jconv.init(jax.random.PRNGKey(0),
                                                      jnp.asarray(x)))
    conv = TConv(4, 6, 3, bias=bias, dilation=dilation)
    p = v["params"]["Conv_0"]
    sd = {"weight": _t(p["kernel"]).permute(3, 2, 0, 1)}
    if bias:
        sd["bias"] = _t(p["bias"])
    conv.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = conv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, jconv.apply(v, jnp.asarray(x)), 1e-5, "conv")


def test_flow_warp_matches_jax():
    """``F.grid_sample`` (align_corners, zeros) against the JAX gather, with
    samples leaving the image: 1e-4 on features of |x| ~ 3."""
    rng = np.random.default_rng(8)
    feat = rng.normal(size=(2, 16, 12, 20)).astype(np.float32)
    flow = rng.normal(0, 6, (2, 2, 12, 20)).astype(np.float32)
    _close(flow_warp(_t(feat), _t(flow)),
           j_flow_warp(jnp.asarray(feat), jnp.asarray(flow)), 1e-4,
           "flow_warp")


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _both(num_scales, bidir, training, seed=0):
    model, v = _jax(num_scales)
    sp, cr, pr = RECIPES[num_scales]
    i1, i2 = _images(seed)
    want = model.apply(v, jnp.asarray(i1), jnp.asarray(i2),
                       attn_splits_list=sp, corr_radius_list=cr,
                       prop_radius_list=pr, pred_bidir_flow=bidir,
                       training=training)["flow_preds"]
    with torch.no_grad():
        got = _port(num_scales)(_t(i1).permute(0, 3, 1, 2),
                                _t(i2).permute(0, 3, 1, 2), sp, cr, pr,
                                bidir, training)["flow_preds"]
    assert len(got) == len(want)
    return [(g_.permute(0, 2, 3, 1).numpy(), np.asarray(w_))
            for g_, w_ in zip(got, want)]


@pytest.mark.parametrize("training", [False, True])
def test_gmflow_one_scale_matches_jax(training):
    """f32 both sides: every prediction within 2e-2 px (they reach 7.6e-3:
    global matching's softmax turns ~1e-5 feature differences into ~1e-4
    px at 1/8, and the x8 convex upsample scales that)."""
    for i, (got, want) in enumerate(_both(1, False, training)):
        assert got.shape == (1, H, W, 2)
        _close(got, want, 2e-2, f"1-scale pred[{i}]")


def test_gmflow_bidir_matches_jax():
    """Forward and backward flows, 2e-2 px (they reach 1.0e-2)."""
    for i, (got, want) in enumerate(_both(1, True, False)):
        assert got.shape == (2, H, W, 2)
        _close(got, want, 2e-2, f"bidir pred[{i}]")


def test_gmflow_refine_matches_jax():
    """Two scales (splits 2 and 8, local matching r=4, local propagation
    r=1): every prediction within 0.2 px, median 1e-2 px (they reach 0.12
    and 1.8e-3). Every stage holds to 1e-3 above; the refinement's local
    matching amplifies f32 rounding (``chip_smoke.py`` [9] measures how far
    input noise of 1e-4 gray levels moves a refine model)."""
    for i, (got, want) in enumerate(_both(2, False, True)):
        d = np.abs(got - want)
        assert np.median(d) <= 1e-2 and d.max() <= 0.2, (i, d.max(),
                                                           np.median(d))


# ---------------------------------------------------------------------------
# weights both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_scales", [1, 2])
def test_weights_carry_both_ways(num_scales):
    """``port_gmflow`` of the port's ``state_dict`` is the JAX model's tree
    (``to_variables`` checks keys and shapes against ``init``'s), and the
    inverse gives back the same tensors exactly."""
    _, v = _jax(num_scales)
    port = T.GMFlow(num_scales=num_scales,
                    upsample_factor=8 if num_scales == 1 else 4,
                    generator=torch.Generator().manual_seed(9))
    sd = port.state_dict()
    flat = port_gmflow(sd, num_scales=num_scales)
    variables = to_variables(flat, template={"params": v["params"]})
    back = gmflow_state_dict_from_flax(
        traverse_util.unflatten_dict(flat), num_scales)
    assert set(back) == set(sd)
    for k, t in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), t.numpy(), err_msg=k)
    T.GMFlow(num_scales=num_scales,
             upsample_factor=8 if num_scales == 1 else 4).load_state_dict(
                 back, strict=True)
    assert jax.tree_util.tree_structure(variables["params"]) == \
        jax.tree_util.tree_structure(v["params"])
