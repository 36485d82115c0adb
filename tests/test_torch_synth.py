"""The port's synthesis engine on the CPU against the JAX package's.

Keyed ``jax.random`` cannot be repeated in PyTorch, so the port takes
every random value as an explicit draw. ``jax_sample_draws`` turns a JAX
key into the port's draws through the JAX package's own functions (the
key splits of ``synth/pipeline.py:68/274/287`` and
``core/special_flow.py:65``, ``rng.get_random``, ``camera.random_motion``):
both packages then synthesize from the same random values.

Tolerances:
  * core functions: flows within 1e-4 px, exact where the arithmetic is
    the same;
  * the forward warp: bit-exact on JAX's own inputs at every stage;
  * inpaint: kept pixels exact, filled pixels within 1 gray level (the
    pull-push sums may round differently before the floor);
  * whole stages (the group, each augment type, the packed sample): the
    warp truncates its targets, which turns an f32 rounding of a flow into
    a whole pixel, so at most 0.5% of the pixels may differ; everywhere
    else images within 1 gray level, flows and depths within 1e-3 (f32),
    or within one f16 step (1e-3 + 1e-3 |x|) where stored as f16.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.core import camera as jcam
from opticalflowfromdepth_tpu.core import convert as jconv
from opticalflowfromdepth_tpu.core import depth_utils as jdu
from opticalflowfromdepth_tpu.core import geometry as jgeo
from opticalflowfromdepth_tpu.core import rng as jrng
from opticalflowfromdepth_tpu.core import special_flow as jsf
from opticalflowfromdepth_tpu.ops import forward_warp as jfw
from opticalflowfromdepth_tpu.ops import inpaint as jin
from opticalflowfromdepth_tpu.synth import pipeline as jp
from opticalflowfromdepth_tpu.synth import writer as jwriter
from opticalflowfromdepth_torch.core import camera, convert, depth_utils
from opticalflowfromdepth_torch.core import geometry, rng, special_flow
from opticalflowfromdepth_torch.core.rng import AugmentDraws, GroupDraws
from opticalflowfromdepth_torch.data.datasets import AugmentedShards
from opticalflowfromdepth_torch.ops import forward_warp as tfw
from opticalflowfromdepth_torch.ops import inpaint as tin
from opticalflowfromdepth_torch.synth import cli
from opticalflowfromdepth_torch.synth import pipeline as tp
from opticalflowfromdepth_torch.synth import writer

torch.set_num_threads(2)
H, W = 48, 64
BUDGET = 0.005       # share of pixels that may differ beyond the tolerances


def t32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def jax_group_draws(key) -> GroupDraws:
    k_disp, k_mot, _ = jax.random.split(key, 3)
    s = jrng.get_random(k_disp, 0.3, 0.8, random_sign=False)
    _, ang, tr = jcam.random_motion(k_mot, 1.0 / 36.0, 1.0 / 36.0, 0.1, 0.1)
    return GroupDraws(t32(s), t32(ang).reshape(3), t32(tr).reshape(3))


def jax_augment_draws(key, t: int, h: int, w: int) -> AugmentDraws:
    f = dict.fromkeys(AugmentDraws._fields, 0.0)
    if t == 6:
        k_cx, k_cy, k_th = jax.random.split(key, 3)
        f["cx"] = jrng.get_random(k_cx, w / 4.0, w / 2.0) + w / 2.0
        f["cy"] = jrng.get_random(k_cy, h / 4.0, h / 2.0) + h / 2.0
        f["theta_deg"] = jrng.get_random(k_th, 2.0, 8.0)
    elif t == 7:
        f["s"] = jrng.get_random(key, 0.15, 0.2)
    elif t == 0:
        f["scale"] = jrng.get_random(key, 1.0, 0.0, random_sign=False)
    elif t == 1:
        k_ch, k_sh = jax.random.split(key)
        f["channel"] = jax.random.randint(k_ch, (), 0, 3)
        f["value"] = jrng.get_random(k_sh, 10.0, 15.0)
    return AugmentDraws(**{k: t32(v) for k, v in f.items()})


def aug_key(k_aug, g: int, a: int):
    return jax.random.fold_in(jax.random.fold_in(k_aug, g), a)


def jax_sample_draws(key, h: int, w: int) -> tp.SampleDraws:
    """The draws of ``jp.synthesize_sample_packed(key, ...)``."""
    k_group, k_aug = jax.random.split(key)
    aug = tuple(tuple(jax_augment_draws(aug_key(k_aug, g, a), t, h, w)
                      for a, t in enumerate(jp.AUGMENT_SCHEDULE))
                for g in range(5))
    return tp.SampleDraws(jax_group_draws(k_group), aug)


def source(seed: int = 0, stereo: bool = False, h: int = H, w: int = W):
    """A smooth procedural image [3, H, W] in [0, 255] and its depth
    (smooth_closer of a closeness map) or disparity [1, H, W]."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.clip(np.stack([np.sin(xx / 7 + c + seed) * np.cos(yy / 5)
                            * 90 + 120 for c in range(3)])
                  + r.uniform(0, 20, (3, h, w)), 0, 255).astype(np.float32)
    if stereo:
        dep = (30 + 25 * np.sin(xx / 11) * np.cos(yy / 13))[None]
    else:
        dep = 1.0 / (255.0 - np.clip(120 + 60 * np.sin(xx / 13 + seed)
                                     * np.cos(yy / 9), 0, 240))[None]
    return img, dep.astype(np.float32)


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def differing_share(got, want, atol, rtol=0.0, channel_axes=1):
    """The share of pixels (the last two axes) where any channel differs
    beyond ``atol + rtol |want|``."""
    g = np_(got).astype(np.float32)
    w_ = np_(want).astype(np.float32)
    assert g.shape == w_.shape
    bad = ~(np.abs(g - w_) <= atol + rtol * np.abs(w_))
    bad = bad.reshape(-1, *g.shape[-2:])
    n_pix = bad.shape[-2] * bad.shape[-1]
    per_pixel = bad.reshape(-1, channel_axes, n_pix).any(1)
    return float(per_pixel.mean())


def assert_sets_close(got, want, img_ch, what):
    """[..., C, H, W] sets: images (channels ``img_ch``) within 1 gray
    level, the rest within 1e-3, but for at most BUDGET of the pixels."""
    g, w_ = np_(got), np_(want)
    c = g.shape[-3]
    flt = [i for i in range(c) if i not in img_ch]
    share = max(differing_share(g[..., img_ch, :, :], w_[..., img_ch, :, :],
                                1.0, channel_axes=len(img_ch)),
                differing_share(g[..., flt, :, :], w_[..., flt, :, :], 1e-3,
                                channel_axes=len(flt)))
    print(f"{what}: {100 * share:.3f}% of pixels beyond the tolerance")
    assert share <= BUDGET, (what, share)


# --------------------------------------------------------------------------
# core
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_geometry_matches_jax(seed):
    r = np.random.default_rng(seed)
    vec = r.uniform(-0.3, 0.3, (2, 1, 3)).astype(np.float32)
    tr = r.uniform(-0.5, 0.5, (2, 1, 3)).astype(np.float32)
    np.testing.assert_allclose(
        geometry.rot_from_axisangle(t32(vec)).numpy(),
        np.asarray(jgeo.rot_from_axisangle(jnp.asarray(vec))), atol=1e-6)
    np.testing.assert_array_equal(
        geometry.get_translation_matrix(t32(tr)).numpy(),
        np.asarray(jgeo.get_translation_matrix(jnp.asarray(tr))))
    for invert in (False, True):
        np.testing.assert_allclose(
            geometry.transformation_from_parameters(
                t32(vec), t32(tr), invert).numpy(),
            np.asarray(jgeo.transformation_from_parameters(
                jnp.asarray(vec), jnp.asarray(tr), invert)), atol=1e-6)
    np.testing.assert_array_equal(
        geometry.pixel_grid_last(5, 7).numpy(),
        np.asarray(jgeo.pixel_grid_last(5, 7)))
    depth = r.uniform(1, 100, (2, 1, 9, 11)).astype(np.float32)
    K, inv_K = camera.intrinsics(9, 11)
    T = geometry.transformation_from_parameters(t32(vec), t32(tr))
    pts = geometry.backproject_depth(t32(depth), inv_K.expand(2, 4, 4))
    jpts = jgeo.backproject_depth(jnp.asarray(depth),
                                  jnp.broadcast_to(jnp.asarray(inv_K.numpy()),
                                                   (2, 4, 4)))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=1e-6,
                               atol=1e-5)
    pix, z = geometry.project_3d(pts, K.expand(2, 4, 4), T, 9, 11)
    jpix, jz = jgeo.project_3d(jpts, jnp.broadcast_to(
        jnp.asarray(K.numpy()), (2, 4, 4)), jnp.asarray(T.numpy()), 9, 11)
    # normalized coordinates: 1e-4 px over a 10-pixel span
    np.testing.assert_allclose(pix.numpy(), np.asarray(jpix), atol=2e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_camera_and_motion_match_jax(seed):
    K, inv_K = camera.intrinsics(H, W)
    jK, jinv = jcam.intrinsics(H, W)
    np.testing.assert_array_equal(K.numpy(), np.asarray(jK))
    np.testing.assert_array_equal(inv_K.numpy(), np.asarray(jinv))
    key = jax.random.PRNGKey(seed)
    d = jax_group_draws(key)
    T, ang, tr = camera.random_motion(d.axisangle, d.translation)
    _, k_mot, _ = jax.random.split(key, 3)
    jT, jang, jtr = jcam.random_motion(k_mot, 1 / 36, 1 / 36, 0.1, 0.1)
    np.testing.assert_array_equal(ang.numpy(), np.asarray(jang))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_convert_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    d = jax_group_draws(key)
    k_disp, k_mot, _ = jax.random.split(key, 3)
    _, dep = source(seed)
    dep = jdu.normalize_depth(jnp.asarray(dep))
    disp = convert.depth_to_disparity(t32(dep), d.s)
    jdisp = jconv.depth_to_disparity(k_disp, dep)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    np.testing.assert_array_equal(
        convert.disparity_to_flow(disp).numpy(),
        np.asarray(jconv.disparity_to_flow(jdisp, random_sign=False)))
    np.testing.assert_array_equal(
        convert.disparity_to_depth(disp).numpy(),
        np.asarray(jconv.disparity_to_depth(jdisp)))
    T1, _, _ = camera.random_motion(d.axisangle, d.translation)
    flow, _ = convert.depth_to_random_flow(t32(dep), T1)
    jflow, _ = jconv.depth_to_random_flow(k_mot, dep)
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow), atol=1e-4)


def test_depth_utils_match_jax():
    r = np.random.default_rng(3)
    d = r.uniform(-5, 140, (3, 1, 12, 10)).astype(np.float32)
    d[0, 0, :2] = 0.0
    d[2] = 100.0                              # no valid pixel at all
    d[1, 0, 0, 0] = 250.0
    got = depth_utils.normalize_depth(t32(d)).numpy()
    for i in range(3):                        # batched: per image
        np.testing.assert_array_equal(
            got[i], np.asarray(jdu.normalize_depth(jnp.asarray(d[i]))))
        np.testing.assert_array_equal(
            depth_utils.normalize_depth(t32(d[i])).numpy(), got[i])
    c = r.integers(0, 256, (12, 10)).astype(np.float32)
    want = np.asarray(jdu.smooth_closer(jnp.asarray(c)))
    np.testing.assert_array_equal(depth_utils.smooth_closer(t32(c)).numpy(),
                                  want)
    np.testing.assert_array_equal(depth_utils.smooth_closer(c), want)
    w_ = r.uniform(0, 101, (1, 12, 10)).astype(np.float32)
    w_[0, :3] = 0.0
    np.testing.assert_array_equal(
        depth_utils.fix_warped_depth(t32(w_)).numpy(),
        np.asarray(jdu.fix_warped_depth(jnp.asarray(w_))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_special_flows_match_jax(seed):
    for horizontal in (False, True):
        got = special_flow.flip_flow(H, W, horizontal)
        want = jsf.flip_flow(H, W, horizontal)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    keys = [jax.random.PRNGKey(seed * 10 + i) for i in range(3)]
    for t, fn in ((6, jsf.rotate_flow), (7, jsf.shear_flow)):
        draws = [jax_augment_draws(k, t, H, W) for k in keys]
        batch = rng.stack_draws(draws)
        if t == 6:
            got = special_flow.rotate_flow(batch.cx, batch.cy,
                                           batch.theta_deg, H, W)
        else:
            got = special_flow.shear_flow(batch.s, H, W)
        for i, k in enumerate(keys):
            want = fn(k, H, W)
            for g, w_ in zip(got, want):
                np.testing.assert_allclose(g[i].numpy(), np.asarray(w_),
                                           atol=1e-4)
        one = (special_flow.rotate_flow(draws[0].cx, draws[0].cy,
                                        draws[0].theta_deg, H, W)
               if t == 6 else special_flow.shear_flow(draws[0].s, H, W))
        np.testing.assert_array_equal(one[0].numpy(), got[0][0].numpy())


def test_draws_follow_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    groups = [rng.draw_group(gen) for _ in range(400)]
    s = torch.stack([g.s for g in groups])
    ang = torch.stack([g.axisangle for g in groups]).abs()
    tr = torch.stack([g.translation for g in groups])
    assert 0.8 <= s.min() and s.max() < 1.1
    assert math.pi / 36 <= ang.min() and ang.max() < math.pi / 18
    assert 0.1 <= tr.abs().min() and tr.abs().max() < 0.2
    assert 0.4 < (tr > 0).float().mean() < 0.6
    rot = [rng.draw_augment(gen, 6, H, W) for _ in range(400)]
    cx = torch.stack([d.cx for d in rot])
    theta = torch.stack([d.theta_deg for d in rot]).abs()
    assert 8 <= theta.min() and theta.max() < 10
    off = (cx - W / 2).abs()        # the pivot lies off the image
    assert W / 2 <= off.min() and off.max() < 3 * W / 4
    sh = torch.stack([rng.draw_augment(gen, 7, H, W).s for _ in range(400)])
    assert 0.2 <= sh.abs().min() and sh.abs().max() < 0.35
    ch = [rng.draw_augment(gen, 1, H, W) for _ in range(300)]
    assert {int(d.channel) for d in ch} == {0, 1, 2}
    v = torch.stack([d.value for d in ch]).abs()
    assert 15 <= v.min() and v.max() < 25
    sc = torch.stack([rng.draw_augment(gen, 0, H, W).scale
                      for _ in range(300)])
    assert 0 <= sc.min() and sc.max() < 1
    for t in (3, 4):
        with pytest.raises(ValueError):
            rng.draw_augment(gen, t, H, W)
    a = tp.draw_sample(torch.Generator().manual_seed(5), H, W)
    b = tp.draw_sample(torch.Generator().manual_seed(5), H, W)
    assert all(torch.equal(x, y) for x, y in zip(a.group, b.group))
    for ra, rb in zip(a.augment, b.augment):
        for da, db in zip(ra, rb):
            assert all(torch.equal(x, y) for x, y in zip(da, db))


# --------------------------------------------------------------------------
# inpaint
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,seed", [(27, 35, 0), (32, 48, 1), (33, 17, 2)])
def test_inpaint_matches_jax(h, w, seed):
    r = np.random.default_rng(seed)
    img = r.uniform(0, 255, (3, h, w)).astype(np.float32)
    valid = (r.uniform(size=(1, h, w)) > 0.3).astype(np.float32)
    valid[:, h // 3:h // 2, w // 4:w // 2] = 0          # a large hole
    coll = ((r.uniform(size=(1, h, w)) > 0.9) * valid).astype(np.float32)
    img = img * valid
    want = np.asarray(jin.inpaint(jnp.asarray(img), jnp.asarray(valid),
                                  jnp.asarray(coll)))
    got = tin.inpaint(t32(img), t32(valid), t32(coll)).numpy()
    m = (valid != coll).astype(np.float32)[0]
    mp = np.asarray(jin._dilate3x3(jnp.asarray(m)))
    keep = (valid[0] * (mp == m)) > 0
    np.testing.assert_array_equal(got[:, keep], want[:, keep])
    d = np.abs(got - want)
    print(f"inpaint {h}x{w}: {int((d > 0).sum())} of {int((~keep).sum()) * 3}"
          " filled values differ (by at most one gray level)")
    assert d.max() <= 1.0
    batched = tin.inpaint(t32(np.stack([img, img[:, ::-1]])),
                          t32(np.stack([valid, valid[:, ::-1]])),
                          t32(np.stack([coll, coll[:, ::-1]]))).numpy()
    np.testing.assert_array_equal(batched[0], got)


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stereo", [False, True])
def test_synthesize_group_matches_jax(stereo):
    img, dep = source(1, stereo)
    key = jax.random.PRNGKey(11)
    want = jp._jit_group(key, jnp.asarray(img), jnp.asarray(dep), stereo)
    got = tp.synthesize_group(t32(img), t32(dep), jax_group_draws(key),
                              stereo)
    for i, (g, w_) in enumerate(zip(got, want)):
        assert_sets_close(g.stacked(), w_.stacked(), [0, 1, 2, 4, 5, 6],
                          f"pair {i}")


def _recorder(calls, name, fn):
    def rec(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((name, args, kwargs, out))
        return out
    return rec


def test_every_warp_and_inpaint_stage_on_jaxs_inputs(monkeypatch):
    """Each forward warp of the group and of a rotate and a shear, fed
    JAX's own inputs for that stage, gives JAX's output bit for bit; each
    inpaint keeps what JAX keeps and fills within one gray level."""
    calls = []
    warp = _recorder(calls, "warp", jfw.forward_warp)
    monkeypatch.setattr(jfw, "forward_warp", warp)   # concat_flow, back_flow
    monkeypatch.setattr(jp, "forward_warp", warp)
    monkeypatch.setattr(jp, "forward_warp_flip", _recorder(
        calls, "flip", jfw.forward_warp_flip))
    monkeypatch.setattr(jp, "inpaint", _recorder(calls, "inpaint",
                                                 jin.inpaint))
    img, dep = source(2)
    key = jax.random.PRNGKey(5)
    pairs = jp.synthesize_group(key, jnp.asarray(img), jnp.asarray(dep))
    for t in (5, 6, 7):
        jp.augment_pair(jax.random.PRNGKey(t), pairs[1], t)
    kinds = [c[0] for c in calls]
    assert kinds.count("warp") == 7 + 5 + 5 + 3 and kinds.count("flip") == 2
    for name, args, kwargs, out in calls:
        t_args = [t32(a) for a in args]
        if name == "inpaint":
            got, out = tin.inpaint(*t_args).numpy(), np.asarray(out)
            valid, coll = (np.asarray(a)[0] for a in args[1:])
            m = (valid != coll).astype(np.float32)
            keep = valid * (np.asarray(jin._dilate3x3(jnp.asarray(m))) == m)
            np.testing.assert_array_equal(got[:, keep > 0], out[:, keep > 0])
            assert np.abs(got - out).max() <= 1.0
            continue
        if name == "warp":
            got = tfw.forward_warp(*t_args)
        else:
            got = tfw.forward_warp_flip(*t_args, **kwargs)
        for g, w_ in zip(got, out):
            np.testing.assert_array_equal(
                g.numpy().view(np.uint32),
                np.asarray(w_, np.float32).view(np.uint32), err_msg=name)


@pytest.mark.parametrize("t", [0, 1, 2, 5, 6, 7])
def test_augment_pair_matches_jax(t):
    """One type over 3 entries, batched as the port runs it, against JAX's
    vmapped program on the same pairs (JAX's own group) and draws."""
    img, dep = source(3)
    pairs = jp._jit_group(jax.random.PRNGKey(7), jnp.asarray(img),
                          jnp.asarray(dep), False)
    keys = jnp.stack([jax.random.PRNGKey(100 * t + i) for i in range(3)])
    rep = jp.Pair(*(jnp.stack([getattr(pairs[i], f) for i in range(3)])
                    for f in jp.Pair._fields))
    want = jp._jit_augment(t)(keys, rep)
    got = tp.augment_pair(tp.Pair(*(t32(x) for x in rep)), t,
                          rng.stack_draws([jax_augment_draws(k, t, H, W)
                                           for k in keys]))
    assert_sets_close(got.set1, want.set1, [0, 1, 2], f"type {t} set1")
    assert_sets_close(got.set2, want.set2, [4, 5, 6], f"type {t} set2")


def test_dead_augment_types_raise():
    img, dep = source(0)
    pair = tp.Pair(*(t32(x)[None] for x in (img, dep, img, dep,
                                            np.zeros((2, H, W)),
                                            np.zeros((2, H, W)))))
    draws = rng.stack_draws([rng.draw_augment(torch.Generator(), 0, H, W)])
    for t in (3, 4):
        with pytest.raises(ValueError):
            tp.augment_pair(pair, t, draws)


@pytest.fixture(scope="module")
def packed():
    """JAX's and the port's packed sample of one image, same draws."""
    img, dep = source(4)
    key = jax.random.PRNGKey(3)
    want = jp.synthesize_sample_packed(key, jnp.asarray(img),
                                       jnp.asarray(dep), False)
    got = tp.synthesize_sample_packed(t32(img), t32(dep),
                                      jax_sample_draws(key, H, W), False)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def test_synthesize_sample_packed_matches_jax(packed):
    want, got = packed
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k
        if k == "aug_types":
            np.testing.assert_array_equal(got[k], want[k])
            continue
        if k.endswith("u8"):     # [..., 3, H, W]: a pixel's 3 channels
            share = differing_share(got[k], want[k], 1.0, channel_axes=3)
        else:                    # one f16 step
            share = differing_share(got[k], want[k], 1e-3, 1e-3)
        print(f"{k}: {100 * share:.3f}% of pixels beyond the tolerance")
        assert share <= BUDGET, (k, share)


def test_synthesize_sample_is_the_packed_sample(packed):
    """The unpacked f32 sample, cast and rearranged, is the packed one."""
    _, got = packed
    img, dep = source(4)
    full = tp.synthesize_sample(t32(img), t32(dep),
                                jax_sample_draws(jax.random.PRNGKey(3), H, W))
    s1, s2 = full["aug_set1"], full["aug_set2"]
    geo = list(tp.GEO_POSITIONS)
    pho = list(tp.PHO_POSITIONS)
    np.testing.assert_array_equal(got["group_f16"],
                                  full["group"].half().numpy())
    np.testing.assert_array_equal(
        got["geo_img_u8"][:, :, 0], tp._u8(s1[:, geo, 0:3]).numpy())
    np.testing.assert_array_equal(
        got["geo_flt_f16"][:, :, 1, 1:3], s2[:, geo, 0:2].half().numpy())
    np.testing.assert_array_equal(
        got["pho_img_u8"][:, :, 1], tp._u8(s2[:, pho, 4:7]).numpy())
    np.testing.assert_array_equal(
        got["pairs_flt_f16"], torch.cat([full["pairs"][:, 3:4],
                                         full["pairs"][:, 7:8],
                                         full["pairs"][:, 8:12]], 1)
        .half().numpy())


def test_unpacked_writer_matches_jax(tmp_path):
    """``write_sample`` of ``synthesize_sample``'s f32 tensors: the same
    61 files, keys and arrays as the JAX package's ``write_sample``, and
    the same arrays as the packed path writes."""
    img, dep = source(6)
    draws = tp.draw_sample(torch.Generator().manual_seed(1), H, W)
    full = {k: v.numpy() for k, v in tp.synthesize_sample(
        t32(img), t32(dep), draws).items()}
    packed = {k: v.numpy() for k, v in tp.synthesize_sample_packed(
        t32(img), t32(dep), draws).items()}
    assert writer.write_sample(str(tmp_path / "port"), "s", full) == 61
    jwriter.write_sample(str(tmp_path / "jax"), "s", full)
    writer.write_sample_packed(str(tmp_path / "packed"), "s", packed)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert sorted(os.listdir(tmp_path / "packed")) == names
    for name in names:
        with np.load(tmp_path / "jax" / name) as a, \
                np.load(tmp_path / "port" / name) as b, \
                np.load(tmp_path / "packed" / name) as c:
            assert sorted(a.files) == sorted(b.files) == sorted(c.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=name + k)
                np.testing.assert_array_equal(b[k], c[k], err_msg=name + k)


@pytest.mark.parametrize("flow_int16", [False, True])
def test_writer_matches_jax(packed, tmp_path, flow_int16):
    _, sample = packed
    jwriter.write_sample_packed(str(tmp_path / "jax"), "s", sample,
                                flow_int16=flow_int16)
    n = writer.write_sample_packed(str(tmp_path / "port"), "s", sample,
                                   flow_int16=flow_int16)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert n == 61 and sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        with np.load(tmp_path / "jax" / name) as a, \
                np.load(tmp_path / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=name + k)
    pool = writer.ShardWriter(str(tmp_path / "pool"), workers=3,
                              flow_int16=flow_int16)
    pool.submit("s", sample)
    assert pool.drain() == 61
    for name in names:
        with np.load(tmp_path / "pool" / name) as a, \
                np.load(tmp_path / "port" / name) as b:
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------
# the source readers and the CLI
# --------------------------------------------------------------------------

def _smooth_rgb(h, w, i):
    r = np.random.default_rng(i)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.clip(np.stack([np.sin(xx / 9 + i + c) * np.cos(yy / 11) * 90
                             + 120 for c in range(3)], -1)
                   + r.uniform(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def _closeness(h, w, i):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.clip(120 + 60 * np.sin(xx / 23 + i) * np.cos(yy / 31), 0,
                   255).astype(np.uint8)


def write_redweb(root, n, h, w):
    from PIL import Image
    os.makedirs(os.path.join(root, "Imgs"))
    os.makedirs(os.path.join(root, "RDs"))
    for i in range(n):
        Image.fromarray(_smooth_rgb(h, w, i)).save(
            os.path.join(root, "Imgs", f"s{i}.jpg"), quality=90)
        Image.fromarray(_closeness(h, w, i)).save(
            os.path.join(root, "RDs", f"s{i}.png"))
    lst = os.path.join(root, "list.txt")
    with open(lst, "w") as f:
        f.write("".join(f"s{i}.jpg\n" for i in range(n)))
    return lst


def write_diml(root, n, h, w):
    from PIL import Image

    from opticalflowfromdepth_torch.data.frame_io import write_png16
    base = os.path.join(root, "train", "LR")
    for sub in ("outleft", "outright", "disparity"):
        os.makedirs(os.path.join(base, sub))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n):
        Image.fromarray(_smooth_rgb(h, w, i)).save(
            os.path.join(base, "outleft", f"d{i}.png"))
        Image.fromarray(_smooth_rgb(h, w, i + 7)).save(
            os.path.join(base, "outright", f"d{i}.png"))
        disp = (120 + 100 * np.sin(xx / 17 + i) * np.cos(yy / 19)) * 4
        write_png16(os.path.join(base, "disparity", f"d{i}.png"),
                    disp.astype(np.uint16))
    lst = os.path.join(root, "list.txt")
    with open(lst, "w") as f:
        f.write("".join(f"d{i}.png\n" for i in range(n)))
    return lst


@pytest.fixture
def cv2_ipp():
    cv2 = pytest.importorskip("cv2")
    before = cv2.ipp.useIPP()
    yield cv2
    cv2.ipp.setUseIPP(before)


@pytest.mark.parametrize("hw,size", [((37, 53), (29, 31)),
                                     ((30, 41), (48, 64)),
                                     ((96, 128), (48, 64)),
                                     ((24, 32), (48, 64))],
                         ids=["down", "up", "down 2x", "up 2x"])
def test_resize_matches_cv2(cv2_ipp, hw, size):
    """The port's numpy resize against ``cv2.resize(INTER_LINEAR)`` (what
    the JAX package's ``_resize_chw`` calls) on f32, gray and RGB: exact
    with cv2's own code (IPP off); cv2 through Intel IPP (on by default
    where cv2 is built with it, as the opencv-python wheels are) adds in
    another order: within 1e-5 of the largest value (printed)."""
    from opticalflowfromdepth_tpu.data.source import _resize_chw as jresize

    from opticalflowfromdepth_torch.data.source import _resize_chw
    r = np.random.default_rng(0)
    for c in (3, 1):
        x = r.uniform(0, 255, (c, *hw)).astype(np.float32)
        got = _resize_chw(x, size)
        assert got.shape == (c, *size) and got.dtype == np.float32
        cv2_ipp.ipp.setUseIPP(False)
        np.testing.assert_array_equal(got, jresize(x, size))
        cv2_ipp.ipp.setUseIPP(True)
        d = float(np.abs(got - jresize(x, size)).max())
        print(f"resize {hw} -> {size}, C = {c}: max |d| against cv2 with "
              f"IPP {d:.3g} ({d / 255:.3g} of 255)")
        assert d <= 1e-5 * 255


def test_source_readers_match_jaxs_cv2_readers(cv2_ipp, tmp_path):
    """Closeness map and 16-bit disparity exactly; the JPEG decode within
    2 gray levels (Pillow's and cv2's libjpeg builds differ: measured,
    printed); the PNG image exactly; whole samples of both datasets."""
    from opticalflowfromdepth_tpu.data import source as jsource

    from opticalflowfromdepth_torch.data import source
    h, w = 40, 56
    lst = write_redweb(str(tmp_path / "r"), 2, h, w)
    cv2_ipp.ipp.setUseIPP(False)       # exact resizes, see above
    for i in range(2):
        rd = str(tmp_path / "r" / "RDs" / f"s{i}.png")
        np.testing.assert_array_equal(source.read_relative_depth_chw(rd),
                                      jsource.read_relative_depth_chw(rd))
        jpg = str(tmp_path / "r" / "Imgs" / f"s{i}.jpg")
        d = np.abs(source.read_img_chw(jpg) - jsource.read_img_chw(jpg))
        print(f"JPEG s{i}: Pillow vs cv2 max {d.max():.0f} gray levels, "
              f"{100 * (d > 0).mean():.2f}% of values differ")
        assert d.max() <= 2
    ours = source.ReDWeb(str(tmp_path / "r"), lst)
    theirs = jsource.ReDWeb(str(tmp_path / "r"), lst)
    assert len(ours) == len(theirs) == 2
    np.testing.assert_array_equal(ours[1].depth_or_disp,
                                  theirs[1].depth_or_disp)
    lst = write_diml(str(tmp_path / "d"), 1, h, w)
    a, b = source.DIML(str(tmp_path / "d"), lst)[0], \
        jsource.DIML(str(tmp_path / "d"), lst)[0]
    assert a.is_stereo and b.is_stereo and a.name == b.name
    for x, y in ((a.img0, b.img0), (a.img1, b.img1),
                 (a.depth_or_disp, b.depth_or_disp)):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


def _read_shards(out):
    files = sorted(os.listdir(out))
    data = {}
    for f in files:
        with np.load(os.path.join(out, f)) as z:
            data[f] = {k: z[k] for k in z.files}
    return data


KEYS = {"img0_1", "img1_1", "depth0_1", "depth1_1", "flow_1", "back_flow_1",
        "img0_2", "img1_2", "depth0_2", "depth1_2", "flow_2", "back_flow_2",
        "label"}


@pytest.mark.parametrize("dataset", ["ReDWeb", "DIML"])
def test_synth_cli_end_to_end(tmp_path, dataset):
    """The port's counterpart of ``tests/test_cli_smoke.py:
    test_synth_cli_end_to_end`` on the CPU: a fake tree -> the source
    reader -> synthesis at 48x64 -> the writer's threads -> shards that
    the port's ``AugmentedShards`` reads. An image's shards do not depend
    on ``--split``."""
    write = write_redweb if dataset == "ReDWeb" else write_diml
    lst = write(str(tmp_path / "src"), 2, 60, 80)
    common = ["--dataset", dataset, "--data_root", str(tmp_path / "src"),
              "--list_file", lst, "--height", str(H), "--width", str(W),
              "--epochs", "1", "--write_workers", "2", "--device", "cpu"]
    res = cli.main(common + ["--out", str(tmp_path / "all")])
    assert res["images"] == 2 and res["files"] == 122
    data = _read_shards(tmp_path / "all")
    assert len(data) == 122
    assert sum(f.endswith("_group.npz") for f in data) == 2
    for f, arrays in data.items():
        if f.endswith("_group.npz"):
            assert arrays["group"].shape == (44, H, W)
            continue
        assert set(arrays) == KEYS, f
        a = int(f.rsplit("_a", 1)[1].split(".")[0])
        assert int(arrays["label"]) == tp.AUGMENT_SCHEDULE[a]
        for k, v in arrays.items():
            if k.startswith("img"):
                assert v.dtype == np.uint8 and v.shape == (H, W, 3)
            elif k.startswith("depth"):
                assert v.dtype == np.float16 and v.shape == (H, W)
            elif "flow" in k:
                assert v.dtype == np.float16 and v.shape == (H, W, 2)
                assert np.isfinite(v).all()
    res = cli.main(common + ["--out", str(tmp_path / "half"), "--split",
                             "2", "--split_id", "1", "--flow_int16"])
    half = _read_shards(tmp_path / "half")
    assert res["files"] == len(half) == 61
    for f, arrays in half.items():
        for k, v in arrays.items():
            want = data[f][k]
            if "flow" in k:
                assert v.dtype == np.int16
                want = np.clip(np.round(want.astype(np.float32) * 64),
                               -32768, 32767)
            np.testing.assert_array_equal(v, want, err_msg=f + k)
    ds = AugmentedShards(str(tmp_path / "all"), crop_size=(32, 48), seed=0)
    assert len(ds) == 2 * 120
    s = ds[3]
    assert s["image1"].shape == (32, 48, 3) and s["flow"].shape == (32, 48, 2)
    assert np.isfinite(s["flow"]).all() and s["label"].sum() == 1


def test_synth_cli_takes_no_card_it_does_not_have(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lst = write_redweb(str(tmp_path / "src"), 1, 20, 24)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--dataset", "ReDWeb", "--data_root", str(tmp_path / "src"),
                  "--list_file", lst, "--out", str(tmp_path / "o")])
