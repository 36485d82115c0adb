"""The port's inference entry points on the CPU.

``raft_infer_fn`` and ``gmflow_infer_fn`` with ``InputPadder`` against the
JAX ones on a 60x90 pair that needs padding, same weights; the occlusion
check and directory inference (bidirectional, occlusion masks) against
the JAX ones; the directory CLI end to end for both models; and no silent
CPU run when the card is asked for.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from opticalflowfromdepth_tpu.eval.infer import gmflow_infer_fn as j_gm_infer
from opticalflowfromdepth_tpu.eval.infer import raft_infer_fn as j_infer_fn
from opticalflowfromdepth_tpu.eval.inference import \
    inference_on_dir as j_inference_on_dir
from opticalflowfromdepth_tpu.eval.occlusion import \
    forward_backward_consistency_check as j_fb_check
from opticalflowfromdepth_tpu.eval.padder import InputPadder as JPadder
from opticalflowfromdepth_tpu.models.gmflow import GMFlow as JGMFlow
from opticalflowfromdepth_tpu.models.raft import RAFT as JRAFT
from opticalflowfromdepth_torch.eval import cli
from opticalflowfromdepth_torch.eval.infer import (gmflow_infer_fn,
                                                   raft_infer_fn)
from opticalflowfromdepth_torch.eval.inference import inference_on_dir
from opticalflowfromdepth_torch.eval.occlusion import \
    forward_backward_consistency_check
from opticalflowfromdepth_torch.eval.padder import InputPadder
from opticalflowfromdepth_torch.models.gmflow import GMFlow
from opticalflowfromdepth_torch.models.raft import RAFT
from opticalflowfromdepth_torch.weights import (gmflow_state_dict_from_flax,
                                                raft_state_dict_from_flax)

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
def test_input_padder_matches_jax(mode):
    x = np.random.default_rng(0).uniform(0, 255, (1, 60, 90, 3)).astype(
        np.float32)
    got, want = InputPadder(x.shape, mode).pad(x), JPadder(x.shape, mode).pad(x)
    assert got[0].shape == (1, 64, 96, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(InputPadder(x.shape, mode).unpad(got[0]), x)


def test_raft_infer_fn_on_padded_pair_matches_jax():
    rng = np.random.default_rng(1)
    i1, i2 = (rng.uniform(0, 255, (1, 60, 90, 3)).astype(np.float32)
              for _ in range(2))
    dummy = jnp.zeros((1, 64, 96, 3), jnp.float32)
    jmodel = JRAFT(small=True, corr_impl="fused")
    v = jax.jit(functools.partial(jmodel.init, iters=1, train=False))(
        jax.random.PRNGKey(3), dummy, dummy)
    # halved He-normal weights keep each GRU step's flow update small, so
    # f32 rounding is not amplified past the tolerance (test_torch_raft)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) * 0.5, v)

    model = RAFT(small=True, corr_impl="fused")
    model.load_state_dict(raft_state_dict_from_flax(v["params"], None, True),
                          strict=True)
    padder = InputPadder(i1.shape)
    a, b = padder.pad(i1, i2)
    low, up = raft_infer_fn(model, iters=2, with_low_res=True,
                            device="cpu")(a, b)
    assert isinstance(up, np.ndarray) and up.shape == (1, 64, 96, 2)
    assert low.shape == (1, 8, 12, 2)
    assert padder.unpad(up).shape == (1, 60, 90, 2)

    jlow, jup = j_infer_fn(jmodel, v, iters=2, with_low_res=True)(a, b)
    np.testing.assert_allclose(up, np.asarray(jup), atol=2e-4)
    np.testing.assert_allclose(low, np.asarray(jlow), atol=2e-4)


def test_cuda_request_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        raft_infer_fn(RAFT(small=True), device="cuda")


def test_cli_inference_dir_writes_flow(tmp_path):
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (60, 90, 3), np.uint8)).save(
            frames / f"f{i}.png")
    ckpt = tmp_path / "raft_small.pth"
    model = RAFT(small=True, generator=torch.Generator().manual_seed(0))
    torch.save({"model": {f"module.{k}": t
                          for k, t in model.state_dict().items()}}, ckpt)
    out = tmp_path / "out"
    cli.main(["--model", "raft", "--small", "--ckpt", str(ckpt),
              "--inference_dir", str(frames), "--output_path", str(out),
              "--iters", "2", "--device", "cpu", "--save_flo_flow"])
    for i in range(2):
        with Image.open(out / f"f{i}_flow.png") as im:
            assert im.size == (90, 60)
        data = np.fromfile(out / f"f{i}_pred.flo", np.float32)
        assert data[0] == np.float32(202021.25)
        flow = data[3:].reshape(60, 90, 2)
        assert np.isfinite(flow).all()
    assert not (out / "f2_flow.png").exists()


@functools.lru_cache(maxsize=None)
def _gmflow_pair():
    """The JAX GMFlow (1 scale) with its variables, and the port's with
    the same weights."""
    dummy = jnp.zeros((1, 64, 96, 3), jnp.float32)
    jmodel = JGMFlow(num_scales=1)
    v = jax.jit(functools.partial(
        jmodel.init, attn_splits_list=(2,), corr_radius_list=(-1,),
        prop_radius_list=(-1,)))(jax.random.PRNGKey(5), dummy, dummy)
    model = GMFlow(num_scales=1)
    model.load_state_dict(gmflow_state_dict_from_flax(v["params"]),
                          strict=True)
    return jmodel, v, model


def _smooth_frames(n, seed):
    """n smooth uint8 frames of 60x90 (bilinear upsampled 8x12 noise)."""
    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.uniform(0, 255, (n, 3, 8, 12)).astype(
        np.float32))
    up = torch.nn.functional.interpolate(low, size=(60, 90), mode="bilinear",
                                         align_corners=False)
    return up.permute(0, 2, 3, 1).round().clamp(0, 255).numpy().astype(
        np.uint8)


@pytest.mark.parametrize("bidir", [False, True])
def test_gmflow_infer_fn_on_padded_pair_matches_jax(bidir):
    """60x90 padded to 64x96 (padding factor 16, so H/8 splits in 2), f32:
    the final flow within 2e-2 px of the JAX ``gmflow_infer_fn``."""
    jmodel, v, model = _gmflow_pair()
    i1, i2 = (f[None].astype(np.float32) for f in _smooth_frames(2, 3))
    padder = InputPadder(i1.shape, padding_factor=16)
    a, b = padder.pad(i1, i2)
    got = gmflow_infer_fn(model, pred_bidir_flow=bidir, device="cpu")(a, b)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (2 if bidir else 1, 64, 96, 2)
    assert padder.unpad(got).shape[1:] == (60, 90, 2)
    want = np.asarray(j_gm_infer(jmodel, v, pred_bidir_flow=bidir)(a, b))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_forward_backward_consistency_check_matches_jax():
    """The UnFlow occlusion masks from the same flows (smooth, with a band
    that moves): the same masks, bit for bit, and some of each value."""
    rng = np.random.default_rng(4)
    low = torch.from_numpy(rng.normal(0, 6, (2, 2, 6, 8)).astype(np.float32))
    flows = torch.nn.functional.interpolate(low, size=(48, 64),
                                            mode="bilinear",
                                            align_corners=False)
    fwd = flows[0:1].permute(0, 2, 3, 1).contiguous()
    bwd = -fwd.clone()
    bwd[:, 10:20] = flows[1:2].permute(0, 2, 3, 1)[:, 10:20]
    got = forward_backward_consistency_check(fwd, bwd)
    want = j_fb_check(jnp.asarray(fwd.numpy()), jnp.asarray(bwd.numpy()))
    for g_, w_ in zip(got, want):
        assert g_.shape == (1, 48, 64) and g_.dtype == torch.float32
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
        assert 0 < float(g_.mean()) < 1


def test_inference_on_dir_bidir_occlusion_matches_jax(tmp_path):
    """Bidirectional prediction with the occlusion check and ``.flo``
    output: the same five files per pair as the JAX version; ``.flo``
    within 2e-2 px; the colour images and the occlusion masks differing
    (by more than 2 levels) in at most 0.5% of pixels: a flow within 2e-2
    px of the other may fall on the other side of the occlusion threshold,
    and where a flow is near 0 its colour's hue follows its angle."""
    jmodel, v, model = _gmflow_pair()
    frames = tmp_path / "frames"
    frames.mkdir()
    for i, f in enumerate(_smooth_frames(3, 6)):
        Image.fromarray(f).save(frames / f"f{i}.png")
    kw = dict(padding_factor=16, save_flo_flow=True, pred_bidir_flow=True,
              fwd_bwd_consistency_check=True)
    n = inference_on_dir(gmflow_infer_fn(model, pred_bidir_flow=True,
                                         device="cpu"),
                         str(frames), str(tmp_path / "port"), **kw)
    j_inference_on_dir(j_gm_infer(jmodel, v, pred_bidir_flow=True),
                       str(frames), str(tmp_path / "jax"), **kw)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert n == 2 and len(names) == 10
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for name in names:
        a, b = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".flo"):
            np.testing.assert_allclose(np.fromfile(a, np.float32),
                                       np.fromfile(b, np.float32), atol=2e-2)
            continue
        with Image.open(a) as ia, Image.open(b) as ib:
            x, y = np.asarray(ia, np.int32), np.asarray(ib, np.int32)
        assert x.shape == y.shape and x.shape[:2] == (60, 90)
        assert (np.abs(x - y) > 2).mean() <= 5e-3, name


def test_cli_gmflow_bidir_writes_flow_and_occlusion(tmp_path):
    frames = tmp_path / "frames"
    frames.mkdir()
    for i, f in enumerate(_smooth_frames(2, 7)):
        Image.fromarray(f).save(frames / f"f{i}.png")
    ckpt = tmp_path / "gmflow.pth"
    model = GMFlow(generator=torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict()}, ckpt)
    out = tmp_path / "out"
    cli.main(["--model", "gmflow", "--ckpt", str(ckpt), "--inference_dir",
              str(frames), "--output_path", str(out), "--device", "cpu",
              "--padding_factor", "16", "--save_flo_flow",
              "--pred_bidir_flow", "--fwd_bwd_consistency_check"])
    assert sorted(p.name for p in out.iterdir()) == sorted(
        f"f0{s}" for s in ("_flow.png", "_pred.flo", "_flow_bwd.png",
                           "_occ.png", "_occ_bwd.png"))
    flow = np.fromfile(out / "f0_pred.flo", np.float32)[3:]
    assert flow.size == 60 * 90 * 2 and np.isfinite(flow).all()


def test_occlusion_check_needs_bidir(tmp_path):
    with pytest.raises(ValueError, match="pred_bidir_flow"):
        inference_on_dir(lambda a, b: a, str(tmp_path), str(tmp_path / "o"),
                         fwd_bwd_consistency_check=True)


def test_gmflow_cuda_request_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gmflow_infer_fn(GMFlow(), device="cuda")
