"""The port's inference entry points on the CPU.

``raft_infer_fn`` with ``InputPadder`` against the JAX ones on a 60x90
pair that needs padding, same weights; the directory CLI end to end; and
no silent CPU run when the card is asked for.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from opticalflowfromdepth_tpu.eval.infer import raft_infer_fn as j_infer_fn
from opticalflowfromdepth_tpu.eval.padder import InputPadder as JPadder
from opticalflowfromdepth_tpu.models.raft import RAFT as JRAFT
from opticalflowfromdepth_torch.eval import cli
from opticalflowfromdepth_torch.eval.infer import raft_infer_fn
from opticalflowfromdepth_torch.eval.padder import InputPadder
from opticalflowfromdepth_torch.models.raft import RAFT
from opticalflowfromdepth_torch.weights import raft_state_dict_from_flax

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
