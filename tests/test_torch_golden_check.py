"""The port's golden-number harness (``tools/golden_check.py``) on the
CPU: its tables against the JAX package's, ``run_check`` on fake
validators, checkpoints (a reference-named ``.pth`` and an ``.npz`` of the
JAX model's flax parameters) served against the JAX model, and the CLI's
exit code. The released checkpoints and the benchmark datasets are not in
the repository, so no golden run happens here.

Flow tolerance: 2e-2 px, the GMFlow end-to-end one of
``tests/test_torch_gmflow.py`` (f32 both sides, 64x96 smooth images).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import traverse_util

from opticalflowfromdepth_torch.tools import golden_check as gc
from opticalflowfromdepth_torch.weights import gmflow_state_dict_from_flax
from opticalflowfromdepth_tpu.models.gmflow import GMFlow as JGMFlow
from opticalflowfromdepth_tpu.tools import golden_check as jgc

torch.set_num_threads(2)
H, W = 64, 96


def test_tables_equal_jax():
    assert gc.GOLDEN == jgc.GOLDEN
    assert gc.RECIPES == jgc.RECIPES
    assert set(gc.VALIDATORS) == set(jgc.VALIDATORS)
    # values transcribed from adjusted_gmflow/scripts/evaluate.sh:8-36
    assert gc.GOLDEN["gmflow"]["things_clean"] == 3.475
    assert gc.GOLDEN["gmflow_refine"]["sintel_final"] == 2.475


def test_run_check_assertion_semantics(monkeypatch):
    fake = {"things_clean": lambda f, r, p: 3.49,   # within 0.03
            "sintel_clean": lambda f, r, p: 1.60}   # off by 0.105
    results = []
    for mod in (gc, jgc):
        monkeypatch.setattr(mod, "VALIDATORS", fake)
        results.append(mod.run_check(
            "gmflow", infer_fn=None, padding_factor=16, data_root="x",
            dataset_keys=["things_clean", "sintel_clean"], tol=0.03))
    res = results[0]
    assert res == results[1]
    assert res["things_clean"]["ok"] and not res["sintel_clean"]["ok"]
    assert res["sintel_clean"]["abs_err"] == pytest.approx(0.105)
    got = gc.run_check("gmflow", None, 16, "x", ["things_clean"], 0.03,
                       golden={"things_clean": 3.49})
    assert got["things_clean"]["abs_err"] == 0.0


@functools.lru_cache(maxsize=None)
def _jax_params():
    model = JGMFlow(num_scales=1, upsample_factor=8)
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    v = jax.jit(functools.partial(
        model.init, attn_splits_list=(2,), corr_radius_list=(-1,),
        prop_radius_list=(-1,)))(jax.random.PRNGKey(3), dummy, dummy)
    return jax.tree_util.tree_map(np.asarray, v["params"])


def _images():
    rng = np.random.default_rng(0)
    low = torch.from_numpy(rng.uniform(0, 255, (2, 3, 8, 12)).astype(
        np.float32))
    img = F.interpolate(low, size=(H, W), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    return np.ascontiguousarray(img[:1]), np.ascontiguousarray(img[1:])


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The JAX model's parameters as a flax .npz and a reference-named
    .pth."""
    d = tmp_path_factory.mktemp("ckpt")
    params = _jax_params()
    flat = traverse_util.flatten_dict(params, sep="/")
    npz = str(d / "gmflow.npz")
    np.savez(npz, **{f"params/{k}": v for k, v in flat.items()})
    pth = str(d / "gmflow.pth")
    torch.save({"model": gmflow_state_dict_from_flax(params, 1)}, pth)
    return npz, pth


def test_checkpoints_serve_the_jax_flow(checkpoints):
    """Both checkpoints load into the port's GMFlow (strict), give the
    same weights, and serve the JAX harness's flow within 2e-2 px."""
    npz, pth = checkpoints
    sd_npz = gc.load_params(npz, num_scales=1)
    sd_pth = gc.load_params(pth, num_scales=1)
    assert set(sd_npz) == set(sd_pth)
    for k in sd_npz:
        np.testing.assert_array_equal(sd_npz[k].numpy(), sd_pth[k].numpy())
    jparams = jgc.load_params(npz, num_scales=1)
    jinfer, jpf = jgc.make_infer_fn("gmflow", jparams)
    im1, im2 = _images()
    want = np.asarray(jinfer(im1, im2))
    for sd in (sd_npz, sd_pth):
        infer, pf = gc.make_infer_fn("gmflow", sd, device="cpu")
        assert pf == jpf == 16
        got = infer(im1, im2)
        assert got.shape == want.shape == (1, H, W, 2)
        err = np.abs(got - want).max()
        assert err <= 2e-2, f"max |flow diff| {err:.3e} px"


def test_npz_with_foreign_keys_raises(tmp_path):
    path = str(tmp_path / "bad.npz")
    np.savez(path, **{"batch_stats/x/mean": np.zeros(3)})
    with pytest.raises(ValueError, match="params"):
        gc.load_params(path, num_scales=1)


def test_cli_exit_code_on_fakes(checkpoints, monkeypatch, capsys):
    """The CLI exits 1 when a metric is off, and returns (exit 0) when all
    are within --tol; the fakes call the real model once each."""
    _, pth = checkpoints
    im1, im2 = _images()
    calls = []

    def fake(value):
        def v(infer_fn, root, pf):
            calls.append((root, pf, infer_fn(im1, im2).shape))
            return value
        return v

    golden = gc.GOLDEN["gmflow"]
    monkeypatch.setattr(gc, "VALIDATORS", {
        "things_clean": fake(golden["things_clean"] + 0.01),
        "sintel_clean": fake(golden["sintel_clean"] - 0.2),
        "sintel_final": fake(golden["sintel_final"])})
    argv = ["--model", "gmflow", "--ckpt", pth, "--data_root", "root",
            "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        gc.main(argv)
    assert e.value.code == 1
    assert '"ok": false' in capsys.readouterr().out
    res = gc.main(argv + ["--datasets", "things_clean,sintel_final"])
    assert set(res) == {"things_clean", "sintel_final"}
    assert all(r["ok"] for r in res.values())
    assert calls and all(c == ("root", 16, (1, H, W, 2)) for c in calls)
    with pytest.raises(SystemExit) as e:
        gc.main(argv + ["--datasets", "things_clean", "--tol", "0.005"])
    assert e.value.code == 1


def test_cli_defaults_to_the_card(monkeypatch):
    seen = {}

    def record(model_name, state_dict, device="cuda"):
        seen["device"] = device
        raise RuntimeError("stop")
    monkeypatch.setattr(gc, "load_params", lambda ckpt, n: {})
    monkeypatch.setattr(gc, "make_infer_fn", record)
    with pytest.raises(RuntimeError, match="stop"):
        gc.main(["--model", "gmflow", "--ckpt", "x.pth"])
    assert seen["device"] == "cuda"
