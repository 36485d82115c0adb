"""The port's tools on the CPU: ``tools/convergence_smoke.py`` (its
procedural source bit-equal to the JAX tool's; ``main`` at a tiny size
prints one JSON line with finite EPEs, and its exit code follows ``ok``)
and ``tools/flow_range.py`` on shards the port's synthesis wrote."""

import json

import numpy as np
import pytest
import torch

from opticalflowfromdepth_torch.tools import convergence_smoke as tcs
from opticalflowfromdepth_torch.tools import flow_range

torch.set_num_threads(2)


@pytest.mark.parametrize("seed,h,w", [(0, 48, 64), (3, 128, 160)])
def test_procedural_sample_matches_jax(seed, h, w):
    from opticalflowfromdepth_tpu.tools import convergence_smoke as jcs
    got = tcs.procedural_sample(np.random.default_rng(seed), h, w)
    want = jcs.procedural_sample(np.random.default_rng(seed), h, w)
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype and g.shape == wnt.shape
        np.testing.assert_array_equal(g, wnt)
    assert got[0].shape == (3, h, w) and got[1].shape == (1, h, w)


TINY = ["--device", "cpu", "--images", "1", "--height", "48", "--width",
        "64", "--crop_h", "32", "--crop_w", "48", "--steps", "2",
        "--batch_size", "2", "--iters", "2"]


def _json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def test_convergence_smoke_prints_its_result_and_exits_by_ok(tmp_path,
                                                             capsys):
    shard_dir = str(tmp_path / "shards")
    res = tcs.main(TINY + ["--shard_dir", shard_dir, "--epe_ratio", "1e9"])
    line = _json_line(capsys.readouterr().out)
    assert line == res and res["ok"] is True and res["steps"] == 2
    assert np.isfinite(res["initial_epe"]) and np.isfinite(res["final_epe"])
    assert "classifier_acc_final" not in res
    # the same shards again (reused), with the classifier's phase, now held
    # to a ratio no run can meet
    with pytest.raises(SystemExit) as e:
        tcs.main(TINY + ["--shard_dir", shard_dir, "--epe_ratio", "0",
                         "--with_classifier", "--classifier_steps", "2"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "synthesized" not in out
    line = _json_line(out)
    assert line["ok"] is False
    for k in ("classifier_acc_initial", "classifier_acc_final",
              "classify_loss_first", "classify_loss_last"):
        assert np.isfinite(line[k]), k


def test_heldout_pairs_are_the_groups_first_pair():
    pairs = tcs.heldout_pairs(2, 32, 48, device="cpu")
    assert len(pairs) == 2
    for img0, img1, flow in pairs:
        assert img0.shape == img1.shape == (32, 48, 3)
        assert flow.shape == (32, 48, 2) and np.isfinite(flow).all()
        assert np.abs(flow[..., 1]).max() == 0     # virtual stereo: x only


def test_flow_range_on_the_ports_shards(tmp_path, capsys):
    root = str(tmp_path / "redweb")
    assert tcs.synthesize_shards(root, 1, 48, 64, device="cpu") == 61
    flow_range.main(["--stage", "augmentedredweb", "--redweb_shards", root,
                     "--crop_size", "32", "48", "--samples", "6"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("samples=6 pixels=")
    shares = [float(ln.rsplit(":", 1)[1].strip(" %")) for ln in out[1:]]
    assert len(shares) == 9 and abs(sum(shares) - 100.0) < 0.1
