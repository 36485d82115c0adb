"""The port's training CLI end to end on the CPU (as
``tests/test_cli_smoke.py`` drives the JAX package's): shards written by
the port's synthesis (64x96) -> ``fetch_train_dataset`` (re-augmented) ->
``Loader`` -> ``TrainRunner`` -> the ``latest`` and weights checkpoints,
``args.json`` and the ``_parameters`` sidecar -> ``--resume`` ->
``--restore_weights``; ``--stage mixed`` with the frozen classifier from a
``.pth`` that ``train/classifier_train.py`` wrote; one GMFlow step at a
narrow width. RAFT-small at 32x48, 2 iterations, f32.
"""

import functools
import os

import pytest
import torch

from opticalflowfromdepth_torch.train import cli

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    from opticalflowfromdepth_torch.tools.convergence_smoke import \
        synthesize_shards
    roots = {}
    for k, (n, seed) in (("redweb", (2, 0)), ("diml", (1, 5))):
        roots[k] = str(tmp_path_factory.mktemp(k))
        synthesize_shards(roots[k], n, 64, 96, seed=seed, device="cpu")
    return roots


def _args(log_dir, *extra):
    return ["--model", "raft", "--small", "--batch_size", "4",
            "--image_size", "32", "48", "--iters", "2",
            "--no_mixed_precision", "--num_workers", "1",
            "--log_dir", str(log_dir), "--device", "cpu", *extra]


def test_train_cli_trains_checkpoints_and_resumes(shards, tmp_path, capsys):
    log_dir = tmp_path / "run"
    common = _args(log_dir, "--stage", "augmentedredweb", "--redweb_shards",
                   shards["redweb"], "--save_latest_freq", "2",
                   "--save_ckpt_freq", "4", "--val", "sintel",
                   "--val_freq", "4", "--data_root", str(tmp_path / "none"))
    state = cli.main(common + ["--num_steps", "4"])
    assert state.step == 4 and state.optimizer.count == 4
    ckpts = log_dir / "checkpoints"
    assert (ckpts / "latest.pth").exists()
    assert (ckpts / "step_4_weights.pth").exists()
    assert (log_dir / "args.json").exists()
    n = sum(p.numel() for p in state.model.parameters())
    assert (log_dir / f"{n}_parameters").exists()
    # a validation dataset that is missing is logged and skipped
    assert "validator sintel skipped" in capsys.readouterr().out

    resumed = cli.main(common + ["--num_steps", "8", "--resume",
                                 str(ckpts / "latest.pth")])
    assert resumed.step == 8 and resumed.optimizer.count == 8
    assert (ckpts / "step_8_weights.pth").exists()

    # weights only: the model starts from the file, the optimizer at 0
    warm = cli.main(_args(tmp_path / "warm", "--stage", "augmentedredweb",
                          "--redweb_shards", shards["redweb"],
                          "--num_steps", "0", "--restore_weights",
                          str(ckpts / "step_8_weights.pth")))
    saved = torch.load(ckpts / "step_8_weights.pth", weights_only=True)
    assert warm.step == 0 and warm.optimizer.count == 0
    for k, t in warm.model.state_dict().items():
        torch.testing.assert_close(t, saved[k], rtol=0, atol=0)


def test_train_cli_mixed_with_the_frozen_classifier(shards, tmp_path):
    from opticalflowfromdepth_torch.train import classifier_train as ct
    from opticalflowfromdepth_torch.train.state import save_weights

    cstate = ct.init_state(ct.ClassifierTrainConfig(mixed_precision=False),
                           seed=2, device="cpu")
    ckpt = save_weights(str(tmp_path), cstate.model, "classifier")
    before = {k: v.clone() for k, v in cstate.model.state_dict().items()}
    common = _args(tmp_path / "mixed", "--stage", "mixed",
                   "--redweb_shards", shards["redweb"], "--diml_shards",
                   shards["diml"], "--add_classifier")
    with pytest.raises(SystemExit):
        cli.main(common + ["--num_steps", "1"])      # no checkpoint given
    state = cli.main(common + ["--classifier_ckpt", ckpt, "--num_steps",
                               "2", "--save_latest_freq", "2"])
    assert state.step == 2
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    for k, v in torch.load(ckpt, weights_only=True).items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_train_cli_gmflow_step_at_a_narrow_width(shards, tmp_path,
                                                 monkeypatch):
    from opticalflowfromdepth_torch.train import gmflow_train as gt
    monkeypatch.setattr(gt, "GMFlowTrainConfig", functools.partial(
        gt.GMFlowTrainConfig, feature_channels=32, num_transformer_layers=1))
    log_dir = tmp_path / "gm"
    state = cli.main(["--model", "gmflow", "--stage", "augmentedredweb",
                      "--redweb_shards", shards["redweb"], "--batch_size",
                      "2", "--image_size", "32", "48",
                      "--no_mixed_precision", "--num_workers", "1",
                      "--num_steps", "1", "--save_latest_freq", "1",
                      "--log_dir", str(log_dir), "--device", "cpu"])
    assert state.step == 1
    assert state.model.feature_channels == 32
    assert (log_dir / "checkpoints" / "latest.pth").exists()


def test_train_cli_needs_a_card_unless_asked_for_the_cpu(shards, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--model", "raft", "--stage", "augmentedredweb",
                  "--redweb_shards", shards["redweb"], "--log_dir",
                  str(tmp_path / "x"), "--num_steps", "1"])
    assert not os.path.exists(tmp_path / "x")
