"""The plain references against the program at small sizes on the CPU:
the same seeded weights in both, the program in f32 (its CPU path, the
kernels' plain versions), the reference in f32. They agree to rounding;
the program in bf16 stands well apart from them, and the fp8 control
further still."""

from __future__ import annotations

import json
import math
import pathlib
import sys

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent), str(HERE.parent.parent)]

import tiny  # noqa: E402
from harness import cell as cell_mod  # noqa: E402
from harness import compare, precision, refs, weights  # noqa: E402

SEED = 7


def _tree(tmp_path, dtype=None):
    root = tiny.make_tree(tmp_path)
    if dtype:
        for name in ("gmflow", "raft-basic"):
            path = root / "benchmark" / "configs" / name / "config.json"
            cfg = json.loads(path.read_text())
            cfg["dtype"] = dtype
            path.write_text(json.dumps(cfg))
    return root


@pytest.mark.parametrize("model", ["gmflow", "raft-basic", "classifier"])
def test_bench_param_spec_matches_program(model):
    """The reference's parameter list is the program's state_dict, name for
    name and shape for shape, at the published widths."""
    from opticalflowfromdepth_torch.models.classifier import Classifier
    from opticalflowfromdepth_torch.models.gmflow import GMFlow
    from opticalflowfromdepth_torch.models.raft import RAFT
    bench = HERE.parent
    if model == "classifier":
        spec = refs.classifier_spec()
        with torch.device("meta"):
            sd = Classifier().state_dict()
    else:
        cfg = json.loads((bench / "configs" / model / "config.json")
                         .read_text())
        ref = cell_mod.load_module(
            bench / "configs" / model / "reference.py",
            f"bench_test_ref_{model.replace('-', '_')}")
        spec = ref.param_spec(cfg)
        with torch.device("meta"):
            sd = (GMFlow() if model == "gmflow"
                  else RAFT(corr_impl="fused")).state_dict()
    assert {n: tuple(s) for n, s, _ in spec} == \
        {n: tuple(t.shape) for n, t in sd.items()}


def test_bench_weights_seeded_and_scaled():
    spec = refs.classifier_spec()
    a = weights.make(spec, torch.Generator().manual_seed(3), "cpu")
    b = weights.make(spec, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    w = a["encoder.layer1.0.conv1.weight"]          # He-normal, fan-out
    assert abs(float(w.std()) - math.sqrt(2.0 / (64 * 9))) < 0.01
    assert float(a["classify.3.bias"].abs().max()) <= 1 / math.sqrt(64)
    assert a["encoder.layer2.0.downsample.1.weight"] is \
        a["encoder.layer2.0.norm3.weight"]


def test_bench_raft_reference_matches_program_f32(tmp_path):
    from harness.modes import infer
    cell = cell_mod.Cell(_tree(tmp_path, "float32"), "raft-basic.infer-b8")
    W, pool = infer.inputs(cell, SEED, "cpu")
    out = infer.build(cell, W, "cpu")(*pool[0])
    ref = infer.reference_flow(cell.glue, cell.config, W, *pool[0],
                               precision.F32(), "cpu")
    assert compare.entry_gap(torch.from_numpy(out), ref) < 1e-4


def test_bench_gmflow_train_reference_matches_program_f32(tmp_path):
    """Three steps of the recipe (sequence loss, classifier, clip, AdamW):
    the first step's loss, flow and gradients agree to rounding; the later
    losses and the changes part by Adam's sign-like first updates."""
    from harness.modes import train
    cell = cell_mod.Cell(_tree(tmp_path, "float32"), "gmflow.train-b16")
    W, A, pool = train.inputs(cell, SEED, "cpu")
    prog, step = train.build(cell, W, A, "cpu")
    got = train.program_readings(prog, step, pool[:3], W)
    ref = train.reference_readings(cell.glue, cell.config, W, A, pool[:3],
                                   precision.F32())
    checks = compare.train_checks(got, ref)
    stages = cell.glue.stage_checks(cell.config, W, A, pool[0], got["box"])
    assert compare.rel_gap(got["losses"][:1], ref["losses"][:1]) < 1e-5
    assert checks["flow_gap"] < 1e-4
    assert checks["grad_gap"] < 1e-3
    assert stages == {"matching_far_share": 0.0,
                      "propagation_far_share": 0.0,
                      "loss_grad_gap": pytest.approx(0.0, abs=1e-5),
                      "loss_grad_gap_median": pytest.approx(0.0, abs=1e-5)}
    assert checks["loss_gap"] < 1e-3
    assert checks["update_gap"] < 1e-2


def test_bench_control_reads_above_program(tmp_path):
    """At a small size the fp8 control reads several times the bf16
    program on every number the cells are held to."""
    cell = cell_mod.Cell(_tree(tmp_path), "raft-basic.infer-b8")
    got = cell.loop.calibrate(cell, SEED, ["program", "control"], "cpu")
    assert got["control"]["flow_gap"] > 5 * got["program"]["flow_gap"]
    assert got["control"]["flow_ratio"] > 5 * got["program"]["flow_ratio"]
    cell = cell_mod.Cell(_tree(tmp_path / "b"), "gmflow.train-b16")
    got = cell.loop.calibrate(cell, SEED, ["program", "control"], "cpu")
    for name in ("loss_gap", "flow_gap", "grad_gap", "feature_gap"):
        assert got["control"][name] > 2 * got["program"][name], name


def test_bench_one_cycle_lr():
    train = {"lr": 4e-4, "num_steps": 100000, "schedule_extra_steps": 100}
    assert refs.one_cycle_lr(train, 0) == pytest.approx(4e-4 / 25)
    assert refs.one_cycle_lr(train, 5005) == pytest.approx(4e-4)
    assert refs.one_cycle_lr(train, 100100) == pytest.approx(4e-4 / 25e4)
