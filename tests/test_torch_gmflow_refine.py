"""GMFlow with refinement (two scales) and one-scale GMFlow, as the
inference cells of the benchmark run them, against the benchmark's plain
references (``benchmark/configs/gmflow-refine/reference.py``,
``benchmark/configs/gmflow/infer_reference.py``) on the CPU.

Both models are the cells' configurations cut to 32 channels and one
transformer block, on 2 pairs of 64x96 frames (1/8: 8x12 cells in 2x2
windows of 4x6; 1/4: 16x24 cells in 8x8 windows of 2x3), with the
benchmark's seeded weights. The port runs through ``gmflow_infer_fn``
with its stages kept by the cells' own ``Program.capture``; its CPU path
takes the kernels' plain versions. In f32 it agrees with the reference
at every stage to rounding; in bf16 it stands apart, and the reference
from fp8 operands (the cells' control) further still. The four spans and
two counters of the refinement open and count once a call.
"""

import importlib
import json
import pathlib
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from opticalflowfromdepth_torch.models import gmflow as gm

BENCH = pathlib.Path(__file__).resolve().parent.parent / "benchmark"
torch.set_num_threads(2)
B, H, W = 2, 64, 96
SEED = 7
MODELS = ("gmflow", "gmflow-refine")
TINY = {"feature_channels": 32, "num_transformer_layers": 1}


def _is_bench(name: str) -> bool:
    return name == "harness" or name.startswith(("harness.", "bench_"))


@pytest.fixture(scope="module")
def hb():
    """The benchmark's ``harness`` modules these tests use. Its folder is on
    the path, and its modules (with the configurations' glue and references
    that they load) in ``sys.modules``, for this module's tests alone."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(BENCH))
        for name in [m for m in sys.modules if _is_bench(m)]:
            mp.delitem(sys.modules, name)
        before = set(sys.modules)
        try:
            yield types.SimpleNamespace(**{
                m.split(".")[-1]: importlib.import_module(m)
                for m in ("harness.cell", "harness.compare",
                          "harness.precision", "harness.traffic",
                          "harness.weights", "harness.modes.infer_staged")})
        finally:
            for name in set(sys.modules) - before:
                if _is_bench(name):
                    del sys.modules[name]


def _config(name: str, **over) -> dict:
    cfg = json.loads((BENCH / "configs" / name / "config.json").read_text())
    cfg.update(over)
    return cfg


def _glue(hb, name: str):
    """The cell's glue (``infer_staged.py``) and its reference."""
    folder = BENCH / "configs" / name
    glue = hb.cell.load_module(folder / "infer_staged.py",
                                f"bench_{name.replace('-', '_')}_infer_staged")
    return glue, glue.reference


def _pair(hb, seed: int = SEED):
    """Host NHWC f32 images [B, H, W, 3] in [0, 255], the second the first
    moved by a smooth flow (the benchmark's generator)."""
    p = hb.traffic.pairs(torch.Generator().manual_seed(seed), B, H, W, 3.0,
                      "cpu")
    return tuple(p[k].permute(0, 2, 3, 1).contiguous().numpy()
                 for k in ("image1", "image2"))


def _weights(hb, ref, cfg, seed: int = SEED) -> dict:
    return hb.weights.make(ref.param_spec(cfg),
                        torch.Generator().manual_seed(seed), "cpu")


def _run(hb, name: str, dtype: str):
    """The port's answer, its kept stages and the reference's probe in
    f32 from the same weights and pair."""
    glue, ref = _glue(hb, name)
    cfg = _config(name, dtype=dtype, **TINY)
    Wt = _weights(hb, ref, cfg)
    pair = _pair(hb)
    prog = glue.program(cfg, Wt, "cpu")
    with prog.capture() as box:
        answer = prog(*pair)
    rbox = {}
    with hb.precision.true_f32(), torch.no_grad():
        flow = ref.infer(hb.precision.F32(), Wt, cfg,
                         *(torch.from_numpy(x) for x in pair), rbox)
    return glue, ref, cfg, Wt, pair, box, answer, rbox, flow


@pytest.mark.parametrize("name", MODELS)
def test_param_spec_is_the_port_state_dict(hb, name):
    """The reference's parameter list is the port's ``state_dict`` in order,
    name for name and shape for shape, at the published widths (the
    trident kernel and the upsampler's 4^2 x 9 = 144 outputs with
    refinement)."""
    _, ref = _glue(hb, name)
    cfg = _config(name)
    with torch.device("meta"):
        sd = gm.GMFlow(num_scales=cfg["num_scales"],
                       upsample_factor=cfg["upsample_factor"]).state_dict()
    spec = ref.param_spec(cfg)
    assert [(n, tuple(s)) for n, s, _ in spec] == \
        [(n, tuple(t.shape)) for n, t in sd.items()]
    shapes = dict((n, s) for n, s, _ in spec)
    assert shapes["upsampler.2.weight"][0] == cfg["upsample_factor"] ** 2 * 9
    assert ("backbone.trident_conv.weight" in shapes) == (name != "gmflow")


# relative L2 of the port's f32 stages from the reference's, worst entry,
# whole path from the images: the features at 1/8, the matched and the
# propagated flow at 1/8; the same at 1/4, after the warp; the final flow.
# What parts the two is summation order alone (the flash kernel's plain
# version against a dense softmax, a separable resize against
# ``F.interpolate``): 3e-6, 2e-5 and 5e-5 at 1/8, then 1.2e-4 at the 1/4
# features, whose warp moves each sample by the flow's rounding times the
# features' slope, and 4.3e-4 / 3.3e-4 / 2.9e-4 after it (seed 7).
F32_TOLERANCE = {"features": (1e-5, 1e-3), "matching": (1e-4, 2e-3),
                 "propagated": (1e-4, 2e-3), "final": 2e-3}


@pytest.mark.parametrize("name", MODELS)
def test_port_f32_matches_the_reference(hb, name):
    """Each scale's transformer output, matched and propagated flow and the
    final flow of the f32 port within ``F32_TOLERANCE`` of the
    reference's."""
    _, _, cfg, _, _, box, answer, rbox, flow = _run(hb, name, "float32")
    assert answer.shape == (B, H, W, 2)
    for s in range(cfg["num_scales"]):
        for key in ("features", "matching", "propagated"):
            assert hb.compare.entry_gap(box[key][s], rbox[key][s]) \
                < F32_TOLERANCE[key][s], (s, key)
    assert hb.compare.entry_gap(torch.from_numpy(answer), flow) \
        < F32_TOLERANCE["final"]


@pytest.mark.parametrize("name", MODELS)
def test_stage_checks_read_zero_for_the_port_in_f32(hb, name):
    """The cells' stage numbers, each stage from the port's own state:
    within 1e-5 of 0 in f32 (the same arithmetic on the same operands),
    the shares of far cells exactly 0."""
    glue, _, cfg, Wt, pair, box, answer, _, _ = _run(hb, name, "float32")
    nums = glue.stage_checks(cfg, Wt, pair, box, answer, "cpu")
    assert set(nums) == set(_glue(hb, "gmflow")[0].stage_names(cfg))
    for key, value in nums.items():
        if key.endswith("_far_share"):
            assert value == 0.0, key
        elif key not in ("flow_gap", "flow_ratio"):
            assert value < 1e-5, key


def _kinds(hb, name: str) -> dict:
    """The stage numbers of the port in f32, in bf16 and of the fp8
    control, at the same seed (the cells' calibration)."""
    glue, ref = _glue(hb, name)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _config(name, dtype=dtype, **TINY)
        Wt = _weights(hb, ref, cfg)
        pair = _pair(hb)
        prog = glue.program(cfg, Wt, "cpu")
        with prog.capture() as box:
            answer = prog(*pair)
        out[dtype] = glue.stage_checks(cfg, Wt, pair, box, answer, "cpu")
    control = hb.infer_staged._Control(
        types.SimpleNamespace(glue=glue, config=cfg), Wt, "cpu")
    with control.capture() as box:
        answer = control(*pair)
    out["control"] = glue.stage_checks(cfg, Wt, pair, box, answer, "cpu")
    return out


@pytest.mark.parametrize("name", MODELS)
def test_bf16_port_and_fp8_control_stand_apart(hb, name):
    """The transformer's output: the bf16 port at least 1000x the f32 port's
    gap (bf16 keeps 8 bits; f32's gap is rounding of sums) and the fp8
    control at least 4x the bf16 port's (e4m3 keeps 3); the same order at
    each matching and propagation stage that the bf16 port computes in
    bf16, and the control above the bf16 port at every stage."""
    k = _kinds(hb, name)
    f32, bf16, fp8 = k["float32"], k["bfloat16"], k["control"]
    assert bf16["feature_gap"] > 1000 * max(f32["feature_gap"], 1e-8)
    assert fp8["feature_gap"] > 4 * bf16["feature_gap"]
    stages = ["matching_gap", "propagation_gap"]
    if name != "gmflow":
        stages += ["refine_feature_gap", "local_propagation_gap"]
    for key in stages:
        assert f32[key] < bf16[key] < fp8[key], key
    # local matching reads f32 features in the port whatever its dtype
    if name != "gmflow":
        assert fp8["local_matching_gap"] > 100 * bf16["local_matching_gap"] \
            + 1e-3


def _spans(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name())
                       for e in prof.profiler.kineto_results.events()
                       if e.name().startswith("ofd.gmflow.")
                       and str(e.device_type()).endswith("CPU"))


def _inside(inner, outer) -> bool:
    return any(o[0] <= inner[0] and inner[1] <= o[1] for o in outer)


@pytest.mark.parametrize("name", MODELS)
def test_refine_spans_and_counters(hb, name):
    """A refined call opens ``ofd.gmflow.refine`` once around the second
    scale, the warp inside it, local matching inside that scale's
    ``ofd.gmflow.matching`` and local propagation inside its
    ``ofd.gmflow.propagation``; each counter counts one call. A one-scale
    call opens none of them and counts nothing."""
    glue, ref = _glue(hb, name)
    cfg = _config(name, **TINY)
    prog = glue.program(cfg, _weights(hb, ref, cfg), "cpu")
    pair = _pair(hb)
    before = (gm.local_correlation_softmax.calls,
              gm.local_flow_propagation.calls)
    answer, spans = _spans(lambda: prog(*pair))
    np.testing.assert_array_equal(answer, prog(*pair))
    counted = (gm.local_correlation_softmax.calls - before[0],
               gm.local_flow_propagation.calls - before[1])
    named = {}
    for s in spans:
        named.setdefault(s[2].split(".")[-1], []).append(s)
    new = ("refine", "warp", "local_matching", "local_propagation")
    if name == "gmflow":
        assert not set(new) & set(named) and counted == (0, 0)
        return
    assert {n: len(named[n]) for n in new} == dict.fromkeys(new, 1)
    assert counted == (2, 2)         # the two calls, traced and not
    refine = named["refine"]
    assert all(_inside(named[n][0], refine) for n in new[1:])
    assert _inside(named["local_matching"][0], named["matching"])
    assert _inside(named["local_propagation"][0], named["propagation"])
    # the first scale's transformer, matching and propagation lie outside
    for n in ("transformer", "matching", "propagation"):
        assert sum(_inside(s, refine) for s in named[n]) == 1, n
    assert not _inside(named["backbone"][0], refine)
