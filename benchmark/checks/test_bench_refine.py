"""GMFlow's inference cells (``gmflow.infer-b8``, ``gmflow-refine.infer-b8``)
on the CPU: both run end to end at tiny sizes on a copy of the tree and
read correct, each planted fault reads not correct, and the work a call
does is counted at the cells' own sizes (the flash calls and the instance
norms' maps)."""

from __future__ import annotations

import json
import pathlib
import sys
import time

import pytest

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
sys.path[:0] = [str(HERE), str(BENCH), str(ROOT)]

import run  # noqa: E402
import tiny  # noqa: E402
from harness import bounds, cell as cell_mod, counts  # noqa: E402

CELLS = ("gmflow.infer-b8", "gmflow-refine.infer-b8")
# the refined configuration and the traffic cut as tiny.py cuts the others:
# 32 channels, one block; 2 pairs of 64x96 (1/8: 8x12 cells, 1/4: 16x24)
TINY_REFINE = {"feature_channels": 32, "num_transformer_layers": 1}
TINY_TRAFFIC = {"batch": 2, "height": 64, "width": 96, "pool": 2,
                "motion_px": 3.0, "warmup_calls": 1, "trace_units": 2}
# limits for the small cells, between what the bf16 program reads there
# (seed 7: features 0.03, matching 3e-4, propagation 0.02, the 1/4 scale's
# features 0.03, local matching 0, local propagation 0.008, far final
# pixels 0) and what the faults read (the control 0.23, 0.14, 0.31, 0.23,
# 0.2, 0.14 and 0.03; the shifted answer's final share 1; half the batch
# inf)
LIMITS = {"feature_gap": 0.1, "matching_gap": 0.05, "propagation_gap": 0.1,
          "final_far_share": 0.5}
TINY_LIMITS = {"gmflow.infer-b8": LIMITS,
               "gmflow-refine.infer-b8": dict(
                   LIMITS, refine_feature_gap=0.1, local_matching_gap=0.05,
                   local_propagation_gap=0.05)}


def _tree(tmp_path) -> pathlib.Path:
    root = tiny.make_tree(tmp_path, TINY_LIMITS)
    for path, over in (
            (root / BENCH.name / "configs" / "gmflow-refine" / "config.json",
             TINY_REFINE),
            (root / BENCH.name / "traffic" / "infer-b8-pad32.json",
             TINY_TRAFFIC)):
        data = json.loads(path.read_text())
        data.update(over)
        path.write_text(json.dumps(data))
    return root


@pytest.mark.parametrize("workload", CELLS)
def test_bench_infer_cell_runs_and_reads_correct(tmp_path, workload):
    """An untraced run gives the cell's end-to-end metrics, a traced one its
    per-layer metrics (on the CPU only MFU finds something to read), both
    correct, with every stage number compared beside its limit."""
    root = _tree(tmp_path)
    r = run.run_cell(root, workload, 2 ** 31 + 7, 0.5, False, "cpu",
                     time.perf_counter())
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"infer_pairs_per_s", "infer_call_ms_p95",
                                 "setup_s"}
    assert set(r["checks"]) == set(TINY_LIMITS[workload])
    assert {"flow_gap", "flow_ratio"} <= set(r["read"])
    r = run.run_cell(root, workload, 5, 0.5, True, "cpu",
                     time.perf_counter())
    assert r["correct"] and "mfu.infer" in r["metrics"], r["checks"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["control", "half_batch", "altered"])
def test_bench_infer_faults_read_not_correct(tmp_path, workload, fault):
    r = run.run_cell(_tree(tmp_path), workload, 7, 0.5, False, "cpu",
                     time.perf_counter(), fault)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("workload,calls,layer3", [
    ("gmflow.infer-b8", 14, (56, 128)), ("gmflow-refine.infer-b8", 26,
                                         (112, 256))])
def test_bench_infer_work_at_the_cells_sizes(workload, calls, layer3):
    """448x1024 frames, 8 pairs: 12 window calls a scale (1792 tokens at
    1/8, 448 at 1/4, both frames' windows) and the 1/8 scale's global
    matching and propagation; 15 norms over 16 images, ``layer3``'s five at
    1/8 with one scale and at 1/4 with two."""
    cell = cell_mod.Cell(ROOT, workload)
    glue = cell.glue if hasattr(cell.glue, "flash_calls") \
        else cell.glue.gmflow
    shapes = glue.flash_calls(cell.config, cell.traffic)
    assert len(shapes) == calls
    assert shapes[:12] == [(64, 1792, 1792, 128, 128)] * 12
    assert shapes[12:14] == [(8, 7168, 7168, 128, 2)] * 2
    assert shapes[14:] == [(1024, 448, 448, 128, 128)] * (calls - 14)
    norms = glue.norm_sizes(cell.config, 16, 448, 1024)
    assert norms[:10] == counts.encoder_norms(16, 448, 1024)[:10]
    assert norms[10:] == [16 * 128 * layer3[0] * layer3[1]] * 5
    work = cell.glue.work(cell.config, cell.traffic)
    assert work["bounds"]["flash_fwd"] == pytest.approx(
        sum(bounds.flash_fwd(*s) for s in shapes))
    assert work["bounds"]["instance_norm"] == pytest.approx(
        sum(bounds.instance_norm(n) for n in norms))
    lo, hi = {14: (2e12, 5e12), 26: (5e12, 12e12)}[calls]
    assert lo < work["flops"] < hi, work["flops"]
