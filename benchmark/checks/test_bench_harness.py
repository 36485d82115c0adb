"""The harness on the CPU: the import guard, the trace reduction on a
made-up trace, the contract of ``BENCHMARK.json``, a new cell added as
files alone, and the planted faults that a run must read as not
correct."""

from __future__ import annotations

import hashlib
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
sys.path[:0] = [str(HERE), str(BENCH), str(ROOT)]

import run  # noqa: E402
import tiny  # noqa: E402
from harness import runner, trace  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# -- the import guard --------------------------------------------------------

def test_bench_guard_by_whole_top_level_name():
    assert runner.forbidden_modules(
        ["opticalflowfromdepth_torch", "opticalflowfromdepth_torch.ops",
         "jaxtyping", "flaxen.x", "torch"]) == []
    assert runner.forbidden_modules(
        ["jax.numpy", "opticalflowfromdepth_tpu.ops.flash", "flax",
         "jaxlib"]) == ["flax", "jax", "jaxlib", "opticalflowfromdepth_tpu"]


def test_bench_guard_catches_a_planted_import(monkeypatch):
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "opticalflowfromdepth_tpu",
                        types.ModuleType("opticalflowfromdepth_tpu"))
    assert runner.forbidden_modules() == ["opticalflowfromdepth_tpu"]


def test_bench_run_refuses_without_a_card():
    """No CUDA device: exit code 2 and no record on standard output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "raft-basic.infer-b8", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""


# -- the trace reduction -----------------------------------------------------

class _E:
    def __init__(self, kind, name, start, end, cuda=False):
        self._k, self._n, self._s, self._e = kind, name, start, end
        self._d = "DeviceType.CUDA" if cuda else "DeviceType.CPU"

    def activity_type(self):
        return self._k

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._d


def test_bench_trace_summary():
    ms = 1_000_000
    ev = [_E("user_annotation", trace.WINDOW, 0, 100 * ms),
          _E("user_annotation", trace.UNIT, 0, 50 * ms),
          _E("user_annotation", trace.UNIT, 50 * ms, 100 * ms),
          _E("cpu_op", "aten::conv", 1 * ms, 30 * ms),
          _E("cuda_runtime", "cudaLaunchKernel", 2 * ms, 3 * ms),
          _E("cuda_runtime", "cudaLaunchKernelExC", 4 * ms, 5 * ms),
          _E("cpu_op", "aten::copy_", 60 * ms, 90 * ms),
          _E("kernel", "flash_fwd_wgmma<3>", 10 * ms, 20 * ms, True),
          _E("kernel", "cudnn_conv", 15 * ms, 40 * ms, True),
          _E("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 70 * ms,
             80 * ms, True),
          _E("gpu_user_annotation", trace.UNIT, 0, 50 * ms, True),
          _E("kernel", "outside", 200 * ms, 210 * ms, True)]
    s = trace.Summary(ev)
    assert s.window_s == pytest.approx(0.1)
    assert s.units == 2 and s.launches == 2
    assert s.busy_s == pytest.approx(0.040)        # 10-40 and 70-80 ms
    assert s.kernel_s(("flash_fwd_",)) == (pytest.approx(0.010), 1)
    assert s.copy_s() == pytest.approx(0.010)
    # idle: 0-10 ms (in the conv op), 40-70 (unit 2 before the copy op;
    # its midpoint, 55, lies in no op), 80-100 (in the copy op)
    assert s.idle_by_host["aten::conv"] == pytest.approx(0.010)
    assert s.idle_by_host[trace.UNIT] == pytest.approx(0.030)
    assert s.idle_by_host["aten::copy_"] == pytest.approx(0.020)
    b = s.breakdown()
    assert b["device_ops"][0] == ["cudnn_conv", pytest.approx(0.025)]


def test_bench_idle_and_mfu_read_the_untraced_pace():
    """Idle share and MFU take the traced busy time a call against the
    calls' pace without the profiler, not the traced window's length."""
    from harness import bounds, readers
    ms = 1_000_000
    ev = [_E("user_annotation", trace.WINDOW, 0, 100 * ms),
          _E("user_annotation", trace.UNIT, 0, 50 * ms),
          _E("user_annotation", trace.UNIT, 50 * ms, 100 * ms),
          _E("kernel", "k", 0, 40 * ms, True),
          _E("kernel", "k", 50 * ms, 90 * ms, True)]
    window = types.SimpleNamespace(summary=trace.Summary(ev),
                                   paced_unit_s=0.045)
    flops = 0.009 * bounds.BF16_FLOP_PER_S
    r = runner.Reading(None, window, 1, {"flops": flops})
    assert readers.idle_pct(r) == pytest.approx(100 * (1 - 0.040 / 0.045))
    assert readers.mfu(r) == pytest.approx(20.0)
    r.paced_unit_s = 0.0
    assert readers.idle_pct(r) is None and readers.mfu(r) is None


# -- the numbers compared ---------------------------------------------------

def test_bench_far_share_and_row_gaps():
    from harness import compare
    ref = torch.zeros(2, 4, 5, 2)
    got = ref.clone()
    got[1, 0, :2, 0] = 3.0              # two of image 1's 20 cells moved
    got[0, 0, 0, 1] = 0.5               # within the distance
    assert compare.far_share(got, ref, 1.0) == pytest.approx(0.1)
    assert compare.far_share(got[:1], ref, 1.0) == float("inf")
    got[0, 1, 1, 0] = float("nan")
    assert compare.far_share(got, ref, 1.0) == pytest.approx(0.1)
    r = [torch.ones(4, 2, 3), torch.ones(4, 5)]
    g = [t.clone() for t in r]
    assert compare.row_gaps(g, r) == [0.0] * 4
    g[0][2] = 0.0                       # row 2 loses 6 of its 11 ones
    assert compare.row_gaps(g, r) == pytest.approx([0, 0, (6 / 11) ** 0.5,
                                                    0])
    assert compare.row_gaps([g[0], None], r) == [float("inf")]
    assert compare.row_gaps(None, r) == [float("inf")]


# -- the contract of BENCHMARK.json -----------------------------------------

def test_bench_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == [BENCH.name]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith(BENCH.name + "/")
        assert (ROOT / c["file"]).exists()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    cells = {}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and w["config"] in names
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
        cells[w["name"]] = w
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        layers.add(m["layer"])
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer
    for cell in cells:
        assert any(cell in m.get("workloads", [cell])
                   for m in bench["per_layer"])
        assert len([m for m in bench["end_to_end"]
                    if cell in m.get("workloads", [cell])]) >= 2


# -- a new cell as files alone ----------------------------------------------

def _digest(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_bench_discovery_of_new_files(tmp_path):
    """A dummy configuration, traffic and metric enter as new files and
    entries; the run finds them by name and no file edits."""
    root = tiny.make_tree(tmp_path)
    before = _digest(root / BENCH.name)
    configs = root / BENCH.name / "configs"
    shutil.copytree(configs / "raft-basic", configs / "raft-dummy",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((configs / "raft-dummy" / "config.json").read_text())
    cfg["iters"] = 1
    (configs / "raft-dummy" / "config.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / BENCH.name / "traffic" / "infer-b8.json")
                         .read_text())
    traffic.update(batch=1, pool=1, trace_units=1)
    (root / BENCH.name / "traffic" / "infer-dummy.json").write_text(
        json.dumps(traffic))
    (root / BENCH.name / "metrics" / "units_traced.dummy.py").write_text(
        "def read(r):\n    return float(r.summary.units)\n")
    (root / BENCH.name / "limits" / "raft-dummy.infer-dummy.json") \
        .write_text(json.dumps({"flow_gap": 0.05}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "raft-dummy", "source": "x",
                             "file": f"{BENCH.name}/configs/raft-dummy/"
                                     "config.json",
                             "reduced": ["iters"], "why": "x"})
    bench["workloads"].append({"name": "raft-dummy.infer-dummy",
                               "config": "raft-dummy",
                               "traffic": "infer-dummy", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "raft-basic.infer-b8" in m["workloads"]:
            m["workloads"].append("raft-dummy.infer-dummy")
    bench["per_layer"].append({"name": "units_traced.dummy", "unit": "n",
                               "better": "higher", "source": "program_span",
                               "layer": "entry",
                               "moves": "infer_pairs_per_s",
                               "workloads": ["raft-dummy.infer-dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run.run_cell(root, "raft-dummy.infer-dummy", 5, 0.5, True, "cpu",
                     time.perf_counter())
    assert r["correct"] and r["metrics"]["units_traced.dummy"]["value"] == 1
    r = run.run_cell(root, "raft-dummy.infer-dummy", 5, 0.5, False, "cpu",
                     time.perf_counter())
    assert set(r["metrics"]) == {"infer_pairs_per_s", "infer_call_ms_p95",
                                 "setup_s"}
    after = _digest(root / BENCH.name)
    assert {k: v for k, v in after.items() if k in before} == before


# -- planted faults ----------------------------------------------------------

# limits for the small cells, between what the bf16 program reads there and
# what the faults read (seed 7)
TINY_LIMITS = {"gmflow.train-b16": {"feature_gap": 0.1, "update_gap": 0.5,
                                    "update_gap_median": 0.05,
                                    "loss_grad_gap_median": 0.05,
                                    "matching_far_share": 0.02,
                                    "propagation_far_share": 0.05},
               "raft-basic.infer-b8": {"flow_ratio": 4.0}}


@pytest.mark.parametrize("workload,fault", [
    ("gmflow.train-b16", None), ("gmflow.train-b16", "control"),
    ("gmflow.train-b16", "unchanged"), ("gmflow.train-b16", "half_batch"),
    ("raft-basic.infer-b8", None), ("raft-basic.infer-b8", "control"),
    ("raft-basic.infer-b8", "half_batch"), ("raft-basic.infer-b8",
                                            "altered")])
def test_bench_faults_read_not_correct(tmp_path, workload, fault):
    """The run with the timed path broken underneath comes out not
    correct; the sound program comes out correct."""
    root = tiny.make_tree(tmp_path, TINY_LIMITS)
    r = run.run_cell(root, workload, 7, 0.5, False, "cpu",
                     time.perf_counter(), fault)
    assert r["correct"] is (fault is None), r["checks"]
    line = json.loads(run.report(r))
    assert list(line)[-2:] == ["read", "checks"]
    assert not set(line["read"]) & set(line["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["gmflow.train-b16",
                                      "raft-basic.infer-b8"])
def test_bench_control_on_the_card(workload):
    """The fp8 control at the cell's own size, through the run, with the
    cell's own limits, comes out not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run.run_cell(ROOT, workload, 11, 2.0, False, "cuda",
                     time.perf_counter(), "control")
    assert r["correct"] is False, r["checks"]
