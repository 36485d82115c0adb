"""A small copy of the benchmark for the CPU tests: the harness and the
configurations' folders as they are, with cells cut to sizes a CPU runs
in seconds (GMFlow of 32 channels and one block, RAFT at 126x132 (coarsest level 2x2) with 2
iterations, batches of 2)."""

from __future__ import annotations

import json
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parent.parent

TINY_CONFIGS = {
    "gmflow": {"feature_channels": 32, "num_transformer_layers": 1},
    "raft-basic": {"iters": 2},
}
TINY_TRAFFIC = {
    "train-b16": {"batch": 2, "height": 64, "width": 96, "pool": 4,
                  "motion_px": 3.0, "trace_units": 2},
    "infer-b8": {"batch": 2, "height": 126, "width": 132, "pool": 2,
                 "motion_px": 3.0, "warmup_calls": 1, "trace_units": 2},
}


def make_tree(tmp: pathlib.Path, limits: dict = None) -> pathlib.Path:
    """``tmp/BENCHMARK.json`` and ``tmp/benchmark/``: the real benchmark's
    cells at tiny sizes (each configuration and traffic file overwritten
    in the copy), with ``limits`` per cell (default: the real ones)."""
    shutil.copytree(BENCH, tmp / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "checks"))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for name, over in TINY_CONFIGS.items():
        path = tmp / BENCH.name / "configs" / name / "config.json"
        cfg = json.loads(path.read_text())
        cfg.update(over)
        path.write_text(json.dumps(cfg))
    for name, over in TINY_TRAFFIC.items():
        path = tmp / BENCH.name / "traffic" / f"{name}.json"
        traffic = json.loads(path.read_text())
        traffic.update(over)
        path.write_text(json.dumps(traffic))
    for cell, lim in (limits or {}).items():
        (tmp / BENCH.name / "limits" / f"{cell}.json").write_text(
            json.dumps(lim))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
