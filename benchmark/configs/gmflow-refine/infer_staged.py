"""GMFlow with refinement in inference cells: one-scale GMFlow's glue
(``configs/gmflow/infer_staged.py``: the program's ``gmflow_infer_fn``,
its stages, the checks that follow them and the work a call does) with
this configuration's two-scale reference."""

from __future__ import annotations

import pathlib

from harness import cell

reference = cell.sibling(__file__, "reference")
gmflow = cell.load_module(
    pathlib.Path(__file__).resolve().parent.parent / "gmflow"
    / "infer_staged.py", "bench_gmflow_infer_staged")
KERNELS = gmflow.KERNELS
program = gmflow.program


def work(cfg: dict, traffic: dict) -> dict:
    return gmflow.gmflow_work(reference, cfg, traffic)


def stage_checks(cfg: dict, W: dict, pair, box: dict, answer,
                 device) -> dict:
    return gmflow.gmflow_stage_checks(reference, cfg, W, pair, box, answer,
                                      device)
