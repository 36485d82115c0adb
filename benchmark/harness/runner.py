"""What every mode shares: the measured window (closed loop, optionally
traced), the device's record, the per-layer readings and the result."""

from __future__ import annotations

import gc
import sys
import time
from typing import Callable, Dict, Optional

import torch

from . import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "opticalflowfromdepth_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden packages among the loaded modules, compared by whole
    top-level name (``opticalflowfromdepth_torch`` is not
    ``opticalflowfromdepth_tpu``)."""
    top = {name.split(".")[0] for name in (sys.modules if modules is None
                                           else modules)}
    return sorted(top & set(FORBIDDEN))


def phase(what: str, t0: float) -> None:
    """Note on standard error how far set-up has come."""
    print(f"set-up: {what} at {time.perf_counter() - t0:.3f} s",
          file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Window:
    """The measured window: ``unit(i)`` called in a closed loop until
    ``seconds`` have passed (or, traced, ``trace_units`` calls), each call
    in a ``bench.unit`` span, all in ``bench.window``, ended by a device
    synchronize. With ``trace`` the profiler records the CPU and the card
    over it and :attr:`summary` holds the reduction; before it,
    ``trace_units`` calls untraced give :attr:`paced_unit_s`, the host
    clock's seconds a call without the profiler's cost."""

    def __init__(self, seconds: float, trace: bool, device,
                 trace_units: Optional[int] = None) -> None:
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.trace_units = trace_units
        self.units = 0
        self.window_s = 0.0
        self.summary: Optional[trace_mod.Summary] = None
        self.paced_unit_s = 0.0

    def run(self, unit: Callable[[int], None]) -> None:
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function)
        prof = None
        if self.trace:
            n = self.trace_units or 1
            sync(self.device)
            t0 = time.perf_counter()
            for _ in range(n):
                unit(self.units)
                self.units += 1
            sync(self.device)
            self.paced_unit_s = (time.perf_counter() - t0) / n
            acts = [ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        try:
            sync(self.device)
            first = self.units
            t0 = time.perf_counter()
            with record_function(trace_mod.WINDOW):
                while True:
                    with record_function(trace_mod.UNIT):
                        unit(self.units)
                    self.units += 1
                    if time.perf_counter() - t0 >= self.seconds:
                        break
                    if self.trace and self.trace_units \
                            and self.units - first >= self.trace_units:
                        break
                sync(self.device)
            self.window_s = time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        if prof is not None:
            self.summary = trace_mod.summarize(prof)


def device_record(device, chips: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Reading:
    """What a per-layer metric's reader reads: the trace of the window
    and the untraced pace before it (``Window``), the cell, the pairs a
    unit carries and the work a unit does (``flops``: the model's;
    ``bounds``: seconds each kernel's op needs, by op)."""

    def __init__(self, cell, window: Window, pairs_per_unit: int,
                 work: dict) -> None:
        self.cell = cell
        self.summary = window.summary
        self.paced_unit_s = window.paced_unit_s
        self.pairs_per_unit = pairs_per_unit
        self.work = work

    @property
    def pairs(self) -> int:
        return self.summary.units * self.pairs_per_unit


def per_layer(cell, reading: Reading) -> Dict[str, dict]:
    """Every per-layer metric of the cell whose reader finds something to
    read; each that finds nothing is named on standard error (a kernel
    renamed or taken off the path)."""
    out = {}
    for m in cell.per_layer():
        reader = cell.reader(m["name"])
        value = None if reader is None else reader.read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            print(f"per-layer: {m['name']} found nothing to read in "
                  f"{cell.name}", file=sys.stderr, flush=True)
    return out


def end_to_end(cell, values: Dict[str, float]) -> Dict[str, dict]:
    """The cell's end-to-end metrics among the mode's ``values``."""
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end() if m["name"] in values}


def result(cell, checks: Dict[str, float], attempted: int, failed: int,
           metrics: Dict[str, dict], device: dict,
           breakdown: Optional[dict] = None) -> dict:
    """The run's record; ``correct`` needs every check within its limit
    and no failed call. The numbers with no limit come under ``read``;
    the checks come last, each beside its limit."""
    compared = {}
    ok = failed == 0
    for name, limit in cell.limits.items():
        value = checks.get(name, float("inf"))
        compared[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    out = {"correct": bool(ok), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["read"] = {k: v for k, v in checks.items() if k not in cell.limits}
    out["checks"] = compared
    return out
