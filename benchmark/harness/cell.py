"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic. A configuration's file sits in a folder of its own beside its
plain reference (``reference.py``) and one module a kind of traffic
(``<mode>.py``: the program's entry, the reference's run and the work
counts for that mode; a training mode's also the checks of each stage of
the first step from the program's own state). A traffic file (``traffic/<name>.json``) is data
read by the general generator; its ``mode`` names the loop
(``harness/modes/<mode>.py``). A cell's correctness limits are
``limits/<cell>.json``; a per-layer metric is read by
``metrics/<metric>.py``. Adding any of them is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from types import ModuleType
from typing import Dict, List, Optional

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_module(path: pathlib.Path, name: str) -> ModuleType:
    """Import the file at ``path`` as module ``name`` (once)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def sibling(file: str, stem: str) -> ModuleType:
    """The module ``<stem>.py`` beside ``file`` (a configuration's
    reference, for its mode modules)."""
    folder = pathlib.Path(file).resolve().parent
    return load_module(folder / f"{stem}.py",
                       f"bench_{folder.name.replace('-', '_')}_{stem}")


class Cell:
    """One workload of ``BENCHMARK.json`` and every piece it names."""

    def __init__(self, root: pathlib.Path, workload: str) -> None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.root = root
        self.bench = bench
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        entry = configs[self.workload["config"]]
        self.config_file = root / entry["file"]
        self.config = json.loads(self.config_file.read_text())
        base = root / BENCH.name
        self.traffic = json.loads(
            (base / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.mode = self.traffic["mode"]
        self.limits: Dict[str, float] = json.loads(
            (base / "limits" / f"{workload}.json").read_text())
        self.glue = load_module(
            self.config_file.parent / f"{self.mode}.py",
            f"bench_{self.config_file.parent.name.replace('-', '_')}_"
            f"{self.mode}")
        self.loop = load_module(base / "harness" / "modes" /
                                f"{self.mode}.py",
                                f"bench_mode_{self.mode}")
        self.metrics_dir = base / "metrics"

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str) -> Optional[ModuleType]:
        path = self.metrics_dir / f"{metric}.py"
        if not path.exists():
            return None
        return load_module(path, "bench_metric_" + metric.replace(".", "_")
                           .replace("-", "_"))
