"""Run one cell of the benchmark once, on the card of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's pieces are found by the names in
``BENCHMARK.json`` (``harness/cell.py``). The last line of standard output
is the run's JSON record: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, ``read``
(the numbers worked out but held to no limit), and last ``checks``, each
number compared beside its limit; the same numbers end standard error. Without enough CUDA devices, or with JAX or the JAX
package loaded once the window has closed, the run prints no record and
exits with a code other than 0.
"""

import time

T0 = time.perf_counter()       # set-up is counted from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]


def _env() -> None:
    """Kernel caches at fixed places inside the checkout (the port's own
    CUDA build already lives in ``build/kernels``), and no JAX pulled in
    by a library."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device, t0: float, fault=None) -> dict:
    """One run of ``workload`` on ``device``, without the look for a card
    (the tests drive it on the CPU)."""
    from harness import cell as cell_mod
    cell = cell_mod.Cell(pathlib.Path(root), workload)
    return cell.loop.run(cell, seed % 2 ** 63, seconds, trace, device, t0,
                         fault)


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def report(result: dict) -> str:
    """The checks on standard error, the record's line returned."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    return json.dumps(_finite(result))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _env()
    import torch
    from harness import cell as cell_mod, runner
    chips = cell_mod.Cell(ROOT, args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T0)
    bad = runner.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    line = report(result)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
