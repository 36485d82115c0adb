"""Readings that set a cell's correctness limits, at the cell's own sizes
and in one process: the program's numbers on many seeds, and those of the
control (the reference in fp8 in the program's place) and of each planted
fault on a few.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        --faults control,half_batch --fault-seeds 1,2,3

One JSON line a seed and kind, then for each number the largest the
program read and the least each fault read.
"""

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import run
    run._env()
    from harness import cell as cell_mod
    cell = cell_mod.Cell(HERE.parent, args.workload)
    faults = [f for f in args.faults.split(",") if f]
    fault_seeds = {int(s) for s in args.fault_seeds.split(",") if s}
    table = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        kinds = ["program"] + (faults if seed in fault_seeds else [])
        t0 = time.perf_counter()
        checks = cell.loop.calibrate(cell, seed, kinds, args.device)
        for kind, nums in checks.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, "checks": nums,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            for name, v in nums.items():
                if isinstance(v, float):
                    table.setdefault(name, {}).setdefault(kind, []).append(v)
    for name, kinds in table.items():
        prog = kinds.get("program", [])
        line = {"number": name, "program_max": max(prog),
                "program_seeds": len(prog),
                "program_sorted": sorted(prog)}
        for kind, vals in kinds.items():
            if kind != "program":
                line[f"{kind}_min"] = min(vals)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
