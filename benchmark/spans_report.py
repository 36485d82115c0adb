"""Where a cell's device time goes by the program's own spans: one traced
run, reduced by ``harness/spans.py``.

    python3 benchmark/spans_report.py --workload <name> --seed <n>

One JSON line: the traced window's host ms a unit, busy ms a pair, device
ms a pair under each ``ofd.*`` span and given to it as the innermost,
unattributed ms, sync idle ms, how the device events were linked to their
launches (and the threads each span opened on), each op span's kernels
against ``harness/readers.py``'s name stems, and the run's own record. A
program that opens no span reads ``"spans": null``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

# each hand-written op's span beside the stems its roofline reads
OP_STEMS = {"ofd.op.flash_fwd": "FLASH_FWD", "ofd.op.flash_bwd": "FLASH_BWD",
            "ofd.op.corr_lookup": "CORR_LOOKUP",
            "ofd.op.instance_norm": "INSTANCE_NORM"}


def _top(kernels: dict, n: int = 8) -> list:
    return [[k[:120], v[0] * 1e3, v[1]] for k, v in
            sorted(kernels.items(), key=lambda kv: -kv[1][0])[:n]]


def sync_gaps(rows, n: int = 2, events: int = 14) -> dict:
    """For the ``n`` longest gaps that open in each ``ofd.sync.*`` span
    name: the host ranges of that span's thread that start inside the gap,
    as (name, us from the gap's start, us long), and the gap's us."""
    from harness import spans, trace
    win = next(r for r in rows if r.name == trace.WINDOW and not r.device)
    device = [r for r in rows if r.device and r.kind in trace.DEVICE_KINDS
              and r.end > win.start and r.start < win.end]
    syncs = [r for r in rows if not r.device
             and r.name.startswith(spans.SYNC)]
    host = sorted((r for r in rows if not r.device
                   and r.kind in trace.HOST_KINDS), key=lambda r: r.start)
    found = defaultdict(list)
    for a, b in spans._gaps(device, win.start, win.end):
        for s in syncs:
            if s.start <= a < s.end:
                found[s.name].append((b - a, a, s.tid))
    out = {}
    for name, gaps in found.items():
        out[name] = [{"gap_us": g / 1e3, "host": [
            [h.name[:60], (h.start - a) / 1e3, (h.end - h.start) / 1e3]
            for h in host if h.tid == tid and a <= h.start < a + g
            and not h.name.startswith("aten::empty")][:events]}
            for g, a, tid in sorted(found[name], reverse=True)[:n]]
    return out


def traced(root: pathlib.Path, workload: str, seed: int, seconds: float,
           device: str, t0: float):
    """One ``--trace 1`` run of the cell: its result line, the window's
    ``trace.Summary`` and the profiler's raw events, which the summary
    does not keep."""
    import run
    from harness import trace
    kept = []
    summarize = trace.summarize

    def keep(prof):
        events = prof.profiler.kineto_results.events()
        kept.append((trace.Summary(events), events))
        return kept[-1][0]
    trace.summarize = keep
    try:
        result = run.run_cell(root, workload, seed, seconds, True, device,
                              t0)
    finally:
        trace.summarize = summarize
    return (result,) + kept[-1]


def report(events, pairs: int) -> dict:
    from harness import readers, spans
    sp = spans.Spans(events)
    if not sp.found:
        return None
    per = 1e3 / pairs
    rows = [spans._Row(e) for e in events]
    threads = defaultdict(set)
    ids = defaultdict(int)       # which ids a device event carries
    for r in rows:
        if not r.device and r.name.startswith(spans.PREFIX):
            threads[r.name].add(r.tid)
        elif r.device and r.kind in ("kernel", "gpu_memcpy"):
            ids["corr"] += r.corr is not None
            ids["linked"] += r.linked is not None
            ids["linked_is_corr"] += r.linked is not None \
                and r.linked == r.corr
    stems = {}
    for name, const in OP_STEMS.items():
        if name not in sp.spans:
            continue
        c = sp.against_stems(name, getattr(readers, const))
        stems[name] = {"span_ms_per_pair": c["span_s"] * per,
                       "stem_ms_per_pair": c["stem_s"] * per,
                       "span_only_ms": _top(c["span_only"]),
                       "stem_only_ms": _top(c["stem_only"])}
    return {"opened": dict(sp.spans),
            "under_ms_per_pair": {k: v * per for k, v in
                                  sorted(sp.under.items())},
            "own_ms_per_pair": {k: v * per for k, v in sorted(sp.own.items())},
            "unattributed_ms_per_pair": sp.unattributed_s * per,
            "sync_idle_ms_per_pair": sp.sync_idle_s * per,
            "sync_idle_by_span": {k: v * per for k, v in
                                  sp.sync_idle.items()},
            "links": dict(sp.links), "ids": dict(ids),
            "threads": {k: sorted(map(str, v)) for k, v in threads.items()},
            "stems": stems, "sync_gaps": sync_gaps(rows)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=str(HERE.parent),
                   help="the checkout whose BENCHMARK.json names the cell")
    args = p.parse_args(argv)
    root = pathlib.Path(args.root)
    import run
    run._env()
    result, s, events = traced(root, args.workload, args.seed, args.seconds,
                               args.device, T0)
    from harness import cell as cell_mod
    cell = cell_mod.Cell(root, args.workload)
    pairs = s.units * cell.traffic["batch"]
    line = {"workload": args.workload, "seed": args.seed,
            "units": s.units, "pairs": pairs,
            "host_ms_per_unit": s.window_s * 1e3 / s.units,
            "busy_ms_per_pair": s.busy_s * 1e3 / pairs,
            "spans": report(events, pairs),
            "correct": result["correct"], "metrics": result["metrics"],
            "breakdown": result.get("breakdown")}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
