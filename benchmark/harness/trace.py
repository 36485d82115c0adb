"""Reduction of a ``torch.profiler`` trace of the measured window to what
the per-layer metrics read.

The window is the benchmark's own ``bench.window`` span; each call into
the program's entry is a ``bench.unit`` span inside it. Device activity
is every kernel, copy and memset the card ran; a span the profiler also
draws on the device's timeline (a ``record_function`` range) is not
activity. Times are seconds.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"
UNIT = "bench.unit"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "python_function")


def _kind(e) -> str:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    on_device = str(e.device_type()).endswith("CUDA")
    name = e.name()
    if on_device:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name.startswith(("cuda", "cu")) and "Launch" in name:
        return "cuda_runtime"
    return "cpu_op"


class Summary:
    """What one traced window holds."""

    def __init__(self, events) -> None:
        rows = []
        for e in events:
            start = e.start_ns()
            rows.append((_kind(e), e.name(), start, start + e.duration_ns(),
                         str(e.device_type()).endswith("CUDA")))
        wins = [r for r in rows if r[1] == WINDOW and not r[4]]
        if not wins:
            raise ValueError(f"the trace holds no {WINDOW} span")
        t0, t1 = wins[0][2], wins[0][3]
        self.window_s = (t1 - t0) * 1e-9
        host_spans = {r[1] for r in rows if not r[4]}

        def inside(r):
            return r[3] > t0 and r[2] < t1

        self.units = sum(1 for r in rows if r[1] == UNIT and not r[4]
                         and inside(r))
        self.launches = sum(1 for r in rows if not r[4] and r[1] in LAUNCHES
                            and inside(r))
        device = [r for r in rows if r[4] and inside(r)
                  and r[0] in DEVICE_KINDS and r[1] not in host_spans]
        self.kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        self.copies: Dict[str, float] = defaultdict(float)
        for kind, name, s, e, _ in device:
            dur = (min(e, t1) - max(s, t0)) * 1e-9
            if kind == "kernel":
                self.kernels[name][0] += dur
                self.kernels[name][1] += 1
            elif kind == "gpu_memcpy":
                self.copies[name] += dur
        busy = []
        for _, _, s, e, _ in sorted(device, key=lambda r: r[2]):
            s, e = max(s, t0), min(e, t1)
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], e)
            else:
                busy.append([s, e])
        self.busy_s = sum(e - s for s, e in busy) * 1e-9
        gaps = [(a[1], b[0]) for a, b in zip([[t0, t0]] + busy,
                                             busy + [[t1, t1]])
                if b[0] > a[1]]
        host = sorted(((r[2], r[3], r[1]) for r in rows
                       if not r[4] and r[0] in HOST_KINDS
                       and r[1] != WINDOW), key=lambda r: r[0])
        self.idle_by_host = _attribute(gaps, host)

    def kernel_s(self, stems: Tuple[str, ...]) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose names hold any
        of ``stems``."""
        s, n = 0.0, 0
        for name, (dur, count) in self.kernels.items():
            if any(stem in name for stem in stems):
                s += dur
                n += count
        return s, n

    def copy_s(self, directions: Tuple[str, ...] = ("HtoD", "DtoH")
               ) -> float:
        return sum(d for name, d in self.copies.items()
                   if any(x in name for x in directions))

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(((name, d) for name, (d, _) in self.kernels.items()),
                     key=lambda x: -x[1])[:n]
        gaps = sorted(self.idle_by_host.items(), key=lambda x: -x[1])[:n]
        return {"device_ops": [[name[:160], d] for name, d in ops],
                "idle_gaps": [[name[:160], d] for name, d in gaps]}


def _attribute(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost host span (an op or a span, on any
    thread) that was open at each gap's midpoint; "none" where none was."""
    starts = [h[0] for h in host]
    out: Dict[str, float] = defaultdict(float)
    active: List[tuple] = []
    i = 0
    for a, b in sorted(gaps):
        mid = (a + b) // 2
        j = bisect.bisect_right(starts, mid)
        active.extend(host[i:j])
        i = max(i, j)
        active = [h for h in active if h[1] >= mid]
        label: Optional[str] = None
        if active:
            label = max(active, key=lambda h: (h[0], -h[1]))[2]
        out[label or "none"] += (b - a) * 1e-9
    return dict(out)


def summarize(prof) -> Summary:
    return Summary(prof.profiler.kineto_results.events())
