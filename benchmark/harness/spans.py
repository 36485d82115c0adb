"""The program's own spans in a traced window: the ``ofd.*`` ranges that
``opticalflowfromdepth_torch/utils/profiling.annotate`` opens, read from
the profiler's raw events (``prof.profiler.kineto_results.events()``, the
list that ``trace.summarize`` reduces).

Each kernel, copy and memset of the window is linked to the host call that
launched it through the trace's correlation ids: its ``linked_correlation_id``
names the innermost host range open at the launch (an operator or a span),
its ``correlation_id`` the runtime's launch call. The device event then
belongs to every span open when that call started (it is *under* them), and
is given (*own*) to the innermost of them by latest start: on the launching
thread first, else on any thread (the autograd engine's thread launches the
backward's kernels while the main thread sits in ``ofd.train.backward``).
A device gap that opens while an ``ofd.sync.*`` span is open on any thread
is *sync idle*: the card ran dry while the host waited on it. Device time
is clipped to the window, as ``trace.Summary`` clips it. Times are seconds.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import trace

PREFIX = "ofd."
SYNC = "ofd.sync."
RUNTIME = ("cuda_runtime", "cuda_driver")       # the launch calls' kinds
RANGES = ("cpu_op", "user_annotation")          # what a linked id names


def _get(e, attr: str):
    """``e.<attr>()``, or None where the event has no such field (or reads
    0, the profiler's "none")."""
    fn = getattr(e, attr, None)
    value = fn() if callable(fn) else None
    return value or None


class _Row:
    __slots__ = ("kind", "name", "start", "end", "device", "corr", "linked",
                 "tid")

    def __init__(self, e) -> None:
        self.kind = trace._kind(e)
        self.name = e.name()
        self.start = e.start_ns()
        self.end = self.start + e.duration_ns()
        self.device = str(e.device_type()).endswith("CUDA")
        self.corr = _get(e, "correlation_id")
        self.linked = _get(e, "linked_correlation_id")
        self.tid = _get(e, "start_thread_id")


def _launch(d: _Row, ops: dict, runtime: dict
            ) -> Tuple[Optional[int], Optional[int], str]:
    """When and on which thread ``d`` was launched, and by which link
    ("op", "runtime" or "none"). The host range that ``linked`` names must
    have started before the device event, and hold the runtime's call where
    that is known too (the two ids count apart, so a number can name a host
    range by chance)."""
    r = runtime.get(d.corr)
    h = ops.get(d.linked)
    if h is not None and (h.start > d.start or r is not None
                          and not h.start <= r.start <= h.end):
        h = None
    if h is not None:
        return (r.start if r is not None else h.start), h.tid, "op"
    if r is not None:
        return r.start, r.tid, "runtime"
    return None, None, "none"


class Spans:
    """What the program's spans hold in one traced window.

    ``found``: the window holds an ``ofd.*`` span. ``under``: device seconds
    under each span name; ``own``: given to each as the innermost;
    ``unattributed_s``: under no span (or not linked to a launch);
    ``links``: device events by how they were linked; ``sync_idle_s``: idle
    seconds whose gap opened inside an ``ofd.sync.*`` span (``sync_idle``:
    by that span's name); ``spans``: how many times each name opened in the
    window."""

    def __init__(self, events) -> None:
        rows = [_Row(e) for e in events]
        wins = [r for r in rows if r.name == trace.WINDOW and not r.device]
        if not wins:
            raise ValueError(f"the trace holds no {trace.WINDOW} span")
        t0, t1 = wins[0].start, wins[0].end
        host = [r for r in rows if not r.device]
        host_names = {r.name for r in host}
        spans = sorted((r for r in host if r.name.startswith(PREFIX)),
                       key=lambda r: r.start)
        self.spans: Dict[str, int] = defaultdict(int)
        for s in spans:
            if s.end > t0 and s.start < t1:
                self.spans[s.name] += 1
        self.found = bool(self.spans)
        ops = {r.corr: r for r in host
               if r.corr is not None and r.kind in RANGES}
        runtime = {r.corr: r for r in host
                   if r.corr is not None and r.kind in RUNTIME}
        device = [r for r in rows if r.device and r.kind in trace.DEVICE_KINDS
                  and r.name not in host_names and r.end > t0
                  and r.start < t1]

        self.links: Dict[str, int] = defaultdict(int)
        launched = []
        for d in device:
            t, tid, how = _launch(d, ops, runtime)
            self.links[how] += 1
            launched.append((t, tid, d))
        # (duration, kernel name, kind, names open at the launch, innermost)
        self.device: List[tuple] = []
        self.under: Dict[str, float] = defaultdict(float)
        self.own: Dict[str, float] = defaultdict(float)
        self.unattributed_s = 0.0
        active: List[_Row] = []
        i = 0
        for t, tid, d in sorted(launched, key=lambda x: (x[0] is not None,
                                                         x[0] or 0)):
            dur = (min(d.end, t1) - max(d.start, t0)) * 1e-9
            inner = None
            names: frozenset = frozenset()
            if t is not None:
                while i < len(spans) and spans[i].start <= t:
                    active.append(spans[i])
                    i += 1
                active = [s for s in active if s.end > t]
                if active:
                    mine = [s for s in active if s.tid == tid] or active
                    inner = max(mine, key=lambda s: (s.start, -s.end)).name
                    names = frozenset(s.name for s in active)
            self.device.append((dur, d.name, d.kind, names, inner))
            for name in names:
                self.under[name] += dur
            if inner is None:
                self.unattributed_s += dur
            else:
                self.own[inner] += dur

        self.sync_idle: Dict[str, float] = defaultdict(float)
        syncs = [s for s in spans if s.name.startswith(SYNC)]
        starts = [s.start for s in syncs]
        for a, b in _gaps(device, t0, t1):
            open_ = [s for s in syncs[:bisect.bisect_right(starts, a)]
                     if s.end > a]
            if open_:
                self.sync_idle[open_[-1].name] += (b - a) * 1e-9
        self.sync_idle_s = sum(self.sync_idle.values())

    def under_s(self, *names: str) -> Optional[float]:
        """Device seconds under any of ``names`` (each event once); None
        where none of them opened in the window."""
        if not any(n in self.spans for n in names):
            return None
        want = set(names)
        return sum(dur for dur, _, _, open_, _ in self.device
                   if want & open_)

    def kernels(self, under: Optional[str] = None) -> Dict[str, List[float]]:
        """Device seconds and count of each kernel of the window, or of
        those under the span name ``under``."""
        out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for dur, kernel, kind, open_, _ in self.device:
            if kind == "kernel" and (under is None or under in open_):
                out[kernel][0] += dur
                out[kernel][1] += 1
        return dict(out)

    def against_stems(self, name: str, stems: Tuple[str, ...]) -> dict:
        """The kernels under span ``name`` against those whose names hold
        one of ``stems`` (``readers``' way of finding an op's kernels):
        seconds of each set, and the kernels in one set alone."""
        under = self.kernels(name)
        stem = {k: v for k, v in self.kernels().items()
                if any(s in k for s in stems)}
        return {"span_s": sum(v[0] for v in under.values()),
                "stem_s": sum(v[0] for v in stem.values()),
                "span_only": {k: v for k, v in under.items()
                              if k not in stem},
                "stem_only": {k: v for k, v in stem.items()
                              if k not in under}}


def _gaps(device: List[_Row], t0: int, t1: int) -> List[Tuple[int, int]]:
    """The window's idle intervals (ns), as ``trace.Summary`` finds them."""
    busy: List[List[int]] = []
    for d in sorted(device, key=lambda r: r.start):
        s, e = max(d.start, t0), min(d.end, t1)
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    return [(a[1], b[0]) for a, b in zip([[t0, t0]] + busy, busy + [[t1, t1]])
            if b[0] > a[1]]

