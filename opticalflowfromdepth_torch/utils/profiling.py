"""Tracing and timing (port of
``opticalflowfromdepth_tpu/utils/profiling.py``).

The reference's only instrumentation is `count_time` wall-clock loops with
`torch.cuda.synchronize` (`adjusted_gmflow/evaluate.py:300-352`). Here:

  * :func:`trace`: ``torch.profiler`` over a block, the CPU's activity and
    the card's, written as a Chrome trace (``chrome://tracing``, Perfetto)
    into ``log_dir``;
  * :func:`annotate`: a named region in that trace;
  * :class:`StepTimer`: fenced step timing with running statistics (steps/s,
    frames/s, mean, p50, p90), the `count_time` counterpart.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None):
    """Profile the block into ``log_dir/trace_<pid>_<ns>.json``; yields the
    ``torch.profiler.profile`` (its ``key_averages()`` after the block).
    ``cuda`` (default: whether a card is present) adds the card's
    kernels and copies to the CPU's operators."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() if cuda is None else cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    with prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region of the trace (use as a context manager)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Running step statistics with explicit device fencing.

    >>> timer = StepTimer(frames_per_step=batch_size, warmup=5)
    >>> timer.start()
    >>> for batch in loader:
    ...     state, metrics = step(state, batch)
    ...     timer.tick(metrics["total_loss"])   # waits for the card
    >>> timer.summary()   # {steps_per_s, frames_per_s, mean_ms, p50_ms, ...}
    """

    def __init__(self, frames_per_step: int = 1, warmup: int = 5):
        self.frames_per_step = frames_per_step
        self.warmup = warmup
        self._seen = 0
        self._times: list = []
        self._last: Optional[float] = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self, fence_on=None) -> Optional[float]:
        """Record one step. When ``fence_on`` is a tensor on the card, the
        card is synchronized first, so the interval covers the step's
        device work, not its enqueue. Returns the step time in seconds
        (None during warm-up)."""
        if isinstance(fence_on, torch.Tensor) and fence_on.is_cuda:
            torch.cuda.synchronize(fence_on.device)
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return None
        dt = now - self._last
        self._last = now
        self._seen += 1
        if self._seen <= self.warmup:
            return None
        self._times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        ts = sorted(self._times)
        n = len(ts)
        mean = sum(ts) / n
        return {
            "steps_timed": float(n),
            "mean_ms": mean * 1e3,
            "p50_ms": ts[n // 2] * 1e3,
            "p90_ms": ts[min(n - 1, int(n * 0.9))] * 1e3,
            "steps_per_s": 1.0 / mean,
            "frames_per_s": self.frames_per_step / mean,
        }
