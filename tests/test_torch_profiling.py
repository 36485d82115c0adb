"""The port's tracing and timing (``utils/profiling.py``) on the CPU: the
cases of ``tests/test_profiling.py``, and ``StepTimer`` against the JAX
package's on the same clock readings."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from opticalflowfromdepth_torch.utils import profiling as P
from opticalflowfromdepth_tpu.utils import profiling as JP

torch.set_num_threads(2)


def test_step_timer_stats():
    t = P.StepTimer(frames_per_step=8, warmup=1)
    t.start()
    for i in range(6):
        assert (t.tick(torch.ones(()) * i) is None) == (i == 0)
    s = t.summary()
    assert s["steps_timed"] == 5
    assert s["frames_per_s"] == 8 * s["steps_per_s"]
    assert s["p50_ms"] <= s["p90_ms"]
    assert P.StepTimer().summary() == {}


@pytest.mark.parametrize("warmup,start", [(0, True), (2, True), (3, False)])
def test_step_timer_equals_jax_on_one_clock(monkeypatch, warmup, start):
    """The same clock readings give the same warm-up, the same returned
    step times and the same summary as the JAX StepTimer."""
    stamps = np.cumsum(np.random.default_rng(warmup).uniform(
        0.01, 0.2, 40)).tolist()
    results = []
    for mod, fence in ((P, torch.zeros(())), (JP, None)):
        clock = iter(stamps)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        t = mod.StepTimer(frames_per_step=4, warmup=warmup)
        if start:
            t.start()
        ticks = [t.tick(fence) for _ in range(12)]
        results.append((ticks, t.summary()))
        monkeypatch.undo()
    assert results[0] == results[1]
    assert results[0][1]["steps_timed"] == 12 - warmup - (not start)


def test_tick_fences_only_card_tensors(monkeypatch):
    def no_card(*a):
        raise AssertionError("synchronize called for a CPU value")
    monkeypatch.setattr(torch.cuda, "synchronize", no_card)
    t = P.StepTimer(warmup=0)
    t.start()
    for fence in (torch.ones(3), None, 1.5, np.ones(2)):
        assert t.tick(fence) >= 0


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "prof")
    with P.trace(d) as prof:
        with P.annotate("matmul"):
            x = torch.ones((64, 64)) @ torch.ones((64, 64))
        assert float(x[0, 0]) == 64.0
    files = glob.glob(os.path.join(d, "*.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "matmul" in names and "aten::mm" in names
    assert any(e.key == "matmul" for e in prof.key_averages())
