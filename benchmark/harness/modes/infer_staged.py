"""Offline inference cells checked stage by stage: ``infer.py``'s closed
loop (one caller, each call a batch of pairs from host arrays to flow on
the host; a reservoir of ``checked_calls`` of the window's answers drawn
from the seed), checked the way the training cells check their first
step. Where whole-model numbers cannot tell rounding from a fault (a
softmax over thousands of cells flips between near ties as the operands
round), each stage is held to the reference from what the program made
before it.

Once the window has closed and the peak memory is read, the program runs
each sampled call's inputs once more and keeps what each of its stages
made (the configuration's ``Program.capture``). Then it is freed, and the
plain reference, in true f32, takes every stage again from the program's
own state; the last stage is held against the answer the window returned
(the configuration's ``stage_checks``, which also give ``infer.py``'s
whole-model ``flow_gap`` and ``flow_ratio``).

``fault`` (never set by a benchmark run): as ``infer.py``'s, on the
window's answers; ``control`` keeps the fp8 reference's own stages. The
run that keeps the stages is the program's (or the control's), unfaulted.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from harness import precision, runner
from harness.modes import infer


class _Control:
    """The reference in fp8 behind the program's interface; ``capture``
    keeps its stages as the program's are kept."""

    def __init__(self, cell, W, device) -> None:
        self.reference = cell.glue.reference
        self.cfg, self.W, self.device = cell.config, W, device
        self.probe = None

    def __call__(self, i1, i2):
        with precision.true_f32():
            return self.reference.infer(
                precision.FP8(), self.W, self.cfg,
                torch.from_numpy(i1).to(self.device),
                torch.from_numpy(i2).to(self.device),
                self.probe).cpu().numpy()

    @contextlib.contextmanager
    def capture(self):
        self.probe = {}
        try:
            yield self.probe
        finally:
            self.probe = None


def build(cell, W, device, fault=None):
    """The program (or with ``fault="control"`` the reference in fp8) and
    its call with the planted fault."""
    prog = _Control(cell, W, device) if fault == "control" \
        else cell.glue.program(cell.config, W, device)
    return prog, infer.faulty(prog, fault)


def kept(prog, pool, answers) -> list:
    """Each sampled call's stages, from the program run once more on its
    inputs."""
    boxes = []
    for idx, _ in answers:
        with prog.capture() as box:
            prog(*pool[idx])
        boxes.append(box)
    return boxes


def checks(cell, W, pool, answers, boxes, device) -> dict:
    """The configuration's stage numbers, the worst over the sampled
    calls."""
    out = {}
    for (idx, flow), box in zip(answers, boxes):
        nums = cell.glue.stage_checks(cell.config, W, pool[idx], box, flow,
                                      device)
        for name, value in nums.items():
            out[name] = max(out.get(name, 0.0), value)
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        fault=None) -> dict:
    cfg, traffic, glue = cell.config, cell.traffic, cell.glue
    runner.phase("imports", t0)
    W, pool = infer.inputs(cell, seed, device)
    runner.phase("weights and pool", t0)
    prog, call = build(cell, W, device, fault)
    runner.phase("program", t0)
    for k in range(traffic["warmup_calls"]):
        call(*pool[k % len(pool)])
    runner.sync(device)
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(seed)
    keep = traffic["checked_calls"]
    sample = []                     # (pool index, answer)
    latency = []
    shape = pool[0][0].shape[:3] + (2,)
    bad = [0]

    def unit(i):
        i1, i2 = pool[i % len(pool)]
        start = time.perf_counter()
        out = call(i1, i2)
        latency.append(time.perf_counter() - start)
        if out.shape != shape:
            bad[0] += 1
        if i < keep:
            sample.append((i % len(pool), out))
        else:
            j = int(rng.integers(0, i + 1))
            if j < keep:
                sample[j] = (i % len(pool), out)

    window = runner.Window(seconds, trace, device, traffic.get("trace_units"))
    window.run(unit)
    device_rec = runner.device_record(device, cell.workload["chips"])
    boxes = kept(prog, pool, sample)
    del call, prog
    runner.free(device)

    found = checks(cell, W, pool, sample, boxes, device)
    runner.phase("reference", t0)
    pairs = window.units * traffic["batch"]
    if trace:
        device_rec["busy_s"] = window.summary.busy_s
        device_rec["window_s"] = window.summary.window_s
        reading = runner.Reading(cell, window, traffic["batch"],
                                 glue.work(cfg, traffic))
        metrics = runner.per_layer(cell, reading)
        breakdown = window.summary.breakdown()
    else:
        metrics = runner.end_to_end(cell, {
            "infer_pairs_per_s": pairs / window.window_s,
            "infer_call_ms_p95": float(np.percentile(latency, 95)) * 1e3,
            "setup_s": setup_s})
        breakdown = None
    return runner.result(cell, found, window.units, bad[0], metrics,
                         device_rec, breakdown)


def calibrate(cell, seed: int, kinds, device) -> dict:
    """The numbers of ``kinds`` ("program", or a fault's name) on one
    seed: the pool's first ``checked_calls`` calls as the sample."""
    W, pool = infer.inputs(cell, seed, device)
    idxs = [i % len(pool) for i in range(cell.traffic["checked_calls"])]
    out = {}
    for kind in kinds:
        prog, call = build(cell, W, device,
                           None if kind == "program" else kind)
        call(*pool[0])
        answers = [(i, call(*pool[i])) for i in idxs]
        boxes = kept(prog, pool, answers)
        del call, prog
        runner.free(device)
        out[kind] = checks(cell, W, pool, answers, boxes, device)
        del boxes
    return out
