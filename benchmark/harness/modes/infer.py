"""Offline inference cells: one caller in a closed loop, each call a batch
of pairs from host arrays to flow on the host.

Set-up makes the weights on the card and the pool of calls' inputs (host
NHWC f32 arrays, padded as the model takes them) from the seed, builds the
program's inference function from those weights and warms it up on the
pool (one shape). The window calls it on the pool's batches in turn, each
call timed on the host clock from the arrays in to the flow out. A sample
of the window's calls, drawn from the seed as they happen (a reservoir of
``checked_calls``), keeps its answers. Once the window has closed and the
peak memory is read, the program is freed and the plain reference, in true
f32, computes those calls' flows again from the same inputs and weights;
``checks`` decides.

``fault`` (never set by a benchmark run): ``half_batch`` sends the first
half of each call's pairs, ``altered`` shifts the first pair's answer by
one pixel, ``control`` puts the reference in fp8 in the program's place.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import compare, precision, runner, traffic as traffic_mod
from harness import weights as weights_mod


def reference_flow(glue, cfg, W, i1, i2, P, device) -> torch.Tensor:
    with precision.true_f32():
        return glue.reference.infer(
            P, W, cfg, torch.from_numpy(i1).to(device),
            torch.from_numpy(i2).to(device))


def _control(cell, W, device):
    """The reference in fp8 in the program's place."""
    def call(i1, i2):
        return reference_flow(cell.glue, cell.config, W, i1, i2,
                              precision.FP8(), device).cpu().numpy()
    return call


def faulty(call, fault):
    """``call`` (the program or the control) with the planted ``fault``
    (module docstring)."""
    def infer(i1, i2):
        if fault == "half_batch":
            i1, i2 = i1[:len(i1) // 2], i2[:len(i2) // 2]
        out = call(i1, i2)
        if fault == "altered":
            out = out.copy()
            out[0] += 1.0
        return out
    return infer


def inputs(cell, seed: int, device):
    """The weights on the device and the pool of calls' host inputs, drawn
    from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    W = weights_mod.make(cell.glue.reference.param_spec(cell.config), gen,
                         device)
    return W, traffic_mod.infer_pool(cell.traffic, gen, device)


def build(cell, W, device, fault=None):
    """The program's inference function (or with ``fault="control"`` the
    reference in fp8) with the planted fault."""
    if fault == "control":
        call = _control(cell, W, device)
    else:
        call = cell.glue.program(cell.config, W, device)
    return faulty(call, fault)


def checks(cell, W, pool, answers, device) -> dict:
    """The numbers, against the reference in f32, over the answers
    (``answers``: (pool index, flow) pairs): the widest gap of a pair
    (``flow_gap``) and the widest ratio of a call's gap to the gap that
    rounding the reference's operands to bf16 makes on that call
    (``flow_ratio``: the configurations' own precision as the yardstick,
    so the rounding's amplification through the model, which varies with
    the seed, divides out)."""
    gap, ratio = 0.0, 0.0
    for idx, flow in answers:
        ref = reference_flow(cell.glue, cell.config, W, *pool[idx],
                             precision.F32(), device)
        bf16 = reference_flow(cell.glue, cell.config, W, *pool[idx],
                              precision.BF16(), device)
        got = torch.from_numpy(flow)
        gap = max(gap, compare.entry_gap(got, ref))
        ratio = max(ratio, compare.gap_ratio(got, bf16, ref))
        del ref, bf16
    return {"flow_gap": gap, "flow_ratio": ratio}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        fault=None) -> dict:
    cfg, traffic, glue = cell.config, cell.traffic, cell.glue
    runner.phase("imports", t0)
    W, pool = inputs(cell, seed, device)
    runner.phase("weights and pool", t0)
    call = build(cell, W, device, fault)
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
    del call
    runner.free(device)

    found = checks(cell, W, pool, sample, device)
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
    W, pool = inputs(cell, seed, device)
    idxs = [i % len(pool) for i in range(cell.traffic["checked_calls"])]
    got = {}
    for kind in kinds:
        call = build(cell, W, device, None if kind == "program" else kind)
        call(*pool[0])
        got[kind] = [(i, call(*pool[i])) for i in idxs]
        del call
        runner.free(device)
    return {kind: checks(cell, W, pool, answers, device)
            for kind, answers in got.items()}
