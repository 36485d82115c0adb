"""Training cells: a closed loop of train steps on a resident pool.

Set-up makes the weights and the pool from the seed on the card, builds
the program's training state from those weights, and drives it through
the traffic's ``checked_steps`` first steps (the warm-up of every shape
the window uses) on the pool's first batches, each of other rows. Those
steps are read as they happen: each step's loss and classifier loss, what
the first step's stages make (the configuration's ``capture``), the first
gradient as the optimizer took it, and each leaf's change after the last
of them. The window then runs step after step over the pool from where
set-up stopped. Once it has closed and the peak memory is read, the
program is freed and the plain reference, in true f32, follows the same
first steps from the same weights on the same batches
(``compare.train_checks``), and takes each stage of the first step from
what the program fed it (the configuration's ``stage_checks``).

``fault`` (never set by a benchmark run): ``unchanged`` restores every
parameter after each step, ``half_batch`` lets the loss's gradient come
from the first half of each batch's rows alone, as a mean over them (the
forward still takes every row and the loss reads the same), ``control``
puts the reference in fp8 in the program's place.
"""

from __future__ import annotations

import contextlib
import time

import torch

from harness import compare, precision, runner, traffic as traffic_mod
from harness import weights as weights_mod


class _Control:
    """The reference in fp8 behind the program's interface."""

    def __init__(self, glue, cfg, W, A):
        from harness import refs
        self.trainer = refs.Trainer(
            W, glue.reference.train_loss(precision.FP8(), cfg, A),
            cfg["train"])
        self.extra = None

    def step(self, batch):
        with precision.true_f32():
            loss, extra = self.trainer.step(batch)
        self.extra = extra
        out = {"total_loss": loss, "skipped_nan": torch.zeros(())}
        if "classify_loss" in extra:
            out["classify_loss"] = extra["classify_loss"]
        return out

    def params(self):
        return self.trainer.params

    def first_grads(self):
        return self.trainer.first_grads

    @contextlib.contextmanager
    def capture(self):
        box = {}
        yield box
        box.update((k, self.extra[k]) for k in
                   ("flow", "features", "matching", "propagated"))


def _first_half_rows(_module, _inputs, out):
    """The predictions with their values kept and their gradient that of a
    mean over the first half of the rows: ``2 p - p`` there (exact in
    floating point), ``p`` detached in the rest."""
    def half(p):
        k = p.shape[0] // 2
        return torch.cat([2 * p[:k] - p[:k].detach(), p[k:].detach()])
    return dict(out, flow_preds=[half(p) for p in out["flow_preds"]])


def faulty(prog, fault):
    """``prog.step`` with the planted ``fault`` (module docstring)."""
    if fault == "half_batch":
        prog.module().register_forward_hook(_first_half_rows)

    def step(batch):
        saved = None
        if fault == "unchanged":
            saved = {n: p.detach().clone() for n, p in prog.params().items()}
        m = prog.step(batch)
        if saved is not None:
            with torch.no_grad():
                for n, p in prog.params().items():
                    p.copy_(saved[n])
        return m
    return step


def program_readings(prog, step, batches, W) -> dict:
    """The checked steps, read as the program takes them."""
    losses, cls = [], []
    for k, batch in enumerate(batches):
        if k == 0:
            with prog.capture() as box:
                m = step(batch)
            grads = compare.norms(prog.first_grads())
        else:
            m = step(batch)
        losses.append(float(m["total_loss"]))
        if "classify_loss" in m:
            cls.append(float(m["classify_loss"]))
    changes = compare.norms({n: p.detach() - W[n]
                             for n, p in prog.params().items()})
    return dict(losses=losses, cls_losses=cls, flow=box["flow"].float(),
                features=box["features"].float(), grads=grads,
                changes=changes, box=box)


def reference_readings(glue, cfg, W, A, batches, P) -> dict:
    from harness import refs
    with precision.true_f32():
        r = refs.train_steps(W, batches,
                             glue.reference.train_loss(P, cfg, A),
                             cfg["train"])
    return dict(losses=r["losses"],
                cls_losses=[e["classify_loss"] for e in r["extras"]
                            if "classify_loss" in e],
                flow=r["extras"][0]["flow"],
                features=r["extras"][0]["features"],
                grads=compare.norms(r["first_grads"]),
                changes=compare.norms(r["changes"]))


def inputs(cell, seed: int, device):
    """The weights (the model's and the classifier's) and the pool, drawn
    from the seed on the device."""
    cfg, glue = cell.config, cell.glue
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    W = weights_mod.make(glue.reference.param_spec(cfg), gen, device)
    A = weights_mod.make(glue.reference.aux_spec(cfg), gen, device) \
        if cfg["train"]["add_classifier"] else {}
    return W, A, traffic_mod.train_pool(cell.traffic, gen, device)


def build(cell, W, A, device, fault=None):
    """The program (or with ``fault="control"`` the reference in fp8) and
    its step with the planted fault."""
    if fault == "control":
        prog = _Control(cell.glue, cell.config, W, A)
    else:
        prog = cell.glue.program(cell.config, W, A, device)
    return prog, faulty(prog, fault)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        fault=None) -> dict:
    traffic, glue = cell.traffic, cell.glue
    runner.phase("imports", t0)
    W, A, pool = inputs(cell, seed, device)
    runner.phase("weights and pool", t0)
    prog, step = build(cell, W, A, device, fault)
    runner.phase("program", t0)
    n_check = traffic["checked_steps"]
    got = program_readings(prog, step, pool[:n_check], W)
    runner.sync(device)
    setup_s = time.perf_counter() - t0

    skipped = []

    def unit(i):
        skipped.append(step(pool[(n_check + i) % len(pool)])["skipped_nan"])

    window = runner.Window(seconds, trace, device, traffic.get("trace_units"))
    window.run(unit)
    failed = int(sum(float(s) for s in skipped))
    device_rec = runner.device_record(device, cell.workload["chips"])
    del prog, step, skipped
    runner.free(device)

    ref = reference_readings(glue, cell.config, W, A, pool[:n_check],
                             precision.F32())
    checks = dict(compare.train_checks(got, ref),
                  **glue.stage_checks(cell.config, W, A, pool[0], got["box"]))
    runner.phase("reference", t0)
    pairs = window.units * traffic["batch"]
    if trace:
        device_rec["busy_s"] = window.summary.busy_s
        device_rec["window_s"] = window.summary.window_s
        reading = runner.Reading(cell, window, traffic["batch"],
                                 glue.work(cell.config, traffic))
        metrics = runner.per_layer(cell, reading)
        breakdown = window.summary.breakdown()
    else:
        metrics = runner.end_to_end(cell, {
            "train_pairs_per_s": pairs / window.window_s,
            "setup_s": setup_s})
        breakdown = None
    return runner.result(cell, checks, window.units, failed, metrics,
                         device_rec, breakdown)


def calibrate(cell, seed: int, kinds, device) -> dict:
    """The numbers of ``kinds`` on one seed, each against one reference
    run, with a look at the worst leaves. A kind is "program", a fault's
    name, "program_f32" (the program's own f32 path: a witness) or
    "reference_bf16" (the reference from bf16 operands: what rounding
    alone reads)."""
    W, A, pool = inputs(cell, seed, device)
    batches = pool[:cell.traffic["checked_steps"]]
    got = {}
    for kind in kinds:
        if kind == "reference_bf16":
            got[kind] = reference_readings(cell.glue, cell.config, W, A,
                                           batches, precision.BF16())
            continue
        if kind == "program_f32":
            c = dict(cell.config, dtype="float32")
            prog = cell.glue.program(c, W, A, device)
            step = faulty(prog, None)
        else:
            prog, step = build(cell, W, A, device,
                               None if kind == "program" else kind)
        got[kind] = program_readings(prog, step, batches, W)
        del prog, step
        runner.free(device)
    ref = reference_readings(cell.glue, cell.config, W, A, batches,
                             precision.F32())
    out = {}
    for kind, g in got.items():
        stages = {} if "box" not in g else cell.glue.stage_checks(
            cell.config, W, A, batches[0], g["box"])
        out[kind] = dict(compare.train_checks(g, ref), **stages,
                         look=compare.worst_leaves(g, ref))
    return out
