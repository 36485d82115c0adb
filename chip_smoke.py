#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a host with one CUDA card. Phases:

1. card: its name and power limit (nvidia-smi); TF32 off for f32 phases;
2. build: the CUDA kernels from ``opticalflowfromdepth_torch/csrc`` (one
   nvcc per source, in parallel) and the first Triton launch;
3. each kernel against its plain PyTorch version on the card, with the
   tolerance stated, plus the edge cases; times with CUDA events:
   [3a] the fused lookup and [3b] instance norm at the shapes RAFT-basic
   serving gives them at Sintel size (440x1024 padded); [3c] the lookup's
   backward and [3d] instance norm's gradient at the training shapes
   (batch 8, 368x496);
4. serving parity: RAFT-basic on one 128x256 pair, 6 iterations, f32, on
   the card (kernels) against the CPU (plain versions), same weights;
5. the serving path: full-width RAFT-basic (bf16, fused correlation, 24
   iterations, seeded random weights) serving 3 pairs of 436x1024 through
   ``InputPadder`` and ``raft_infer_fn``, with the launch counts checked
   (24 lookups and 15 instance norms per pair) and a profile of one pair;
6. train-step parity: one f32 step of RAFT-basic with the classifier,
   64x96, batch 2, on the card against the CPU, same weights and batch;
7. the training path: seeded npz shards at 384x512 -> ``AugmentedShards``
   (crop 368x496) -> ``Loader`` (batch 8) -> ``TrainRunner`` over
   ``make_train_step`` (RAFT-basic bf16, fused correlation, 12
   iterations, frozen classifier): one warm-up step, 5 timed steps with
   the launch counts checked (12 lookups, 12 lookup backwards and 15
   instance norms per step), a profile of one step, then the ``latest``
   and weights checkpoints, the weights served by the serving model;
8. a learning check: 30 steps on one fixed batch at 184x248, batch 4;
   the loss must fall;
9. a ``{"kernels": [...]}`` line, the card line, and last the line
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. Without a CUDA
device, or without the package beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16, data sheet
SINTEL = (436, 1024)
TRAIN_CROP, TRAIN_BATCH, TRAIN_ITERS = (368, 496), 8, 12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(name: str, err: float, tol: float) -> None:
    print(f"  {name}: max diff {err:.3e} (tolerance {tol:g})", flush=True)
    if not err <= tol:
        fail(f"{name}: max diff {err:.3e} > {tol:g}")


def max_rel_excess(got, ref, rtol: float, atol: float) -> float:
    """max |got-ref| / (atol + rtol*|ref|): <= 1 means within tolerance."""
    d = (got.float() - ref.float()).abs()
    return float((d / (atol + rtol * ref.float().abs())).max())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def valid_taps(coords, meta, radius: int) -> int:
    """Neighbour dot products this run's coordinates need (in range)."""
    import torch
    d = torch.arange(2 * radius + 2, device=coords.device) - radius
    total = 0
    for li, (hl, wl, _hp, _off) in enumerate(meta):
        if hl == 0 or wl == 0:
            continue
        c = torch.floor(coords.float() / 2.0 ** li)
        xs = c[..., 0:1] + d
        ys = c[..., 1:2] + d
        nx = ((xs >= 0) & (xs < wl)).sum(-1)
        ny = ((ys >= 0) & (ys < hl)).sum(-1)
        total += int((nx * ny).sum())
    return total


def corr_inputs(gen, b, h, w, dtype, spread, shift=0.0, c=256, levels=4):
    """Seeded f1 ``[B, N, C]``, packed f2cat and coordinates around the
    identity grid (+- spread px, moved by shift) on the card."""
    import torch
    from opticalflowfromdepth_torch.ops import fused_corr as fc
    f1 = torch.randn(b, h, w, c, generator=gen).cuda()
    f2 = torch.randn(b, h, w, c, generator=gen).cuda()
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    base = torch.stack([xx, yy], -1).float()[None].repeat(b, 1, 1, 1)
    coords = base + (torch.rand(b, h, w, 2, generator=gen) * 2 - 1) \
        * spread + shift
    f2cat = fc.corr_levels_cat(f2, levels, dtype)
    return (f1.to(dtype).reshape(b, h * w, c), f2cat,
            coords.reshape(b, h * w, 2).cuda())


def fused_corr_phase(gen):
    import torch
    from opticalflowfromdepth_torch.ops import fused_corr as fc

    print("[3a] fused correlation lookup: CUDA kernel vs plain", flush=True)
    h8, w8 = (SINTEL[0] + 4) // 8, SINTEL[1] // 8      # 55 x 128
    c, levels, radius = 256, 4, 4

    def inputs(b, h, w, dtype, spread, shift=0.0):
        return corr_inputs(gen, b, h, w, dtype, spread, shift, c, levels)

    worst = 0.0
    for dtype, rtol, atol in ((torch.float32, 0.0, 1e-4),
                              (torch.bfloat16, 2e-2, 2e-2)):
        for label, (b, h, w, spread, shift) in (
                ("serving 55x128", (1, h8, w8, 20.0, 0.0)),
                (f"train {TRAIN_CROP[0] // 8}x{TRAIN_CROP[1] // 8} "
                 f"B={TRAIN_BATCH}", (TRAIN_BATCH, TRAIN_CROP[0] // 8,
                                      TRAIN_CROP[1] // 8, 20.0, 0.0)),
                ("ragged N=63", (2, 7, 9, 6.0, 0.0)),
                ("far out of range", (1, h8, w8, 0.0, 1e4))):
            f1, f2cat, coords = inputs(b, h, w, dtype, spread, shift)
            got = fc.fused_corr_lookup_cat(f1, f2cat, coords, h, w, levels,
                                           radius)
            torch.cuda.synchronize()
            ref = fc.fused_corr_lookup_cat_plain(f1, f2cat, coords, h, w,
                                                 levels, radius)
            if got.shape != ref.shape or got.dtype != ref.dtype:
                fail(f"fused corr {label}: {got.shape}/{got.dtype} vs "
                     f"{ref.shape}/{ref.dtype}")
            if shift:
                if torch.count_nonzero(got):
                    fail("fused corr: out-of-range lookups are not all 0")
                print(f"  {label} {dtype}: all outputs exactly 0", flush=True)
                continue
            err = float((got.float() - ref.float()).abs().max())
            check(f"{label} {dtype} (|d| <= {atol:g} + {rtol:g}|ref|)",
                  max_rel_excess(got, ref, rtol, atol), 1.0)
            print(f"    max abs diff {err:.3e}", flush=True)
            if label.startswith("train"):
                worst = max(worst, err)

    # serving shape (one pair) printed; training shape (batch 8, the
    # shape of the launches counted on this slice's main path) recorded
    fused_corr_timing(gen, 1, h8, w8, "serving")
    ms, plain_ms, bound_ms, bound_by = fused_corr_timing(
        gen, TRAIN_BATCH, TRAIN_CROP[0] // 8, TRAIN_CROP[1] // 8, "training")
    return dict(name="fused_corr_lookup", route="cuda",
                source="opticalflowfromdepth_torch/csrc/fused_corr.cu",
                replaces="opticalflowfromdepth_tpu/ops/fused_corr.py:140",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def fused_corr_timing(gen, b, h8, w8, what):
    """Kernel, plain and bound times of one bf16 lookup at ``[b, h8*w8]``."""
    import torch
    from opticalflowfromdepth_torch.ops import fused_corr as fc
    c, levels, radius = 256, 4, 4
    f1, f2cat, coords = corr_inputs(gen, b, h8, w8, torch.bfloat16, 20.0)
    meta = fc.cat_meta(h8, w8, levels)
    ms = cuda_ms(lambda: fc.fused_corr_lookup_cat(f1, f2cat, coords, h8, w8,
                                                  levels, radius))
    plain_ms = cuda_ms(lambda: fc.fused_corr_lookup_cat_plain(
        f1, f2cat, coords, h8, w8, levels, radius), reps=5)
    n = b * h8 * w8
    k2 = (2 * radius + 1) ** 2
    nbytes = (f1.numel() + f2cat.numel() + n * levels * k2) * 2 \
        + coords.numel() * 4
    ops = 2 * c * valid_taps(coords, meta, radius) + 10 * n * levels * k2
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOP_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_FLOP_PER_S \
        else "operations"
    print(f"  {what}: bf16 [{b},{h8 * w8},{c}] x R={f2cat.shape[1]}: kernel "
          f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}: {nbytes / 1e6:.2f} MB, "
          f"{ops / 1e9:.3f} GFLOP)", flush=True)
    return ms, plain_ms, bound_ms, bound_by


FNET_SHAPES = ((2, 64, 220, 512), (2, 96, 110, 256), (2, 128, 55, 128))
TRAIN_FNET_SHAPES = tuple(
    (2 * TRAIN_BATCH, c, TRAIN_CROP[0] // s, TRAIN_CROP[1] // s)
    for c, s in ((64, 2), (96, 4), (128, 8)))


def instance_norm_phase(gen):
    import torch
    from opticalflowfromdepth_torch.ops import instance_norm as inorm

    print("[3b] instance norm: Triton kernel vs plain", flush=True)
    worst = 0.0
    for shape in FNET_SHAPES + TRAIN_FNET_SHAPES:
        x32 = (torch.randn(*shape, generator=gen) * 3 + 0.5).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for relu in (False, True):
                y, m, r = inorm.instance_norm(x, 1e-5, relu)
                torch.cuda.synchronize()
                yr, mr, rr = inorm.instance_norm_plain(x, 1e-5, relu)
                if y.dtype != dtype or m.dtype != torch.float32:
                    fail(f"instance norm dtypes {y.dtype}/{m.dtype}")
                tag = f"{list(shape)} {dtype} relu={relu}"
                # f32: sums in another order, so 1e-4; bf16: the kernel and
                # the plain version each round the f32 value once, so the
                # two may land one bf16 step (2^-7 relative) apart
                rtol, atol = (0.0, 1e-4) if dtype == torch.float32 \
                    else (2 ** -7, 1e-3)
                check(f"{tag} y", max_rel_excess(y, yr, rtol, atol), 1.0)
                check(f"{tag} mean", float((m - mr).abs().max()), 1e-5)
                check(f"{tag} rstd", max_rel_excess(r, rr, 1e-5, 0.0), 1.0)
                if dtype == torch.bfloat16 and shape in TRAIN_FNET_SHAPES:
                    worst = max(worst, float((y.float() - yr.float())
                                             .abs().max()))

    # one fnet forward (each shape 5 times, bf16, relu): serving (Sintel,
    # the stacked pair) printed; training (batch 8 of 368x496, the stacked
    # pairs: the shapes of the launches counted on this slice's main path)
    # recorded
    instance_norm_timing(gen, FNET_SHAPES, "serving")
    ms, plain_ms, lib_ms, bound_ms = instance_norm_timing(
        gen, TRAIN_FNET_SHAPES, "training")
    return dict(name="instance_norm", route="triton",
                source="opticalflowfromdepth_torch/ops/instance_norm.py",
                replaces="opticalflowfromdepth_tpu/ops/instance_norm.py:44",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms)


def instance_norm_timing(gen, shapes, what):
    """Kernel, plain, library and bound times of the 15 instance norms of
    one fnet forward (each shape 5 times), bf16 with ReLU."""
    import torch
    import torch.nn.functional as F
    from opticalflowfromdepth_torch.ops import instance_norm as inorm
    ms = plain_ms = lib_ms = bound_ms = 0.0
    for shape in shapes:
        x = torch.randn(*shape, generator=gen).cuda().to(torch.bfloat16)
        k_ms = cuda_ms(lambda: inorm.instance_norm(x, 1e-5, True))
        p_ms = cuda_ms(lambda: inorm.instance_norm_plain(x, 1e-5, True))
        l_ms = cuda_ms(lambda: F.relu(F.instance_norm(x, eps=1e-5)))
        b_ms = 2 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
        print(f"  {what}: bf16 {list(shape)}: kernel {k_ms * 1e3:.1f} us, "
              f"plain {p_ms * 1e3:.1f} us, F.instance_norm+relu "
              f"{l_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us (bytes)",
              flush=True)
        ms += 5 * k_ms
        plain_ms += 5 * p_ms
        lib_ms += 5 * l_ms
        bound_ms += 5 * b_ms
    print(f"  {what}: 15 calls of one fnet forward: kernel {ms * 1e3:.1f} us,"
          f" plain {plain_ms * 1e3:.1f} us, library {lib_ms * 1e3:.1f} us, "
          f"bound {bound_ms * 1e3:.1f} us", flush=True)
    return ms, plain_ms, lib_ms, bound_ms


def fused_corr_bwd_phase(gen):
    import torch
    from opticalflowfromdepth_torch.ops import fused_corr as fc

    print("[3c] fused lookup backward: CUDA kernel vs plain", flush=True)
    h8, w8 = TRAIN_CROP[0] // 8, TRAIN_CROP[1] // 8     # 46 x 62
    c, levels, radius = 256, 4, 4
    k2 = (2 * radius + 1) ** 2

    def inputs(b, h, w, dtype, spread, shift=0.0):
        f1, f2cat, coords = corr_inputs(gen, b, h, w, dtype, spread, shift,
                                        c, levels)
        g = torch.randn(b, h * w, levels * k2, generator=gen).cuda()
        return g.to(dtype), f1, f2cat, coords

    worst = 0.0
    # f32: the kernel sums df2cat with atomics, in an order that changes
    # from run to run, and the plain version with a matmul: 1e-4. bf16:
    # both round the same f32 sums once, so they may be one bf16 step
    # (2^-7 relative) apart.
    for dtype, rtol, atol in ((torch.float32, 0.0, 1e-4),
                              (torch.bfloat16, 2 ** -7, 1e-3)):
        for label, (b, h, w, spread, shift) in (
                (f"train {h8}x{w8} B={TRAIN_BATCH}",
                 (TRAIN_BATCH, h8, w8, 20.0, 0.0)),
                ("ragged N=63", (1, 7, 9, 6.0, 0.0)),
                ("far out of range", (1, h8, w8, 0.0, 1e4))):
            g, f1, f2cat, coords = inputs(b, h, w, dtype, spread, shift)
            got = fc.fused_corr_lookup_cat_bwd(g, f1, f2cat, coords, h, w,
                                               levels, radius)
            torch.cuda.synchronize()
            ref = fc.fused_corr_lookup_cat_bwd_plain(g, f1, f2cat, coords, h,
                                                     w, levels, radius)
            for name, x, r, like in zip(("df1", "df2cat"), got, ref,
                                        (f1, f2cat)):
                if x.shape != like.shape or x.dtype != like.dtype:
                    fail(f"lookup backward {label} {name}: {x.shape}/"
                         f"{x.dtype}, want {like.shape}/{like.dtype}")
                if shift:
                    if torch.count_nonzero(x):
                        fail(f"lookup backward: {name} of out-of-range "
                             "lookups is not all 0")
                    continue
                err = float((x.float() - r.float()).abs().max())
                check(f"{label} {dtype} {name} (|d| <= {atol:g} + "
                      f"{rtol:g}|ref|)", max_rel_excess(x, r, rtol, atol),
                      1.0)
                print(f"    max abs diff {err:.3e}", flush=True)
                if label.startswith("train") and dtype == torch.bfloat16:
                    worst = max(worst, err)
            if shift:
                print(f"  {label} {dtype}: df1 and df2cat exactly 0",
                      flush=True)

    # timing at the training shape and dtype (bf16, batch 8)
    g, f1, f2cat, coords = inputs(TRAIN_BATCH, h8, w8, torch.bfloat16, 20.0)
    meta = fc.cat_meta(h8, w8, levels)
    ms = cuda_ms(lambda: fc.fused_corr_lookup_cat_bwd(
        g, f1, f2cat, coords, h8, w8, levels, radius))
    plain_ms = cuda_ms(lambda: fc.fused_corr_lookup_cat_bwd_plain(
        g, f1, f2cat, coords, h8, w8, levels, radius), reps=5)
    n = TRAIN_BATCH * h8 * w8
    taps = valid_taps(coords, meta, radius)
    # what the function must move: g, f1, f2cat and coords read once, df1
    # and df2cat written once in their inputs' dtypes. The f32 scratch
    # that the atomics design sums into (and its zeroing and cast) is a
    # cost of this kernel, not of the function, and is reported apart.
    nbytes = (g.numel() + f1.numel() + f2cat.numel() + f1.numel()
              + f2cat.numel()) * g.element_size() + coords.numel() * 4
    scratch = f2cat.numel() * (4 - f2cat.element_size())
    ops = 4 * c * taps + 8 * n * levels * (2 * radius + 2) ** 2
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOP_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_FLOP_PER_S \
        else "operations"
    print(f"  bf16 [{TRAIN_BATCH},{h8 * w8},{c}] x R={f2cat.shape[1]}: kernel "
          f"{ms * 1e3:.1f} us (with the scratch's zeroing and cast), plain "
          f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP, "
          f"{taps} in-range taps); the f32 scratch adds "
          f"{scratch / 1e6:.2f} MB more than a {f2cat.dtype} df2cat",
          flush=True)
    return dict(name="fused_corr_lookup_bwd", route="cuda",
                source="opticalflowfromdepth_torch/csrc/fused_corr.cu",
                replaces="opticalflowfromdepth_tpu/ops/fused_corr.py:171",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def instance_norm_grad_phase(gen):
    import torch
    from opticalflowfromdepth_torch.ops import instance_norm as inorm

    print("[3d] instance norm gradient: Triton forward + closed form vs "
          "autograd through the plain version", flush=True)
    for shape in TRAIN_FNET_SHAPES:
        x32 = (torch.randn(*shape, generator=gen) * 3 + 0.5).cuda()
        g32 = torch.randn(*shape, generator=gen).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            for relu in (False, True):
                grads = []
                for fn in (inorm.instance_norm, inorm.instance_norm_plain):
                    x = x32.to(dtype).clone().requires_grad_()
                    fn(x, 1e-5, relu)[0].backward(g32.to(dtype))
                    grads.append(x.grad)
                torch.cuda.synchronize()
                if grads[0].dtype != dtype:
                    fail(f"instance norm grad dtype {grads[0].dtype}")
                # f32: the closed form and autograd through E[x^2]-E[x]^2
                # sum in other orders; bf16: each rounds once
                rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 \
                    else (2 ** -7, 1e-3)
                check(f"{list(shape)} {dtype} relu={relu} dx",
                      max_rel_excess(grads[0], grads[1], rtol, atol), 1.0)


# --------------------------------------------------------------------------
# phases 4 and 5: the serving model
# --------------------------------------------------------------------------

def e2e_parity_phase():
    import copy

    import numpy as np
    import torch
    from opticalflowfromdepth_torch.eval.infer import raft_infer_fn
    from opticalflowfromdepth_torch.models.raft import RAFT

    print("[4] RAFT-basic 128x256, 6 iters, f32: card vs CPU", flush=True)
    torch.set_num_threads(os.cpu_count() or 1)
    model = RAFT(corr_impl="fused",
                 generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    i1, i2 = (rng.uniform(0, 255, (1, 128, 256, 3)).astype(np.float32)
              for _ in range(2))
    cpu = raft_infer_fn(copy.deepcopy(model), iters=6, device="cpu")(i1, i2)
    gpu = raft_infer_fn(model, iters=6, device="cuda")(i1, i2)
    err = float(np.abs(gpu - cpu).max())
    print(f"  |flow| max {np.abs(cpu).max():.3f} px", flush=True)
    # f32 on both sides (TF32 off); cuDNN and the CPU sum in other orders
    check("flow_up card vs CPU (px)", err, 1e-2)


def main_path_phase():
    import numpy as np
    import torch
    from opticalflowfromdepth_torch.eval.infer import raft_infer_fn
    from opticalflowfromdepth_torch.eval.padder import InputPadder
    from opticalflowfromdepth_torch.models.raft import RAFT
    from opticalflowfromdepth_torch.ops.fused_corr import \
        fused_corr_lookup_cat
    from opticalflowfromdepth_torch.ops.instance_norm import instance_norm

    print("[5] main path: RAFT-basic bf16, fused corr, 24 iters, 3 pairs of "
          f"{SINTEL[0]}x{SINTEL[1]}", flush=True)
    iters = 24
    model = RAFT(corr_impl="fused", dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(0))
    infer = raft_infer_fn(model, iters=iters, device="cuda")
    rng = np.random.default_rng(0)
    pairs = [[rng.uniform(0, 255, (1,) + SINTEL + (3,)).astype(np.float32)
              for _ in range(2)] for _ in range(4)]
    padder = InputPadder(pairs[0][0].shape)

    def serve(i1, i2):
        a, b = padder.pad(i1, i2)
        return padder.unpad(infer(a, b))

    t = time.perf_counter()
    serve(*pairs[0])                                   # warm-up pair
    print(f"  warm-up pair {(time.perf_counter() - t) * 1e3:.1f} ms",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    fused_corr_lookup_cat.launches = 0
    fused_corr_lookup_cat.bwd_launches = 0
    instance_norm.launches = 0
    times = []
    for i1, i2 in pairs[1:]:
        t = time.perf_counter()
        flow = serve(i1, i2)
        times.append((time.perf_counter() - t) * 1e3)
        if flow.shape != (1,) + SINTEL + (2,) or not np.isfinite(flow).all():
            fail(f"main path flow {flow.shape}, finite="
                 f"{bool(np.isfinite(flow).all())}")
    launches = {"fused_corr_lookup": fused_corr_lookup_cat.launches,
                "fused_corr_lookup_bwd": fused_corr_lookup_cat.bwd_launches,
                "instance_norm": instance_norm.launches}
    n = len(times)
    print(f"  launches over {n} pairs: {launches}", flush=True)
    want = {"fused_corr_lookup": iters * n, "fused_corr_lookup_bwd": 0,
            "instance_norm": 15 * n}
    if launches != want:
        fail(f"serving launch counts {launches}, want {want}")
    print(f"  ms per pair: {[round(x, 3) for x in times]} (mean "
          f"{sum(times) / n:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    profile(lambda: serve(*pairs[1]), sum(times) / n, "pair")
    return launches


def profile(run, unprofiled_ms: float, what: str) -> None:
    """Device time by kernel over one more ``run()``, and the busy share of
    an unprofiled run's time (the profiler's own start-up inflates its
    wall clock, so that is not the denominator)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()

    def dev_us(e):      # the attribute's name changed across torch versions
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    # device-side events only: a CPU op's row repeats its kernels' time
    rows = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and dev_us(e) > 0), key=lambda e: -dev_us(e))
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    print(f"  profile of one {what}: device busy {busy_ms:.3f} ms against "
          f"{unprofiled_ms:.3f} ms per unprofiled {what} (busy "
          f"{100 * busy_ms / unprofiled_ms:.1f}%, idle "
          f"{100 - 100 * busy_ms / unprofiled_ms:.1f}%)", flush=True)
    for e in rows[:16]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}", flush=True)
    host = sorted((e for e in prof.key_averages()
                   if not str(getattr(e, "device_type", "")).endswith("CUDA")
                   and e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)
    print(f"  host time by op (self, profiled {what}):", flush=True)
    for e in host[:8]:
        print(f"    {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}", flush=True)


# --------------------------------------------------------------------------
# phases 6, 7 and 8: training
# --------------------------------------------------------------------------

def seeded_classifier(seed: int, dtype):
    """The frozen classifier: the reference's random init from ``seed``."""
    import math

    import torch
    from opticalflowfromdepth_torch.models.classifier import Classifier
    from opticalflowfromdepth_torch.models.layers import init_weights_
    gen = torch.Generator().manual_seed(seed)
    cls = Classifier(dtype=dtype)
    init_weights_(cls, gen)
    with torch.no_grad():
        lin = cls.classify[cls.linear_key]
        bound = 1.0 / math.sqrt(lin.in_features)
        lin.weight.uniform_(-bound, bound, generator=gen)
        lin.bias.uniform_(-bound, bound, generator=gen)
    return cls


def train_parity_phase():
    import copy

    import numpy as np
    import torch
    from opticalflowfromdepth_torch.data.loader import to_device
    from opticalflowfromdepth_torch.train import raft_train as rt

    print("[6] train step, RAFT-basic 64x96, batch 2, 2 iters, f32, "
          "classifier on: card vs CPU", flush=True)
    cfg = rt.RAFTTrainConfig(iters=2, batch_size=2, image_size=(64, 96),
                             mixed_precision=False, add_classifier=True,
                             num_steps=100)
    cls = seeded_classifier(6, torch.float32)
    rng = np.random.default_rng(7)
    batch = dict(
        image1=rng.uniform(0, 255, (2, 64, 96, 3)).astype(np.float32),
        image2=rng.uniform(0, 255, (2, 64, 96, 3)).astype(np.float32),
        flow=rng.normal(0, 3, (2, 64, 96, 2)).astype(np.float32),
        valid=np.ones((2, 64, 96), np.float32),
        label=np.eye(4, dtype=np.float32)[[0, 2]])
    out = {}
    for dev in ("cpu", "cuda"):
        state = rt.init_state(cfg, seed=8, device=dev)
        grads = {}
        adam_step = state.optimizer.step

        def step_keeping_grads(state=state, grads=grads, adam_step=adam_step):
            grads.update({n: p.grad.to("cpu", copy=True) for n, p
                          in state.model.named_parameters()})
            return adam_step()
        state.optimizer.step = step_keeping_grads
        step = rt.make_train_step(cfg, copy.deepcopy(cls), device=dev)
        state, m = step(state, to_device(batch, dev),
                        torch.Generator(device=dev).manual_seed(0))
        out[dev] = ({k: float(v) for k, v in m.items()}, grads,
                    {k: v.cpu() for k, v in state.model.state_dict().items()})
    (m_cpu, g_cpu, p_cpu), (m_card, g_card, p_card) = out["cpu"], out["cuda"]
    # metrics: f32 on both sides (TF32 off), cuDNN and the CPU sum in
    # other orders
    worst = max(abs(m_card[k] - v) / max(abs(v), 1e-6)
                for k, v in m_cpu.items())
    print(f"  total_loss CPU {m_cpu['total_loss']:.6f}, card "
          f"{m_card['total_loss']:.6f}", flush=True)
    check("loss and metrics, relative", worst, 1e-4)
    # the raw gradients, before the clip. This step amplifies f32 rounding
    # (the context encoder's training-mode BatchNorm over 2 samples): two
    # runs on the CPU alone differ by 4.4e-5 of the global norm in the
    # largest element and by 4.8e-4 of fnet's norm. So every gradient
    # within 2e-4 of the global norm, and fnet's, which reach it only
    # through the lookup's backward kernel and instance norm's backward,
    # within 1e-2 of their norm, which must not be 0 (a missing or zero
    # backward is 1).
    norm = float(torch.sqrt(sum((g ** 2).sum() for g in g_cpu.values())))
    rel = {}
    for part in ("fnet.", "cnet.", "update_block."):
        keys = [k for k in g_cpu if k.startswith(part)]
        n_part = float(torch.sqrt(sum((g_cpu[k] ** 2).sum() for k in keys)))
        e_part = float(torch.sqrt(sum(((g_card[k] - g_cpu[k]) ** 2).sum()
                                      for k in keys)))
        rel[part] = (n_part, e_part / max(n_part, 1e-30))
    print(f"  gradient global norm CPU {norm:.6f}, largest "
          f"{max(float(g.abs().max()) for g in g_cpu.values()):.6f}; "
          "norm and |card - CPU| / |CPU| by module: "
          + ", ".join(f"{k[:-1]} {n:.4e} {r:.3e}" for k, (n, r) in rel.items()),
          flush=True)
    if not rel["fnet."][0] > 0:
        fail("the feature encoder got no gradient on the CPU")
    check("every raw gradient, / global norm",
          max(float((g_card[k] - g).abs().max()) for k, g in g_cpu.items())
          / norm, 2e-4)
    check("fnet gradients, |card - CPU| / |CPU|", rel["fnet."][1], 1e-2)
    # one Adam step moves each parameter by about the learning rate (1e-5
    # at step 0), so this holds the update, not the gradient
    check("every parameter and statistic after the update",
          max(float((p_card[k].float() - v.float()).abs().max())
              for k, v in p_cpu.items()), 2e-4)


def write_shards(root: str, n: int, h: int, w: int, seed: int) -> None:
    """Seeded npz shards with the synthesis writer's keys and dtypes."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def img():
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)

    def depth():
        return rng.uniform(1.0, 90.0, (h, w)).astype(np.float16)

    def flow():
        return rng.normal(0.0, 4.0, (h, w, 2)).astype(np.float16)

    for i in range(n):
        np.savez_compressed(
            os.path.join(root, f"img{i}_g{i % 5}_a{i % 12}.npz"),
            img0_1=img(), depth0_1=depth(), img1_1=img(), depth1_1=depth(),
            flow_1=flow(), back_flow_1=flow(),
            img0_2=img(), depth0_2=depth(), img1_2=img(), depth1_2=depth(),
            flow_2=flow(), back_flow_2=flow(), label=np.int32(i % 8))


def train_path_phase(tmp: str):
    import math

    import numpy as np
    import torch
    from opticalflowfromdepth_torch.data.datasets import AugmentedShards
    from opticalflowfromdepth_torch.data.loader import Loader
    from opticalflowfromdepth_torch.eval.cli import load_state_dict
    from opticalflowfromdepth_torch.eval.infer import raft_infer_fn
    from opticalflowfromdepth_torch.models.raft import RAFT
    from opticalflowfromdepth_torch.ops.fused_corr import \
        fused_corr_lookup_cat
    from opticalflowfromdepth_torch.ops.instance_norm import instance_norm
    from opticalflowfromdepth_torch.train import raft_train as rt
    from opticalflowfromdepth_torch.train.runner import (RunnerConfig,
                                                          TrainRunner)
    from opticalflowfromdepth_torch.train.state import load_checkpoint

    b, (ch, cw), iters = TRAIN_BATCH, TRAIN_CROP, TRAIN_ITERS
    print(f"[7] training path: RAFT-basic bf16, fused corr, {iters} iters, "
          f"classifier on, batch {b} of {ch}x{cw} crops from 384x512 "
          "shards", flush=True)
    shards = os.path.join(tmp, "shards")
    os.makedirs(shards)
    t = time.perf_counter()
    write_shards(shards, 8, 384, 512, seed=3)
    print(f"  wrote 8 shards in {time.perf_counter() - t:.1f} s", flush=True)
    loader = Loader(AugmentedShards(shards, crop_size=TRAIN_CROP, seed=0),
                    batch_size=b, num_workers=4, seed=0)
    cfg = rt.RAFTTrainConfig(batch_size=b, image_size=TRAIN_CROP,
                             iters=iters, mixed_precision=True,
                             corr_impl="fused", add_classifier=True)
    step = rt.make_train_step(cfg, seeded_classifier(4, torch.bfloat16))
    losses, stamps = [], []

    def recorded_step(state, batch, gen):
        state, m = step(state, batch, gen)
        losses.append(float(m["total_loss"]))        # waits for the card
        stamps.append(time.perf_counter())
        return state, m

    rcfg = RunnerConfig(log_dir=os.path.join(tmp, "run"), num_steps=1,
                        val_freq=10 ** 9, save_ckpt_freq=8,
                        save_latest_freq=8)
    runner = TrainRunner(rcfg, rt.init_state(cfg, seed=0), recorded_step,
                         loader, seed=0)
    t = time.perf_counter()
    runner.run()                                        # warm-up step
    torch.cuda.synchronize()
    print(f"  warm-up step {(time.perf_counter() - t) * 1e3:.1f} ms",
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    fused_corr_lookup_cat.launches = 0
    fused_corr_lookup_cat.bwd_launches = 0
    instance_norm.launches = 0
    timed = 5
    rcfg.num_steps = 1 + timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run()
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = {"fused_corr_lookup": fused_corr_lookup_cat.launches,
                "fused_corr_lookup_bwd": fused_corr_lookup_cat.bwd_launches,
                "instance_norm": instance_norm.launches}
    print(f"  launches over {timed} steps: {launches}", flush=True)
    want = {"fused_corr_lookup": iters * timed,
            "fused_corr_lookup_bwd": iters * timed,
            "instance_norm": 15 * timed}
    if launches != want:
        fail(f"training launch counts {launches}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"training loss not finite: {losses}")
    per_step = [(y - x) * 1e3 for x, y in zip(stamps[-timed - 1:-1],
                                               stamps[-timed:])]
    step_ms = total_ms / timed
    print(f"  losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"  ms per step: {step_ms:.3f} over {timed} steps (host clock, "
          f"synchronized; steps 3-6 between loss reads: "
          f"{[round(x, 3) for x in per_step[1:]]}); "
          f"{b * 1e3 / step_ms:.3f} pairs/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)

    def one_more_step():
        rcfg.num_steps += 1
        runner.run()
    profile(one_more_step, step_ms, "step")

    # the input pipeline alone: batches from a fresh loader, no training
    it = iter(Loader(AugmentedShards(shards, crop_size=TRAIN_CROP, seed=1),
                     batch_size=b, num_workers=4, seed=1))
    next(it)
    t = time.perf_counter()
    for _ in range(4):
        next(it)
    print(f"  the loader alone (4 threads, batch {b}): "
          f"{(time.perf_counter() - t) * 1e3 / 4:.1f} ms per batch",
          flush=True)
    it.close()

    rcfg.num_steps = 8                                 # saves at step 8
    runner.run()
    ckpt = os.path.join(rcfg.log_dir, "checkpoints")
    resumed = load_checkpoint(os.path.join(ckpt, "latest.pth"),
                              rt.init_state(cfg, seed=1))
    if resumed.step != 8:
        fail(f"latest checkpoint holds step {resumed.step}, want 8")
    serve = RAFT(corr_impl="fused", dtype=torch.bfloat16)
    serve.load_state_dict(load_state_dict(
        os.path.join(ckpt, "step_8_weights.pth")), strict=True)
    rng = np.random.default_rng(9)
    pair = [rng.uniform(0, 255, (1, ch, cw, 3)).astype(np.float32)
            for _ in range(2)]
    flow = raft_infer_fn(serve, iters=24, device="cuda")(*pair)
    if flow.shape != (1, ch, cw, 2) or not np.isfinite(flow).all():
        fail(f"served flow from the trained weights {flow.shape}, finite="
             f"{bool(np.isfinite(flow).all())}")
    print(f"  latest (step 8) resumed; step_8_weights served one pair "
          f"through the serving model: |flow| max "
          f"{np.abs(flow).max():.3f} px", flush=True)
    runner.batches.close()             # stops the loader's thread
    return launches


def learning_phase():
    import numpy as np
    import torch
    import torch.nn.functional as F
    from opticalflowfromdepth_torch.data.loader import to_device
    from opticalflowfromdepth_torch.train import raft_train as rt

    b, (h, w), n = 4, (184, 248), 30
    print(f"[8] learning check: {n} steps on one fixed batch of {b} "
          f"{h}x{w} pairs (smooth images, image2 shifted by a known "
          "integer flow)", flush=True)
    rng = np.random.default_rng(11)
    big = F.interpolate(torch.from_numpy(
        rng.uniform(0, 255, (b, 3, 24, 32)).astype(np.float32)),
        size=(h + 16, w + 16), mode="bilinear", align_corners=False)
    shifts = rng.integers(-6, 7, (b, 2))
    img2 = torch.stack([big[i, :, 8 + dy:8 + dy + h, 8 + dx:8 + dx + w]
                        for i, (dx, dy) in enumerate(shifts)])
    flow = np.broadcast_to(-shifts[:, None, None, :].astype(np.float32),
                           (b, h, w, 2))
    batch = to_device(dict(
        image1=big[:, :, 8:8 + h, 8:8 + w].permute(0, 2, 3, 1).numpy(),
        image2=img2.permute(0, 2, 3, 1).numpy(), flow=flow,
        valid=np.ones((b, h, w), np.float32),
        label=np.eye(4, dtype=np.float32)[np.zeros(b, int)]), "cuda")
    # num_steps 30: the OneCycle warm-up ends at step floor(0.05 * 130) = 6
    cfg = rt.RAFTTrainConfig(batch_size=b, image_size=(h, w),
                             iters=TRAIN_ITERS, num_steps=n, lr=4e-4)
    state = rt.init_state(cfg, seed=2)
    step = rt.make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses = []
    for _ in range(n):
        state, m = step(state, batch, gen)
        losses.append(float(m["total_loss"]))
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"  losses {[round(x, 3) for x in losses]}", flush=True)
    print(f"  mean loss of steps 1-5 {first:.4f}, of steps {n - 4}-{n} "
          f"{last:.4f}", flush=True)
    if not last < first:
        fail(f"the loss did not fall: {first:.4f} -> {last:.4f}")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the card")
    sys.path.insert(0, HERE)
    try:
        from opticalflowfromdepth_torch import _build
    except ImportError as e:
        fail(f"the port package is not beside chip_smoke.py ({e})")

    t_all = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    logs = _build.build(["fused_corr"])
    print(f"[2] nvcc build {time.perf_counter() - t:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    import triton
    from opticalflowfromdepth_torch.ops.instance_norm import instance_norm
    t = time.perf_counter()
    instance_norm(torch.ones(1, 1, 4, 4, device="cuda"))
    torch.cuda.synchronize()
    print(f"  triton {triton.__version__} first launch "
          f"{time.perf_counter() - t:.1f} s", flush=True)

    gen = torch.Generator().manual_seed(0)
    kernels = [fused_corr_phase(gen), instance_norm_phase(gen),
               fused_corr_bwd_phase(gen)]
    instance_norm_grad_phase(gen)
    e2e_parity_phase()
    main_path_phase()
    train_parity_phase()
    with tempfile.TemporaryDirectory() as tmp:
        launches = train_path_phase(tmp)
    learning_phase()
    for k in kernels:          # launches on slice 2's main path, training
        k["launches"] = launches[k["name"]]
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"kernels": [{k: kern[k] for k in order}
                                  for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
