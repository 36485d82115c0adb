#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a host with one CUDA card. Phases:

1. card: its name and power limit (nvidia-smi); TF32 off for f32 phases;
2. build: the CUDA kernels from ``opticalflowfromdepth_torch/csrc`` (one
   nvcc per source, in parallel) and the first Triton launch;
3. each kernel against its plain PyTorch version on the card, at the
   shapes RAFT-basic gives it at Sintel size (440x1024 padded), with the
   tolerance stated, plus the edge cases; times with CUDA events;
4. end-to-end parity: RAFT-basic on one 128x256 pair, 6 iterations, f32,
   on the card (kernels) against the CPU (plain versions), same weights;
5. the main path: full-width RAFT-basic (bf16, fused correlation, 24
   iterations, seeded random weights) serving 3 pairs of 436x1024 through
   ``InputPadder`` and ``raft_infer_fn``, with the launch counts checked
   (24 lookups and 15 instance norms per pair) and a profile of one pair;
6. a ``{"kernels": [...]}`` line, the card line, and last the line
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
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16, data sheet
SINTEL = (436, 1024)


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


def fused_corr_phase(gen):
    import torch
    from opticalflowfromdepth_torch.ops import fused_corr as fc

    print("[3a] fused correlation lookup: CUDA kernel vs plain", flush=True)
    h8, w8 = (SINTEL[0] + 4) // 8, SINTEL[1] // 8      # 55 x 128
    c, levels, radius = 256, 4, 4
    dev = "cuda"

    def inputs(b, h, w, dtype, spread, shift=0.0):
        f1 = torch.randn(b, h, w, c, generator=gen).to(dev)
        f2 = torch.randn(b, h, w, c, generator=gen).to(dev)
        yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w),
                                indexing="ij")
        base = torch.stack([xx, yy], -1).float()[None].repeat(b, 1, 1, 1)
        coords = base + (torch.rand(b, h, w, 2, generator=gen) * 2 - 1) \
            * spread + shift
        f2cat = fc.corr_levels_cat(f2, levels, dtype)
        return (f1.to(dtype).reshape(b, h * w, c), f2cat,
                coords.reshape(b, h * w, 2).to(dev))

    worst = 0.0
    for dtype, rtol, atol in ((torch.float32, 0.0, 1e-4),
                              (torch.bfloat16, 2e-2, 2e-2)):
        for label, (b, h, w, spread, shift) in (
                ("main 55x128", (1, h8, w8, 20.0, 0.0)),
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
            if label.startswith("main"):
                worst = max(worst, err)

    # timing at the main-path shape and dtype (bf16, one pair)
    f1, f2cat, coords = inputs(1, h8, w8, torch.bfloat16, 20.0)
    meta = fc.cat_meta(h8, w8, levels)
    ms = cuda_ms(lambda: fc.fused_corr_lookup_cat(f1, f2cat, coords, h8, w8,
                                                  levels, radius))
    plain_ms = cuda_ms(lambda: fc.fused_corr_lookup_cat_plain(
        f1, f2cat, coords, h8, w8, levels, radius), reps=5)
    n = h8 * w8
    k2 = (2 * radius + 1) ** 2
    nbytes = (f1.numel() + f2cat.numel() + n * levels * k2) * 2 \
        + coords.numel() * 4
    ops = 2 * c * valid_taps(coords, meta, radius) + 10 * n * levels * k2
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOP_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_FLOP_PER_S \
        else "operations"
    print(f"  bf16 [1,{n},{c}] x R={f2cat.shape[1]}: kernel {ms * 1e3:.1f} us,"
          f" plain {plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)",
          flush=True)
    return dict(name="fused_corr_lookup", route="cuda",
                source="opticalflowfromdepth_torch/csrc/fused_corr.cu",
                replaces="opticalflowfromdepth_tpu/ops/fused_corr.py:140",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


FNET_SHAPES = ((2, 64, 220, 512), (2, 96, 110, 256), (2, 128, 55, 128))


def instance_norm_phase(gen):
    import torch
    import torch.nn.functional as F
    from opticalflowfromdepth_torch.ops import instance_norm as inorm

    print("[3b] instance norm: Triton kernel vs plain", flush=True)
    worst = 0.0
    for shape in FNET_SHAPES:
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
                if dtype == torch.bfloat16:
                    worst = max(worst, float((y.float() - yr.float())
                                             .abs().max()))

    # one fnet forward at Sintel size: each shape 5 times, bf16, relu
    ms = plain_ms = lib_ms = bound_ms = 0.0
    for shape in FNET_SHAPES:
        x = torch.randn(*shape, generator=gen).cuda().to(torch.bfloat16)
        k_ms = cuda_ms(lambda: inorm.instance_norm(x, 1e-5, True))
        p_ms = cuda_ms(lambda: inorm.instance_norm_plain(x, 1e-5, True))
        l_ms = cuda_ms(lambda: F.relu(F.instance_norm(x, eps=1e-5)))
        b_ms = 2 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
        print(f"  bf16 {list(shape)}: kernel {k_ms * 1e3:.1f} us, plain "
              f"{p_ms * 1e3:.1f} us, F.instance_norm+relu {l_ms * 1e3:.1f} "
              f"us, bound {b_ms * 1e3:.2f} us (bytes)", flush=True)
        ms += 5 * k_ms
        plain_ms += 5 * p_ms
        lib_ms += 5 * l_ms
        bound_ms += 5 * b_ms
    print(f"  15 calls of one fnet forward: kernel {ms * 1e3:.1f} us, "
          f"bound {bound_ms * 1e3:.1f} us", flush=True)
    return dict(name="instance_norm", route="triton",
                source="opticalflowfromdepth_torch/ops/instance_norm.py",
                replaces="opticalflowfromdepth_tpu/ops/instance_norm.py:44",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms)


# --------------------------------------------------------------------------
# phases 4 and 5: the model
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
                "instance_norm": instance_norm.launches}
    n = len(times)
    print(f"  launches over {n} pairs: {launches}", flush=True)
    if launches != {"fused_corr_lookup": iters * n, "instance_norm": 15 * n}:
        fail(f"launch counts {launches}, want {iters * n} and {15 * n}")
    print(f"  ms per pair: {[round(x, 3) for x in times]} (mean "
          f"{sum(times) / n:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    profile_pair(serve, pairs[1], sum(times) / n)
    return launches


def profile_pair(serve, pair, pair_ms: float) -> None:
    """Device time by kernel over one more pair, and the busy share of an
    unprofiled pair's time (the profiler's own start-up inflates its wall
    clock, so that is not the denominator)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(*pair)
        torch.cuda.synchronize()

    def dev_us(e):      # the attribute's name changed across torch versions
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    # device-side events only: a CPU op's row repeats its kernels' time
    rows = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and dev_us(e) > 0), key=lambda e: -dev_us(e))
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    print(f"  profile of one pair: device busy {busy_ms:.3f} ms against "
          f"{pair_ms:.3f} ms per unprofiled pair (busy "
          f"{100 * busy_ms / pair_ms:.1f}%, idle "
          f"{100 - 100 * busy_ms / pair_ms:.1f}%)", flush=True)
    for e in rows[:16]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}", flush=True)


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
    kernels = [fused_corr_phase(gen), instance_norm_phase(gen)]
    e2e_parity_phase()
    launches = main_path_phase()
    for k in kernels:
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
