#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a host with one CUDA card. Phases:

1. card: its name and power limit (nvidia-smi); TF32 off for f32 phases;
2. build: the host npz codec ``csrc/shardio.cc`` (g++, zlib), then the
   CUDA kernels from ``opticalflowfromdepth_torch/csrc`` (one nvcc per
   source, in parallel), with ptxas's registers and spills;
3. each kernel against its plain PyTorch version on the card, with the
   tolerance stated, plus the edge cases; times with CUDA events:
   [3a] the fused lookup and [3b] instance norm at the shapes RAFT-basic
   serving gives them at Sintel size (440x1024 padded) and its training
   (batch 8, 368x496), the lookup also at KITTI's 47x156 (376x1248
   padded), and on its tensor-core route (bf16, C = 256 or 128) smooth
   flow, a ragged tile edge, boxes that overflow (per-query path), levels
   pooled to nothing, each with its share of the per-query path, two
   launches bit-equal and a planted fault (a column of a tile's box left
   out), timed with smooth and with i.i.d. +- 20 px coordinates; the
   lookup also at RAFT-small's radius 3 and C = 128 (batch 4 of 12x16,
   the convergence tool's shape, and a ragged 11x19), bf16 on the
   tensor-core route and f32 on the CUDA-core route, each with two
   launches bit-equal and the planted fault;
   instance norm also at GMFlow's backbone shapes and every plan class
   (cluster of 1 and 8, several rows a block, a ragged last slice, rows
   streamed twice, f16, data off the 16-byte grid), two launches
   bit-equal, and RAFT-small's SmallEncoder maps (stacked batch of 4 of
   96x128); [3c] the lookup's
   backward at the training shape (batch 8, 368x496), ragged N (63, 65),
   levels pooled to nothing and far out-of-range queries, f32 (CUDA-core
   route) and bf16 (tensor-core route), with two launches that must give
   the same bits and two planted faults (df2cat x 0.98, the first query
   tile left out) that must fail the tolerance, and RAFT-small's radius-3
   cases on both routes with the same checks; [3d] instance norm's
   gradient at the training shapes (where the kernel's and the plain
   forward fall on opposite sides of the ReLU, |g| rstd allowed on top);
   [3e] the flash streaming-softmax kernel at
   GMFlow's Sintel shape classes (window attention [8, 1792, 128] with
   and without the Swin mask, global matching and global propagation
   [1, 7168, 128] with a 2-wide payload, the refinement's windows
   [128, 448, 128]) and at KITTI's (384x1248 padded: windows [8, 1872,
   128], shifted 12 and 39, matching and propagation [1, 7488, 128]),
   ragged lengths, extreme logits, the wgmma route's edges (a 64-row tile
   + 1 and - 1, D = 128 and 2, a Swin region edge inside a key tile),
   bf16 and f32 operands and the LSE (f32 at C = 128 on the tf32x3
   route: split-TF32 products, the key sweep split at B = 1 and 2 in the
   cases B = 1, L = 2000, D = 2 and L = 1001, D = 128, whose merge
   leaving the last run out is a third planted fault that must fail; what
   hi-only TF32 products would give, for information), two launches that
   must give the same bits, each case's route, rows a block, blocks,
   waves and split printed, timed at the serving and the training shape
   classes against its bound (TFLOP/s, share of the bound), the plain
   version (serving) and ``F.scaled_dot_product_attention``, in bf16 and
   in f32 (the serving classes, the 14 calls of an f32 pair and the
   training matching class, beside the CUDA-core route the f32 calls took
   before, with bounds at the split-TF32 and the f32 peaks); [3f] the two
   flash backward
   kernels (dq; dk and dv) at GMFlow's training shape classes (batch 16
   of 368x560: windows [128, 805, 128] with and without the Swin mask,
   matching and propagation [16, 3220, 128] with a 2-wide payload),
   ragged lengths (a row over and a row short of the wgmma route's 64-row
   tiles), a Swin region edge inside a tile, extreme logits, split sweeps
   (B = 1, L = 2000 at D = 2; L = 1001 at D = 128), bf16 and f32, every
   route (wgmma and, in f32, tf32x3 at C = 128; mma.sync and the f32
   CUDA-core route at C = 64 and 32), with two planted faults that must
   fail the tolerance (three where the tf32x3 route splits a sweep: its
   reduction leaving the last partial out), what hi-only TF32 products
   would give (for information), and two launches that must give the same
   bits, the C = 128 and 256 bf16 wgmma routes' bits (the forward's out
   and LSE, the backward's gradients) against recorded digests
   (``C128_DIGESTS``, ``C256_DIGESTS``, by nvcc release), the autograd
   Function against a dense softmax, timed in bf16 and
   in f32 (the 14 + 14 launches of a training step each) against their
   bounds (TFLOP/s, share of the bound; f32 at the split-TF32 and at the
   CUDA cores' f32 peak), the plain version and SDPA's backward; [3g]
   (run after [12]) the 3x3 conv at
   RAFT-basic's stride-1 shapes at Sintel serving, the ragged [1, 33, 17,
   8] -> 8 and GMFlow's training
   [32, 184, 280, 64] -> 64, bf16 and f32, each shape's route and plan
   (``ops/conv2d.py:plan``; every bf16 shape must take the wgmma route)
   and ptxas's registers and spills for the wgmma kernel, two launches
   that must give the same bits, planted faults (the (2, 2) tap left
   out, the last halo row of each band zero, each band's top-left halo
   pixel read wrong, and where a shape has two CO tiles or more the last
   tap's weights of the second one channel off) that must fail the
   tolerance, the autograd Function against autograd through
   ``F.conv2d`` and the plain version, device times (one CUDA graph)
   beside a call launched from the host, against its bound, the plain
   version and ``F.conv2d`` (cuDNN), the ``mma.sync`` route at
   GMFlow's and fnet's first layers, and the backward's dx launch at
   GMFlow's against cuDNN's input gradient;
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
   instance norms per step) and a ``utils.profiling.StepTimer`` around
   them, a profile of one step, then the ``latest`` and weights
   checkpoints, the weights served by the serving model, and a
   ``utils.profiling.trace`` of one more step (read in [19]);
8. a learning check: 30 steps on one fixed batch at 184x248, batch 4;
   the loss must fall;
9. GMFlow card vs CPU: 1-scale and refine, f32, 64x96, seeded weights;
10. GMFlow serving: full width (bf16, seeded weights) through
   ``InputPadder(padding_factor=16)`` and ``gmflow_infer_fn``, 3 pairs of
   436x1024 after a warm-up pair, with the launch counts checked (14
   flash, 15 instance norms, 0 lookups per pair) and a profile of one
   pair; one bidirectional pair with the occlusion check (15 flash); one
   refine pair (padding factor 32, 26 flash);
11. GMFlow train-step parity: one f32 step with the classifier, 64x96,
   batch 2, 1 scale and refine, on the card against the CPU;
12. the GMFlow training path: seeded npz shards at 384x576 ->
   ``AugmentedShards`` (crop 368x560) -> ``Loader`` (batch 16) ->
   ``TrainRunner`` over ``gmflow_train.make_train_step`` (full width,
   bf16, 1 scale, frozen classifier): one warm-up step, 5 timed steps
   with the launch counts checked (14 flash forwards, 14 dq, 14 dk/dv, 15
   instance norms, 0 lookups per step), a profile of one step, the
   ``latest`` and weights checkpoints served by ``gmflow_infer_fn``, a
   batch with a NaN skipped, and 30 steps on one fixed batch that must
   lower the loss;
13. evaluation through ``eval.cli.main``, on seeded Sintel (436x1024)
   and KITTI (375x1242) trees written by the port's own writers: RAFT-basic
   ``--val sintel kitti --evaluate_matched_unmatched --with_speed_metric
   --count_time``, ``--submission sintel --warm_start`` and ``--submission
   kitti``; GMFlow ``--padding_factor 16 --val sintel kitti --count_time``
   and ``--submission kitti`` (full width, bf16, seeded weights saved as a
   ``.pth``). Checked: (a) the metrics against a numpy recomputation from
   the flows a recording infer function returned; (b) the padded ground
   truth as the flow scores EPE 0 and Fl-all 0; (c) exact launch counts
   per pass (RAFT 24 lookups and 15 instance norms, GMFlow 14 flash and 15
   instance norms, 0 conv); (d) the submission files, their unpadded
   shapes and flows, and the warm start's ``flow_init``;
3h. (after [13]) the forward warp (``csrc/forward_warp.cu``) against its
   plain version, bit for bit (out, valid and collision) at B = 1 and 15,
   C = 7, 6, 4 and 2, at 384x512 and 33x17, with zero flow, an integer
   translation (a permutation), i.i.d. +-20 px, a rotation about a pivot
   off the image (border clamping), every pixel onto 4 targets, constant
   depth (raster-order ties) and depths >= 1000 (collisions); ptxas's
   registers and spills of the kernel; two launches bit-equal, and two
   launches back to back on other
   inputs each bit-equal; two planted faults that must fail (the
   tie-break reversed; each group of equal targets keeping its largest
   key); device times (one CUDA graph) beside a call from the host at
   [15, 6, 384, 512] and [1, 6, 384, 512], against the bound (and each
   case's share of it), the plain version and its
   z-buffer pass alone (``scatter_reduce`` amin);
14. synthesis card vs CPU: ``synthesize_sample_packed`` at 96x128 (depth
   and disparity), same image, depth and draws, 20 warp launches an
   image; at most 0.5% of the pixels beyond 1 gray level / one f16 step;
15. the synthesis path: ``synth.cli.main`` at 384x512, 1 epoch, on a fake
   ReDWeb tree (4 procedural 480x640 JPEGs with 8-bit closeness PNGs) and
   a DIML tree (one PNG pair with a 16-bit disparity), written by the
   default (native) writer; checked: 20 warp
   launches an image and no other kernel, ``forward_warp_plain`` never
   called, the writer's blobs fewer than its entries; the same 5 images
   through ``ShardWriter(use_native=False)``, every file of the two trees
   holding equal arrays, images/s, write s and wait s for both; 61 files
   an image, each file's keys, dtypes and shapes, labels
   that follow ``AUGMENT_SCHEDULE``, finite flows; images per second and
   ms per image (synthesis by CUDA events, device->host, write), one
   image's synthesis alone and its profile, that image's 20 warps
   recorded and replayed one by one (device time summed, beside the
   bound); then the shards (one
   directory per dataset, kept for [16]) through ``AugmentedShards``
   (crop 368x496) and ``Loader`` into 3 RAFT-basic training steps (bf16,
   fused correlation) with a finite loss;
16. the training CLI: ``train.cli.main`` at its defaults (RAFT-basic,
   batch 8 of 368x496, 12 iterations, bf16) on [15]'s ReDWeb and DIML
   shards, ``--stage mixed`` (re-augmented), ``--add_classifier
   --classifier_ckpt`` a seeded classifier saved as a ``.pth``: a warm-up
   step, then 5 steps with exact launch counts (12 lookups, 12 lookup
   backwards, 15 instance norms a step) and no plain version called; ms a
   step, the step alone on a resident batch, the loader alone (ms a
   batch); ``latest``, the weights, ``args.json`` and the ``_parameters``
   sidecar; ``--resume`` for 2 more steps, the step's weights served by
   ``raft_infer_fn``; then ``--model gmflow`` (full width, batch 16 of
   368x560), 2 steps with 14 + 14 + 14 flash launches and 15 instance
   norms a step;
3i. (after [16]) the sequence-parallel ring (``parallel.sequence``) on
   the card: ``ring_softmax_matmul`` over ``LocalRing(n)``, n = 1, 2 and
   4, f32 (the flash kernels' f32 routes), at GMFlow's serving matching
   shape [1, 7168, 128] x [1, 7168, 2], its training one [16, 3220, 128] x
   [16, 3220, 2] and a ragged L = 1001 (D = 2 and 128): forward and
   backward against the same ring with the plain versions and against
   one unsharded f32 flash call and its gradients (1e-4 of max|v| for the
   output, of max|ref| for each gradient), exact launch counts (n^2
   forward, n^2 dq, n^2 dk/dv), two rings bit-equal, a planted fault (a
   merge without a step's LSE correction) that must fail; times of the
   ring and of the f32 kernels at one step's shape against their bounds
   (at the split-TF32 and at the f32 CUDA-core peak), each kernel before
   (the CUDA-core route) in the same run, the plain ring, and SDPA in f32
   (forward, forward + backward, the backward alone);
17. data parallelism over NCCL at world size 1: ``init_distributed()``
   from an environment set in-process, ``make_mesh()``, two RAFT-basic
   steps at [7]'s shape (batch norm live, ``add_noise``) and two GMFlow
   steps at [12]'s, whose parameters must equal bit for bit those of the
   same steps with no process group (cuDNN deterministic); then the group
   is destroyed;
18. sequence-parallel GMFlow, ``model_parallel = 2`` over
   ``ProcessMesh.local(2)``: at f32 64x96 the forward at splits 1 and 2
   against the unsharded model (JAX's 5e-3 px + 1e-3 relative) and one
   step's raw gradients ([11]'s 2e-4 of the global norm); then the
   reference's recipe at full width (bf16, batch 16 of 368x560, 1 scale,
   classifier on): a warm-up step and 3 timed steps on a resident batch
   with exact launch counts (32 flash forwards, 32 dq, 32 dk/dv, 15
   instance norms a step), no plain version called, host ms beside [12]'s
   step alone, peak memory, a profile of one step with the f32 forward's
   device time and share (its tf32x3 kernel and merge);
19. the host's data plane and the last modules: g++'s and the codec's
   zlib versions and its build time; [12]'s loader alone (batch 16, 4
   threads) through the codec and through ``np.load`` on [12]'s shards,
   in turns, beside [16]'s ms per step; ``sparse_bilateral_filtering`` at
   480x640 on the card against the CPU (equal at every pixel), with ms;
   [7]'s ``StepTimer`` against its own host clock (within 5%) and its
   trace of one step (one non-empty Chrome trace with the card's kernels
   and the annotation);
3j. (after [19]) the flash kernels' dense bias and widths: the
   reference's Swin mask as a dense bias (``shift_window_attn_mask``
   tiled) at the serving windows [8, 1792, 128] and the training windows
   [128, 805, 128], bf16 and f32, against the plain version and the
   in-kernel ``swin=`` call; a random-normal and a -100 block bias at the
   matching shapes [1, 7168, 128] x D = 2 (f32: the key sweep split) and
   [16, 3220, 128] x D = 2; every route (wgmma at C = 128 and 256,
   mma.sync at C = 64 and forced at 256, tf32x3 split and unsplit, the
   CUDA cores) with rows the bias
   masks whole (-1e30: the mean of v over the real keys), Lk ragged and a
   multiple of the key tile, bias with ``swin``; two launches bit-equal;
   planted faults that must fail (the bias's last key column dropped, and
   on the base-2 routes the bias unscaled by log2(e)); the Function with
   a bias (its dense backward) card against CPU; widths C in {1, 8, 24,
   100, 200, 256} x D in {1, 3, 24, 130, 256}, bf16 and f32, forward and
   backward against the plain versions, two launches bit-equal; the C
   side's plans (``kernel_plan``) at every padded width, each block
   within an SM; C = 257 and D = 257 (f32) each launching the forward,
   dq and dk/dv within tolerance; a bias of the wrong shape raises;
   times with a bias at GMFlow's four shape classes (bf16) against the
   bound (the bias's bytes) and SDPA with the bias as ``attn_mask``; then
   GMFlow at 256 channels' flash calls (C = 256, the windows' D = 256) at
   the serving and the training shapes ([21]'s and [22]'s), bf16: the
   forward at each class (the wgmma route) and the backward at each
   training class against the plain versions as [3e] and [3f] hold the
   128-channel classes (two launches bit-equal, the planted faults, and
   q and k's upper 128 columns zeroed, which must fail forward and
   backward; then both at the edges: ragged 65, 129 and 200 rows, D =
   256 and 2, a Swin edge inside a tile; the largest errors join the
   flash rows' ``max_abs_err``), then timed against their bounds, the
   plain versions and SDPA, each beside the mma.sync route forced on the
   same inputs (it must lose at every class);
20. GMFlow at ``feature_channels = 256``, f32 64x96, 1 scale: card vs CPU
   ([9]'s 1-scale limits), 14 flash and 15 instance-norm launches;
21. GMFlow at 256 channels serving: bf16, 3 pairs of 436x1024 after a
   warm-up, 14 flash + 15 instance norms a pair, every flash forward on
   the wgmma route, no plain version called, ms a pair, peak memory, a
   profile of one pair (device busy ms; the forward's wgmma and mma.sync
   kernels' ms);
22. GMFlow at 256 channels training: the reference's recipe (bf16, batch
   16 of 368x560, 1 scale, classifier on) on a resident batch, a warm-up
   step and 2 steps with 14 + 14 + 14 flash launches and 15 instance
   norms a step, every flash forward on the wgmma route, no plain version
   called, finite losses, ms a step, peak memory, a profile of one more
   step (device busy ms; the flash forward's and backward's device ms,
   dq's and dk/dv's apart, the forward's wgmma and mma.sync kernels');
3k. (after [22]) the flash kernels past 256: the mma.sync route (bf16)
   and the CUDA-core route (f32), whose blocks stage C in 128-column
   panels (Q's, or the backward's resident side's, rows whole where they
   fit a block) and take D (dq: C; dk/dv: C and D) in 128-column chunks
   on a grid axis: C in {264, 384, 512, 1000} x D in {2, 3, 384, 512,
   600} and C = 2000 with D = 2 and 600 (Q's rows a panel at a time),
   both dtypes, forward and backward against the plain versions, two
   launches bit-equal, each call's C-side plan (the route, its shared
   memory the Python mirror's plus the static, no local memory); the
   Swin mask at C = D = 512 and C = 1000, D = 600 with [3e]'s and [3f]'s
   planted faults, and in bf16 q's columns past 256 zeroed and v's
   columns past 256 zeroed, which must fail; a dense bias on both routes
   (ragged Lk, rows masked whole, its planted faults; with the Swin mask
   once); the C side's plans from C = 272 to 1024 in steps of 48, each
   block within an SM; then GMFlow at 512 channels' flash calls (C =
   512, the windows' D = 512) timed at the serving and the training
   shapes ([24]'s and [25]'s) against their bounds, the plain versions
   and SDPA (the backend it ran named, forward and backward);
23. GMFlow at ``feature_channels = 512``, f32 64x96, 1 scale: card vs CPU
   ([9]'s 1-scale limits), 14 flash and 15 instance-norm launches;
24. GMFlow at 512 channels serving, as [21], every flash forward on the
   mma.sync route;
25. GMFlow at 512 channels training, as [22], every flash forward on the
   mma.sync route;
26. a ``{"kernels": [...]}`` line (eight kernels; the flash rows count
   [18]'s, [21]'s, [22]'s, [24]'s and [25]'s launches too; the flash row
   also carries the f32 route's times at an f32 pair, ``f32_ms`` and the
   rest, and the dense bias's at GMFlow's four classes, ``bias_ms`` and
   the rest, and the 256-channel pair's 14 calls, ``c256_ms`` and the
   rest with ``c256_mma_sync_ms`` (the step's 14 as ``c256_step_*``), and
   the 512-channel pair's, ``c512_ms`` and the rest (the step's 14 as
   ``c512_step_*``); the backward's rows the 256-channel step's,
   ``c256_ms`` and the rest with ``c256_mma_sync_ms``, and the
   512-channel step's, ``c512_ms`` and the rest), the card line, and
   last the line ``{"ok": true, "device": {...}}``.

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
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16, data sheet
# exponentials: 16 special-function results per clock per SM (Hopper
# white paper), 132 SMs, 1.98 GHz boost clock (H100 SXM data sheet)
SFU_PER_S = 16 * 132 * 1.98e9
TF32_FLOP_PER_S = 495e12           # H100 SXM dense TF32, data sheet
# f32 on the CUDA cores (no tensor cores): the data sheet's 67 TFLOP/s, the
# peak of the flash kernels' CUDA-core f32 routes; and f32 products in
# split TF32 (the tf32x3 route), three TF32 products for each
FP32_FLOP_PER_S = 67e12
TF32X3_FLOP_PER_S = TF32_FLOP_PER_S / 3
SINTEL = (436, 1024)
TRAIN_CROP, TRAIN_BATCH, TRAIN_ITERS = (368, 496), 8, 12
# GMFlow's training recipe (`adjusted_gmflow/main.py`): batch 16 of
# 368x560 crops, so 46x70 tokens at 1/8 and Swin windows of 23x35
GM_CROP, GM_BATCH = (368, 560), 16


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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of ``fn`` per call, without the host's launch time:
    ``reps`` calls captured in one CUDA graph (after three warm-up calls),
    the mean of three replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def check(name: str, err: float, tol: float) -> None:
    print(f"  {name}: max diff {err:.3e} (tolerance {tol:g})", flush=True)
    if not err <= tol:
        fail(f"{name}: max diff {err:.3e} > {tol:g}")


def bound_ms(ops: float, exps: float, nbytes: float, flop_per_s: float):
    """The least time, in ms, this card could take for a kernel's work,
    and what sets it: ``ops`` operations at ``flop_per_s`` or ``exps``
    exponentials at the special-function units' rate ("operations"),
    against ``nbytes`` at the memory's rate ("bytes")."""
    t_ops = max(ops / flop_per_s, exps / SFU_PER_S)
    t_by = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_by) * 1e3, ("operations" if t_ops >= t_by
                                    else "bytes")


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

    # the KITTI case draws from a generator of its own, so the inputs of
    # every later phase stay as they were before it was added
    kitti_gen = torch.Generator().manual_seed(47)

    def inputs(b, h, w, dtype, spread, shift=0.0, g=gen):
        return corr_inputs(g, b, h, w, dtype, spread, shift, c, levels)

    worst = 0.0
    for dtype, rtol, atol in ((torch.float32, 0.0, 1e-4),
                              (torch.bfloat16, 2e-2, 2e-2)):
        for label, (b, h, w, spread, shift) in (
                ("serving 55x128", (1, h8, w8, 20.0, 0.0)),
                (f"train {TRAIN_CROP[0] // 8}x{TRAIN_CROP[1] // 8} "
                 f"B={TRAIN_BATCH}", (TRAIN_BATCH, TRAIN_CROP[0] // 8,
                                      TRAIN_CROP[1] // 8, 20.0, 0.0)),
                # KITTI serving: 375x1242 padded to 376x1248
                ("kitti 47x156", (1, 47, 156, 20.0, 0.0)),
                ("ragged N=63", (2, 7, 9, 6.0, 0.0)),
                ("far out of range", (1, h8, w8, 0.0, 1e4))):
            f1, f2cat, coords = inputs(
                b, h, w, dtype, spread, shift,
                kitti_gen if label.startswith("kitti") else gen)
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
    fused_corr_tile_cases(h8, w8)
    small_lookup_cases()
    return dict(name="fused_corr_lookup", route="cuda",
                source="opticalflowfromdepth_torch/csrc/fused_corr.cu",
                replaces="opticalflowfromdepth_tpu/ops/fused_corr.py:140",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def smooth_corr_inputs(gen, b, h, w, dtype, c=256, levels=4, amp=20.0):
    """As :func:`corr_inputs`, with coordinates the identity grid plus a
    smooth flow: a seeded coarse 3x4 field of +- amp px upsampled
    bilinearly, with one discontinuity (the columns right of 0.55 w moved
    10 px further in x)."""
    import torch
    import torch.nn.functional as F
    f1, f2cat, coords = corr_inputs(gen, b, h, w, dtype, 0.0, c=c,
                                    levels=levels)
    coarse = (torch.rand(b, 2, 3, 4, generator=gen) * 2 - 1) * amp
    flow = F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=True)
    flow[:, 0, :, int(0.55 * w):] += 10.0
    return f1, f2cat, coords + flow.permute(0, 2, 3, 1).reshape(
        b, h * w, 2).cuda()


def box_reads(plans, c: int):
    """What the tensor-core route reads by TMA for these plans: chunks a
    tile (over the levels) and MB of rows (every box column in rows of
    hb rounded up to 8, as the kernel's boxes)."""
    chunks = rows = 0
    for p in plans:
        if p is not None:
            hb8 = (p["hb"] + 7) // 8 * 8
            cpc = 64 // hb8.clamp(min=1)
            chunks += int(((p["bw"] + cpc - 1) // cpc)[hb8 > 0].sum())
            rows += int((p["bw"] * hb8).sum())
    return chunks / plans[0]["hb"].numel(), rows * c * 2 / 1e6


def slow_share(fc, f1, f2cat, coords, h, w, levels=4, radius=4):
    """One launch; the share of (query, level) pairs that took the
    per-query path, checked against ``tile_plan``'s count."""
    out, n_slow = fc.fused_corr_lookup_cat_slow_count(f1, f2cat, coords, h,
                                                      w, levels, radius)
    planned = sum(int(p["slow"].sum()) for p in
                  fc.tile_plan(coords, h, w, levels, radius) if p)
    if fc.route(f1.dtype, f1.shape[2]) == "tensor_cores" \
            and n_slow != planned:
        fail(f"lookup: the kernel sent {n_slow} (query, level) pairs down "
             f"the per-query path, tile_plan {planned}")
    return out, n_slow / (f1.shape[0] * f1.shape[1] * levels)


def fused_corr_tile_cases(h8, w8):
    """The tensor-core route's own cases, drawn from a generator of their
    own (the inputs of every later phase stay as they were): smooth flow
    at the serving and training shapes, a ragged tile edge, boxes that
    overflow (+- 40 px i.i.d.), levels pooled to nothing, C = 128; each
    with the share of (query, level) pairs on the per-query path. Then
    two launches bit-equal, a planted fault (one column of a tile's box
    left out) that must fail the tolerance, and the times of the smooth
    case beside today's i.i.d. +- 20 px one."""
    import torch
    from opticalflowfromdepth_torch.ops import fused_corr as fc
    levels, radius = 4, 4
    rtol, atol = 2e-2, 2e-2                 # [3a]'s bf16 tolerance
    tgen = torch.Generator().manual_seed(88)
    th, tw = TRAIN_CROP[0] // 8, TRAIN_CROP[1] // 8
    kept = {}
    for label, (b, h, w, kind, c) in (
            ("smooth serving 55x128", (1, h8, w8, "smooth", 256)),
            (f"smooth train {th}x{tw} B={TRAIN_BATCH}",
             (TRAIN_BATCH, th, tw, "smooth", 256)),
            ("ragged tile edge 13x21", (2, 13, 21, "smooth", 256)),
            ("box overflow +-40 px", (1, h8, w8, 40.0, 256)),
            ("levels pooled to nothing 5x6", (2, 5, 6, 3.0, 256)),
            ("C=128 smooth 46x62", (2, th, tw, "smooth", 128))):
        if kind == "smooth":
            f1, f2cat, coords = smooth_corr_inputs(tgen, b, h, w,
                                                   torch.bfloat16, c)
        else:
            f1, f2cat, coords = corr_inputs(tgen, b, h, w, torch.bfloat16,
                                            kind, c=c)
        got, share = slow_share(fc, f1, f2cat, coords, h, w)
        torch.cuda.synchronize()
        ref = fc.fused_corr_lookup_cat_plain(f1, f2cat, coords, h, w,
                                             levels, radius)
        check(f"{label} bf16 C={c} (|d| <= {atol:g} + {rtol:g}|ref|; "
              f"per-query path {share:.4f} of (query, level) pairs)",
              max_rel_excess(got, ref, rtol, atol), 1.0)
        kept[label] = (f1, f2cat, coords, h, w, got, ref)

    f1, f2cat, coords, h, w, got, ref = kept[
        f"smooth train {th}x{tw} B={TRAIN_BATCH}"]
    again = fc.fused_corr_lookup_cat(f1, f2cat, coords, h, w, levels, radius)
    if not torch.equal(got, again):
        fail("lookup: two launches on the same inputs differ")
    # the planted fault: the middle column of batch entry 0's first tile's
    # level-0 box left out (its rows zeroed), read at that tile's queries
    plan = fc.tile_plan(coords, h, w, levels, radius)[0]
    hl, wl, hp, off = fc.cat_meta(h, w, levels)[0]
    col = int(plan["x0"][0, 0]) + int(plan["bw"][0, 0]) // 2
    cut = f2cat.clone()
    cut[0, off + col * hp: off + (col + 1) * hp] = 0
    q = fc.query_tiles(h * w, w)[0]
    q = q[q >= 0].cuda()
    k2 = (2 * radius + 1) ** 2
    faulty = fc.fused_corr_lookup_cat(f1, cut, coords, h, w, levels,
                                      radius)[0, q, :k2]
    fault = max_rel_excess(faulty, ref[0, q, :k2], rtol, atol)
    print(f"  two launches bit-equal; planted fault (column {col} of a "
          f"tile's level-0 box left out), |d| / tolerance (must exceed 1): "
          f"{fault:.2f}", flush=True)
    if not fault > 1.0:
        fail(f"lookup: the planted fault passes the tolerance ({fault:.2f})")

    for what, b, h, w in (("serving", 1, h8, w8),
                          ("training", TRAIN_BATCH, th, tw)):
        for kind in ("smooth", "i.i.d. +-20 px"):
            if kind == "smooth":
                inp = smooth_corr_inputs(tgen, b, h, w, torch.bfloat16)
            else:
                inp = corr_inputs(tgen, b, h, w, torch.bfloat16, 20.0)
            _, share = slow_share(fc, *inp, h, w)
            chunks, mb = box_reads(fc.tile_plan(inp[2], h, w), 256)
            print(f"  {what} {kind}: per-query path {share:.4f} of (query, "
                  f"level) pairs; the boxes {chunks:.1f} chunks of 64 rows "
                  f"a tile, {mb:.1f} MB of rows read", flush=True)
            fused_corr_timing(None, b, h, w, f"{what} {kind}", inp)


# RAFT-small's lookup (`models/raft.py`: corr_radius 3, fnet of 128
# channels) at the convergence check's shape: batch 4 of 96x128 crops, so
# 12x16 at 1/8; and a ragged N
SMALL_LOOKUPS = (("RAFT-small 12x16 B=4", (4, 12, 16)),
                 ("RAFT-small ragged 11x19 B=3", (3, 11, 19)))


def small_lookup_inputs(gen, b, h, w, dtype, kind):
    if kind == "smooth":
        return smooth_corr_inputs(gen, b, h, w, dtype, c=128, amp=8.0)
    return corr_inputs(gen, b, h, w, dtype, 6.0, c=128)


def small_lookup_cases():
    """[3a] at radius 3, C = 128, 4 levels (drawn from a generator of their
    own): bf16 on the tensor-core route and f32 on the CUDA-core route,
    smooth and i.i.d. +- 6 px coordinates, each within [3a]'s tolerance of
    its dtype, two launches bit-equal, the planted fault (a column of a
    tile's level-0 box left out) failing it."""
    import torch
    from opticalflowfromdepth_torch.ops import fused_corr as fc
    levels, radius = 4, 3
    k2 = (2 * radius + 1) ** 2
    sgen = torch.Generator().manual_seed(303)
    for dtype, rtol, atol in ((torch.bfloat16, 2e-2, 2e-2),
                              (torch.float32, 0.0, 1e-4)):
        for label, (b, h, w) in SMALL_LOOKUPS:
            for kind in ("smooth", "i.i.d. +-6 px"):
                f1, f2cat, coords = small_lookup_inputs(sgen, b, h, w, dtype,
                                                        kind)
                got, share = slow_share(fc, f1, f2cat, coords, h, w, levels,
                                        radius)
                again = fc.fused_corr_lookup_cat(f1, f2cat, coords, h, w,
                                                 levels, radius)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail(f"lookup r=3 {label}: two launches differ")
                ref = fc.fused_corr_lookup_cat_plain(f1, f2cat, coords, h, w,
                                                     levels, radius)
                if got.shape != ref.shape or got.shape[2] != levels * k2:
                    fail(f"lookup r=3 {label}: {got.shape} vs {ref.shape}")
                check(f"{label} r=3 C=128 {kind} {dtype} "
                      f"({fc.route(dtype, 128)}; |d| <= {atol:g} + "
                      f"{rtol:g}|ref|; per-query path {share:.4f})",
                      max_rel_excess(got, ref, rtol, atol), 1.0)
                plan = fc.tile_plan(coords, h, w, levels, radius)[0]
                hl, wl, hp, off = fc.cat_meta(h, w, levels)[0]
                col = int(plan["x0"][0, 0]) + int(plan["bw"][0, 0]) // 2
                cut = f2cat.clone()
                cut[0, off + col * hp: off + (col + 1) * hp] = 0
                q = fc.query_tiles(h * w, w)[0]
                q = q[q >= 0].cuda()
                faulty = fc.fused_corr_lookup_cat(
                    f1, cut, coords, h, w, levels, radius)[0, q, :k2]
                fault = max_rel_excess(faulty, ref[0, q, :k2], rtol, atol)
                print(f"    two launches bit-equal; planted fault (column "
                      f"{col} of a tile's level-0 box left out) {fault:.2f} "
                      "(must exceed 1)", flush=True)
                if not fault > 1.0:
                    fail(f"lookup r=3 {label}: the planted fault passes "
                         f"({fault:.2f})")


def fused_corr_timing(gen, b, h8, w8, what, inputs=None):
    """Kernel, plain and bound times of one bf16 lookup at ``[b, h8*w8]``
    (i.i.d. +- 20 px coordinates from ``gen`` unless ``inputs`` given)."""
    import torch
    from opticalflowfromdepth_torch.ops import fused_corr as fc
    c, levels, radius = 256, 4, 4
    f1, f2cat, coords = inputs or corr_inputs(gen, b, h8, w8, torch.bfloat16,
                                              20.0)
    meta = fc.cat_meta(h8, w8, levels)
    ms = graph_ms(lambda: fc.fused_corr_lookup_cat(f1, f2cat, coords, h8, w8,
                                                   levels, radius))
    host_ms = cuda_ms(lambda: fc.fused_corr_lookup_cat(
        f1, f2cat, coords, h8, w8, levels, radius))
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
          f"{ms * 1e3:.1f} us on the device ({host_ms * 1e3:.1f} us a call "
          f"launched from the host), plain {plain_ms * 1e3:.1f} us, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}: {nbytes / 1e6:.2f} MB, "
          f"{ops / 1e9:.3f} GFLOP)", flush=True)
    return ms, plain_ms, bound_ms, bound_by


FNET_SHAPES = ((2, 64, 220, 512), (2, 96, 110, 256), (2, 128, 55, 128))
TRAIN_FNET_SHAPES = tuple(
    (2 * TRAIN_BATCH, c, TRAIN_CROP[0] // s, TRAIN_CROP[1] // s)
    for c, s in ((64, 2), (96, 4), (128, 8)))
# GMFlow's backbone: the stacked pair at 448x1024 (Sintel padded to 16)
# and its training batch of 16 of 368x560
GM_FNET_SHAPES = ((2, 64, 224, 512), (2, 96, 112, 256), (2, 128, 56, 128))
GM_TRAIN_FNET_SHAPES = tuple(
    (2 * GM_BATCH, c, GM_CROP[0] // s, GM_CROP[1] // s)
    for c, s in ((64, 2), (96, 4), (128, 8)))
# RAFT-small's SmallEncoder (its bottlenecks norm planes / 4 channels)
# on the stacked pairs of the convergence check's batch of 4 of 96x128
SMALL_FNET_SHAPES = ((8, 32, 48, 64), (8, 8, 48, 64), (8, 16, 48, 64),
                     (8, 16, 24, 32), (8, 64, 24, 32), (8, 24, 24, 32),
                     (8, 24, 12, 16), (8, 96, 12, 16))


def instance_norm_compare(tag, x, relu, rtol, atol):
    """The kernel against the plain version on ``x``: y within ``atol +
    rtol |ref|``, mean within 1e-5, rstd within 1e-5 relative; returns
    (y, max |d| of y)."""
    import torch
    from opticalflowfromdepth_torch.ops import instance_norm as inorm
    y, m, r = inorm.instance_norm(x, 1e-5, relu)
    torch.cuda.synchronize()
    yr, mr, rr = inorm.instance_norm_plain(x, 1e-5, relu)
    if y.dtype != x.dtype or m.dtype != torch.float32:
        fail(f"instance norm dtypes {y.dtype}/{m.dtype}")
    check(f"{tag} y", max_rel_excess(y, yr, rtol, atol), 1.0)
    check(f"{tag} mean", float((m - mr).abs().max()), 1e-5)
    check(f"{tag} rstd", max_rel_excess(r, rr, 1e-5, 0.0), 1.0)
    return y, float((y.float() - yr.float()).abs().max())


def instance_norm_phase(gen):
    import torch
    from opticalflowfromdepth_torch.ops import instance_norm as inorm

    print("[3b] instance norm: CUDA kernel vs plain", flush=True)
    worst = 0.0
    for shape in FNET_SHAPES + TRAIN_FNET_SHAPES:
        x32 = (torch.randn(*shape, generator=gen) * 3 + 0.5).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for relu in (False, True):
                # f32: sums in another order, so 1e-4; bf16: the kernel and
                # the plain version each round the f32 value once, so the
                # two may land one bf16 step (2^-7 relative) apart
                rtol, atol = (0.0, 1e-4) if dtype == torch.float32 \
                    else (2 ** -7, 1e-3)
                _, err = instance_norm_compare(
                    f"{list(shape)} {dtype} relu={relu} "
                    f"{in_plan_tag(inorm, x)}", x, relu, rtol, atol)
                if dtype == torch.bfloat16 and shape in TRAIN_FNET_SHAPES:
                    worst = max(worst, err)

    # every plan class and GMFlow's shapes, from a generator of their own
    # (the inputs of every later phase stay as they were)
    igen = torch.Generator().manual_seed(15)
    cases = [("row shorter than a block's slice, odd n", (3, 5, 1, 37)),
             ("row not a multiple of the slice", (1, 2, 211, 307)),
             ("rows streamed twice (too long for the cluster)",
              (1, 3, 1024, 1024))]
    cases += [("GMFlow serving", s) for s in GM_FNET_SHAPES]
    cases += [("GMFlow training", s) for s in GM_TRAIN_FNET_SHAPES]
    for label, shape in cases:
        x32 = (torch.randn(*shape, generator=igen) * 3 + 0.5).cuda()
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            if dtype == torch.float16 and label.startswith("GMFlow t"):
                continue
            x = x32.to(dtype)
            # f16: one step of its 10-bit mantissa, as bf16's above
            rtol, atol = {torch.float32: (0.0, 1e-4),
                          torch.bfloat16: (2 ** -7, 1e-3),
                          torch.float16: (2 ** -10, 1e-3)}[dtype]
            instance_norm_compare(f"{label} {list(shape)} {dtype} "
                                  f"{in_plan_tag(inorm, x)}", x, True, rtol,
                                  atol)
    # a tensor whose data starts off the 16-byte grid
    shape = (2, 64, 55, 128)
    buf = torch.empty(2 * 64 * 55 * 128 + 8, dtype=torch.bfloat16,
                      device="cuda")
    x = buf[1:1 + 2 * 64 * 55 * 128].view(shape)
    x.copy_(torch.randn(*shape, generator=igen))
    if x.data_ptr() % 16 == 0:
        fail("instance norm: the unaligned case is aligned")
    instance_norm_compare(f"unaligned data {list(x.shape)} bf16", x, True,
                          2 ** -7, 1e-3)
    x = (torch.randn(*TRAIN_FNET_SHAPES[0], generator=igen)).cuda().to(
        torch.bfloat16)
    first = inorm.instance_norm(x, 1e-5, True)
    second = inorm.instance_norm(x, 1e-5, True)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail("instance norm: two launches on the same inputs differ")
    print("  two launches bit-equal", flush=True)
    # RAFT-small's SmallEncoder maps at the convergence check's shape (the
    # stacked pair of a batch of 4 of 96x128), a generator of their own
    sgen = torch.Generator().manual_seed(96)
    for shape in SMALL_FNET_SHAPES:
        x32 = (torch.randn(*shape, generator=sgen) * 3 + 0.5).cuda()
        for dtype, rtol, atol in ((torch.float32, 0.0, 1e-4),
                                  (torch.bfloat16, 2 ** -7, 1e-3)):
            for relu in (False, True):
                instance_norm_compare(
                    f"RAFT-small {list(shape)} {dtype} relu={relu} "
                    f"{in_plan_tag(inorm, x32.to(dtype))}", x32.to(dtype),
                    relu, rtol, atol)

    # one fnet forward (each shape 5 times, bf16, relu): serving (Sintel,
    # the stacked pair) printed; training (batch 8 of 368x496, the stacked
    # pairs: the shapes of the launches counted on this slice's main path)
    # recorded; GMFlow's backbone at its serving and training shapes
    instance_norm_timing(gen, FNET_SHAPES, "serving")
    ms, plain_ms, lib_ms, bound_ms = instance_norm_timing(
        gen, TRAIN_FNET_SHAPES, "training")
    instance_norm_timing(igen, GM_FNET_SHAPES, "GMFlow serving")
    instance_norm_timing(igen, GM_TRAIN_FNET_SHAPES, "GMFlow training")
    return dict(name="instance_norm", route="cuda",
                source="opticalflowfromdepth_torch/csrc/instance_norm.cu",
                replaces="opticalflowfromdepth_tpu/ops/instance_norm.py:44",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms)


def in_plan_tag(inorm, x) -> str:
    b, c, h, w = x.shape
    p = inorm.plan(b * c, h * w, x.element_size())
    return (f"(cluster {p['cluster']}, {p['rows_per_block']} rows a block, "
            f"slice {p['slice']}, {'resident' if p['resident'] else 'streamed'}"
            f", {p['blocks']} blocks)")


def instance_norm_timing(gen, shapes, what):
    """Kernel, plain, library and bound times of the 15 instance norms of
    one fnet forward (each shape 5 times), bf16 with ReLU."""
    import torch
    import torch.nn.functional as F
    from opticalflowfromdepth_torch.ops import instance_norm as inorm
    ms = plain_ms = lib_ms = bound_ms = 0.0
    for shape in shapes:
        x = torch.randn(*shape, generator=gen).cuda().to(torch.bfloat16)
        k_ms = graph_ms(lambda: inorm.instance_norm(x, 1e-5, True))
        h_ms = cuda_ms(lambda: inorm.instance_norm(x, 1e-5, True))
        p_ms = cuda_ms(lambda: inorm.instance_norm_plain(x, 1e-5, True))
        l_ms = graph_ms(lambda: F.relu(F.instance_norm(x, eps=1e-5)))
        b_ms = 2 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
        print(f"  {what}: bf16 {list(shape)} {in_plan_tag(inorm, x)}: kernel "
              f"{k_ms * 1e3:.1f} us ({b_ms / k_ms:.2f} of the bound; "
              f"{h_ms * 1e3:.1f} us a call launched from the host), plain "
              f"{p_ms * 1e3:.1f} us, F.instance_norm+relu {l_ms * 1e3:.1f} "
              f"us, bound {b_ms * 1e3:.2f} us (bytes)", flush=True)
        ms += 5 * k_ms
        plain_ms += 5 * p_ms
        lib_ms += 5 * l_ms
        bound_ms += 5 * b_ms
    print(f"  {what}: 15 calls of one fnet forward: kernel {ms * 1e3:.1f} us,"
          f" plain {plain_ms * 1e3:.1f} us, library {lib_ms * 1e3:.1f} us, "
          f"bound {bound_ms * 1e3:.1f} us ({bound_ms / ms:.2f} of the bound)",
          flush=True)
    return ms, plain_ms, lib_ms, bound_ms


def fused_corr_bwd_phase(gen):
    import torch
    from opticalflowfromdepth_torch.ops import fused_corr as fc

    print("[3c] fused lookup backward: CUDA kernel vs plain", flush=True)
    h8, w8 = TRAIN_CROP[0] // 8, TRAIN_CROP[1] // 8     # 46 x 62
    c, levels, radius = 256, 4, 4
    k2 = (2 * radius + 1) ** 2

    def inputs(b, h, w, dtype, spread, shift=0.0, draw=gen):
        f1, f2cat, coords = corr_inputs(draw, b, h, w, dtype, spread, shift,
                                        c, levels)
        g = torch.randn(b, h * w, levels * k2, generator=draw).cuda()
        return g.to(dtype), f1, f2cat, coords

    worst = 0.0
    # f32 (the CUDA-core route): the kernel sums in its own fixed order,
    # the plain version with a matmul: 1e-4. bf16 (C = 256: the tensor-core
    # route, d_corr split into bf16 hi + lo; the plain version repeats the
    # split): the same f32 sums in another order, each rounded to bf16
    # once, so they may be one bf16 step (2^-7 relative) apart. Two
    # launches on the same inputs must give the same bits (no atomics).
    # The edge cases (N = 65, one over a 64-query tile; 3x40, whose levels
    # 2 and 3 pool to nothing) draw from a generator of their own, so the
    # other cases and the later phases keep their draws.
    edge_gen = torch.Generator().manual_seed(64)
    for dtype, rtol, atol in ((torch.float32, 0.0, 1e-4),
                              (torch.bfloat16, 2 ** -7, 1e-3)):
        for label, (b, h, w, spread, shift), draw in (
                (f"train {h8}x{w8} B={TRAIN_BATCH}",
                 (TRAIN_BATCH, h8, w8, 20.0, 0.0), gen),
                ("ragged N=63", (1, 7, 9, 6.0, 0.0), gen),
                ("far out of range", (1, h8, w8, 0.0, 1e4), gen),
                ("ragged N=65", (1, 5, 13, 6.0, 0.0), edge_gen),
                ("levels pooled to nothing 3x40", (2, 3, 40, 6.0, 0.0),
                 edge_gen)):
            g, f1, f2cat, coords = inputs(b, h, w, dtype, spread, shift, draw)
            got = fc.fused_corr_lookup_cat_bwd(g, f1, f2cat, coords, h, w,
                                               levels, radius)
            again = fc.fused_corr_lookup_cat_bwd(g, f1, f2cat, coords, h, w,
                                                 levels, radius)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"lookup backward {label} {dtype}: two launches on the "
                     "same inputs differ")
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
            pad = padded_rows(fc.cat_meta(h, w, levels))
            if torch.count_nonzero(got[1][:, pad]):
                fail(f"lookup backward {label}: padded rows of df2cat not 0")
            if shift:
                print(f"  {label} {dtype}: df1 and df2cat exactly 0",
                      flush=True)
            if label.startswith("train"):
                # planted faults: df2cat x 0.98, and the first query tile's
                # contribution left out (its cotangent zeroed)
                g_cut = g.clone()
                g_cut[0, :fc.KERNEL_TILE] = 0
                cut = fc.fused_corr_lookup_cat_bwd(g_cut, f1, f2cat, coords,
                                                   h, w, levels, radius)
                faults = [max_rel_excess(got[1].float() * 0.98, ref[1],
                                         rtol, atol),
                          max_rel_excess(cut[1], ref[1], rtol, atol)]
                print(f"    planted faults, |d| / tolerance (each must "
                      f"exceed 1): df2cat x 0.98 {faults[0]:.2f}, the first "
                      f"query tile left out {faults[1]:.2f}; padded rows 0; "
                      f"two launches bit-equal ({fc.route(dtype, c)})",
                      flush=True)
                if not min(faults) > 1.0:
                    fail(f"lookup backward: a planted fault passes {faults}")

    small_lookup_bwd_cases()

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
    # and df2cat written once in their inputs' dtypes. Its operations: the
    # in-range taps' products (the window form), and the transposed
    # bilinear stages. The kernel's own traffic beyond that: its tap
    # scratch, written once and read by both product passes.
    nbytes = (g.numel() + f1.numel() + f2cat.numel() + f1.numel()
              + f2cat.numel()) * g.element_size() + coords.numel() * 4
    npad = -(-h8 * w8 // 128) * 128
    scratch = TRAIN_BATCH * levels * npad * ((2 * radius + 2) ** 2 * 4 + 8)
    ops = 4 * c * taps + 8 * n * levels * (2 * radius + 2) ** 2
    dense = 2 * 2 * 2 * TRAIN_BATCH * h8 * w8 * f2cat.shape[1] * c
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOP_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_FLOP_PER_S \
        else "operations"
    print(f"  bf16 [{TRAIN_BATCH},{h8 * w8},{c}] x R={f2cat.shape[1]}: kernel "
          f"{ms * 1e3:.1f} us (three passes; the dense products, hi and lo, "
          f"{dense / 1e9:.1f} GFLOP: {dense / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP, "
          f"{taps} in-range taps); it moves {nbytes / 1e6:.2f} MB of inputs "
          f"and outputs and writes {scratch / 1e6:.2f} MB of tap scratch, "
          f"read once by df1's pass and once per row block by df2cat's",
          flush=True)
    return dict(name="fused_corr_lookup_bwd", route="cuda",
                source="opticalflowfromdepth_torch/csrc/fused_corr.cu",
                replaces="opticalflowfromdepth_tpu/ops/fused_corr.py:171",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def small_lookup_bwd_cases():
    """[3c] at RAFT-small's radius 3, C = 128 (drawn from a generator of
    their own): f32 (CUDA-core route) and bf16 (tensor-core route) within
    [3c]'s tolerances, two launches bit-equal, padded rows 0, and the
    planted faults (df2cat x 0.98, the first query tile left out) failing
    them."""
    import torch
    from opticalflowfromdepth_torch.ops import fused_corr as fc
    levels, radius = 4, 3
    k2 = (2 * radius + 1) ** 2
    sgen = torch.Generator().manual_seed(304)
    for dtype, rtol, atol in ((torch.float32, 0.0, 1e-4),
                              (torch.bfloat16, 2 ** -7, 1e-3)):
        for label, (b, h, w) in SMALL_LOOKUPS:
            f1, f2cat, coords = small_lookup_inputs(sgen, b, h, w, dtype,
                                                    "i.i.d.")
            g = torch.randn(b, h * w, levels * k2, generator=sgen).cuda(
            ).to(dtype)
            got = fc.fused_corr_lookup_cat_bwd(g, f1, f2cat, coords, h, w,
                                               levels, radius)
            again = fc.fused_corr_lookup_cat_bwd(g, f1, f2cat, coords, h, w,
                                                 levels, radius)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"lookup backward r=3 {label} {dtype}: two launches "
                     "differ")
            ref = fc.fused_corr_lookup_cat_bwd_plain(g, f1, f2cat, coords, h,
                                                     w, levels, radius)
            for name, x, r, like in zip(("df1", "df2cat"), got, ref,
                                        (f1, f2cat)):
                if x.shape != like.shape or x.dtype != like.dtype:
                    fail(f"lookup backward r=3 {label} {name}: {x.shape}/"
                         f"{x.dtype}, want {like.shape}/{like.dtype}")
                check(f"{label} r=3 C=128 {dtype} {name} "
                      f"({fc.route(dtype, 128)}; |d| <= {atol:g} + "
                      f"{rtol:g}|ref|)", max_rel_excess(x, r, rtol, atol),
                      1.0)
            if torch.count_nonzero(got[1][:, padded_rows(
                    fc.cat_meta(h, w, levels))]):
                fail(f"lookup backward r=3 {label}: padded rows not 0")
            g_cut = g.clone()
            g_cut[0, :fc.KERNEL_TILE] = 0
            cut = fc.fused_corr_lookup_cat_bwd(g_cut, f1, f2cat, coords, h,
                                               w, levels, radius)
            faults = [max_rel_excess(got[1].float() * 0.98, ref[1], rtol,
                                     atol),
                      max_rel_excess(cut[1], ref[1], rtol, atol)]
            print(f"    planted faults (each must exceed 1): df2cat x 0.98 "
                  f"{faults[0]:.2f}, the first query tile left out "
                  f"{faults[1]:.2f}; padded rows 0; two launches bit-equal",
                  flush=True)
            if not min(faults) > 1.0:
                fail(f"lookup backward r=3 {label}: a planted fault passes "
                     f"{faults}")


def padded_rows(meta):
    """The packed rows that pad a level's y to hp (not a real row)."""
    import torch
    rows = [off + x * hp + y for (hl, wl, hp, off) in meta
            for x in range(wl) for y in range(hl, hp)]
    return torch.tensor(rows, dtype=torch.long, device="cuda")


def instance_norm_grad_phase(gen):
    import torch
    from opticalflowfromdepth_torch.ops import instance_norm as inorm

    print("[3d] instance norm gradient: kernel forward + closed form vs "
          "autograd through the plain version", flush=True)
    for shape in TRAIN_FNET_SHAPES:
        x32 = (torch.randn(*shape, generator=gen) * 3 + 0.5).cuda()
        g32 = torch.randn(*shape, generator=gen).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            x_in, g_in = x32.to(dtype), g32.to(dtype)
            for relu in (False, True):
                grads, outs = [], []
                for fn in (inorm.instance_norm, inorm.instance_norm_plain):
                    x = x_in.clone().requires_grad_()
                    y = fn(x, 1e-5, relu)[0]
                    y.backward(g_in)
                    grads.append(x.grad)
                    outs.append(y.detach())
                torch.cuda.synchronize()
                if grads[0].dtype != dtype:
                    fail(f"instance norm grad dtype {grads[0].dtype}")
                # f32: the closed form and autograd through E[x^2]-E[x]^2
                # sum in other orders; bf16: each rounds once
                rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 \
                    else (2 ** -7, 1e-3)
                tol = atol + rtol * grads[1].float().abs()
                # ReLU ties: where the pre-activation lies within rounding
                # of 0, the kernel's forward and the plain one can fall on
                # opposite sides of the ReLU, and the backward masks g by
                # each one's own output, so dx there differs by |g| rstd
                # (every other dx by |g| rstd / (H W), inside the
                # tolerance). Those elements stay compared, with |g| rstd
                # allowed on top: the flip can cause no more, and a wrong
                # dx still fails. Each tie must lie within 1e-4 of 0.
                ties = ((outs[0] > 0) != (outs[1] > 0)) if relu \
                    else torch.zeros_like(outs[0], dtype=torch.bool)
                if bool(ties.any()):
                    _, mean, rstd = inorm.instance_norm_plain(x_in, 1e-5)
                    pre = (x_in.float() - mean) * rstd
                    if not float(pre[ties].abs().max()) <= 1e-4:
                        fail(f"instance norm {list(shape)} {dtype}: the "
                             f"forwards' ReLU masks differ away from 0")
                    tol = tol + ties * g_in.float().abs() * rstd
                err = (grads[0].float() - grads[1].float()).abs()
                check(f"{list(shape)} {dtype} relu={relu} dx (ReLU ties "
                      f"allowed |g| rstd: {int(ties.sum())} elements)",
                      float((err / tol).max()), 1.0)


def flash_inputs(gen, b, lq, lk, c, d, dtype, payload="normal", mult=1.0,
                 grid_w=128):
    """Seeded q, k (in ``dtype``) and v on the card. ``payload``: "normal"
    (attention values), "grid" (the matching grid of a map ``grid_w``
    wide) or "flow" (a flow in [-60, 60] px), the last two f32 as the
    model passes them."""
    import torch
    q = (torch.randn(b, lq, c, generator=gen) * mult).to(dtype).cuda()
    k = (torch.randn(b, lk, c, generator=gen) * mult).to(dtype).cuda()
    if payload == "grid":
        t = torch.arange(lk)
        v = torch.stack([t % grid_w, t // grid_w], -1).float()[None].repeat(
            b, 1, 1)
    elif payload == "flow":
        v = torch.rand(b, lk, 2, generator=gen) * 120 - 60
    else:
        v = torch.randn(b, lk, d, generator=gen).to(dtype)
    return q, k, v.cuda()


# GMFlow's flash calls at Sintel size (436x1024 padded to 448x1024): name,
# (B, L, C, D, payload, swin), calls per 1-scale pair
H8, W8 = 448 // 8, 1024 // 8
FLASH_SHAPES = (
    ("window", (8, H8 * W8 // 4, 128, 128, "normal", None), 6),
    ("window+swin", (8, H8 * W8 // 4, 128, 128, "normal",
                     (2, H8 // 2, W8 // 2, H8 // 4, W8 // 4)), 6),
    ("matching", (1, H8 * W8, 128, 2, "grid", None), 1),
    ("propagation", (1, H8 * W8, 128, 2, "flow", None), 1),
    ("refine window", (128, 448, 128, 128, "normal", None), 0),
    ("refine window+swin", (128, 448, 128, 128, "normal",
                            (8, 14, 32, 7, 16)), 0),
)
# and at KITTI size (375x1242 padded to 384x1248: windows of 24x78 tokens,
# the last 64-key tile ragged, shifted by 12 and 39), compared, not timed
KH8, KW8 = 384 // 8, 1248 // 8
FLASH_KITTI_SHAPES = (
    ("kitti window", (8, KH8 * KW8 // 4, 128, 128, "normal", None)),
    ("kitti window+swin", (8, KH8 * KW8 // 4, 128, 128, "normal",
                           (2, KH8 // 2, KW8 // 2, KH8 // 4, KW8 // 4))),
    ("kitti matching", (1, KH8 * KW8, 128, 2, "grid", None)),
    ("kitti propagation", (1, KH8 * KW8, 128, 2, "flow", None)),
)


def dropping_last_run(fl):
    """A context in which every split key sweep's merge leaves its last
    run out (a planted fault of the forward's tf32x3 route)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        real = fl._kernel_fns
        fn, merge = real()

        def merge_all_but_last(po, pm, out, lse, rows, d, splits, stream):
            return merge(po, pm, out, lse, rows, d, splits - 1, stream)
        fl._kernel_fns = lambda: (fn, merge_all_but_last)
        try:
            yield
        finally:
            fl._kernel_fns = real
    return ctx()


def flash_compare(fl, what, q, k, v, swin) -> float:
    """The kernel against the plain version on one input, out and LSE;
    returns the out's max abs diff. Tolerance: f32, the sums run in another
    order and (tf32x3 route) the split-TF32 products drop ~2^-21 of each
    term, 1e-4 of max|v|; bf16, ``bf16_tolerance`` row by row (two bf16
    steps of the row's largest ``pi_i |v_i|``). Two planted faults must
    exceed it: the output scaled by 0.98, and the last 64 keys left out of
    P . V but kept in the denominator (their v zeroed); where the tf32x3
    route splits the key sweep, a third: its merge leaving the last run
    out. A second launch on the same inputs must give the same bits. On
    the tf32x3 route it also prints, for information, how far hi-only
    TF32 products would lie (``flash_softmax_matmul_tf32(terms=1)``)."""
    import torch
    got, lse = fl.flash_softmax_matmul(q, k, v, swin=swin, with_lse=True)
    again, again_lse = fl.flash_softmax_matmul(q, k, v, swin=swin,
                                               with_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = fl.flash_softmax_matmul_plain(q, k, v, swin=swin,
                                                 with_lse=True)
    if got.shape != ref.shape or got.dtype != torch.float32 \
            or not bool(torch.isfinite(got).all()):
        fail(f"flash {what}: {got.shape}/{got.dtype}, finite="
             f"{bool(torch.isfinite(got).all())}")
    if not (torch.equal(got, again) and torch.equal(lse, again_lse)):
        fail(f"flash {what}: two launches on the same inputs differ")
    if q.dtype == torch.float32:
        tol = 1e-4 * float(v.abs().max())
        rule = f"|d| <= {tol:.3e}, 1e-4 max|v|"
    else:
        tol = fl.bf16_tolerance(q, k, v, swin=swin)
        rule = (f"|d| <= 2^-6 max pi|v| + 2^-16 sum pi|v| + 1e-6, row by "
                f"row: {float(tol.min()):.3e}..{float(tol.max()):.3e}")
    v_cut = v.clone()
    v_cut[:, -fl.KERNEL_BLOCK_K:] = 0
    faults = [(got * 0.98 - ref).abs(),
              (fl.flash_softmax_matmul(q, k, v_cut, swin=swin) - ref).abs()]
    ratios = [float((f / tol).max()) for f in faults]
    err = float((got - ref).abs().max())
    check(f"{what} out, {rule}; max |d| {err:.3e}; |d| / tolerance",
          float(((got - ref).abs() / tol).max()), 1.0)
    print(f"    planted faults, |d| / tolerance (each must exceed 1): out "
          f"x 0.98 {ratios[0]:.2f}, last key tile left out of P.V "
          f"{ratios[1]:.2f}; two launches bit-equal", flush=True)
    if not min(ratios) > 1.0:
        fail(f"flash {what}: a planted fault passes the tolerance {ratios}")
    # the row max enters the LSE whole: with extreme logits it is ~1e3, and
    # the scores' last-bit differences are ~1e-7 of it
    check(f"{what} lse (|d| <= 1e-4 + 1e-6|ref|, max |d| "
          f"{float((lse - ref_lse).abs().max()):.3e})",
          max_rel_excess(lse, ref_lse, 1e-6, 1e-4), 1.0)
    p = fl.plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2], v.shape[2],
                q.dtype)
    if p.route == "tf32x3":
        hi, hi_lse = fl.flash_softmax_matmul_tf32(q, k, v, swin=swin,
                                                  with_lse=True, terms=1)
        line = (f"    for information, hi-only TF32 products (plain, terms=1)"
                f": |d| / tolerance out {float(((hi - ref).abs() / tol).max()):.3f}"
                f", lse {max_rel_excess(hi_lse, ref_lse, 1e-6, 1e-4):.3f}")
        if p.splits > 1:
            with dropping_last_run(fl):
                bad = fl.flash_softmax_matmul(q, k, v, swin=swin)
            drop = float(((bad - ref).abs() / tol).max())
            line += (f"; key sweep split in {p.splits}, planted fault, the "
                     f"last run left out of the merge: |d| / tolerance "
                     f"{drop:.2f} (must exceed 1)")
            if not drop > 1.0:
                fail(f"flash {what}: the dropped run passes the tolerance")
        print(line, flush=True)
    return err


def flash_phase(gen):
    import torch
    from opticalflowfromdepth_torch.ops import flash as fl

    print("[3e] flash streaming softmax: CUDA kernel vs plain", flush=True)
    worst = 0.0
    sintel = {name for name, _, _ in FLASH_SHAPES}
    # the KITTI cases draw from a generator of their own (as in [3a])
    kitti_gen = torch.Generator().manual_seed(48)
    cases = [(name, args) for name, args, _ in FLASH_SHAPES] + list(
        FLASH_KITTI_SHAPES) + [
        ("ragged 100x100", (2, 100, 64, 16, "normal", None)),
        ("extreme logits", (1, 256, 32, 2, "flow", None))]
    for dtype in (torch.float32, torch.bfloat16):
        for name, (b, l, c, d, payload, swin) in cases:
            kitti = name.startswith("kitti")
            q, k, v = flash_inputs(kitti_gen if kitti else gen, b, l, l, c,
                                   d, dtype, payload,
                                   30.0 if name == "extreme logits" else 1.0,
                                   KW8 if kitti else W8)
            err = flash_compare(fl, f"{name} {dtype} [{b},{l},{c}]x"
                                f"[{b},{l},{d}]{plan_tag(fl, q, k, v)}", q,
                                k, v, swin)
            if dtype == torch.bfloat16 and name in sintel:
                worst = max(worst, err)
        # ragged keys (Lk = 63 < one 64-key tile) with Lq = 100
        q, _, _ = flash_inputs(gen, 2, 100, 100, 64, 16, dtype)
        _, k, v = flash_inputs(gen, 2, 63, 63, 64, 16, dtype)
        flash_compare(fl, f"ragged Lq=100 Lk=63 {dtype}", q, k, v, None)
    # the wgmma route's edges: lengths of a 64-row tile + 1 and - 1, D = 128
    # and 2, a Swin region edge inside a key tile (window 10x13 shifted 5
    # and 6: rows from 65 on, columns 7-12 of each window row), the
    # training windows' shape (its last key tile ragged), blocks of three
    # warpgroups with one idle; drawn from a
    # generator of their own, so the cases above keep their draws
    edge_gen = torch.Generator().manual_seed(62)
    for dtype in (torch.float32, torch.bfloat16):
        for name, (b, (lq, lk), d, payload, swin) in (
                ("ragged 65x129", (1, (65, 129), 128, "normal", None)),
                ("ragged 127x63", (2, (127, 63), 128, "normal", None)),
                ("ragged 129x65 D=2", (1, (129, 65), 2, "flow", None)),
                ("ragged 63x127 D=2", (2, (63, 127), 2, "flow", None)),
                ("swin edge inside a tile", (8, (130, 130), 128, "normal",
                                             (2, 10, 13, 5, 6))),
                ("train window+swin", (8, (805, 805), 128, "normal",
                                       (2, GH8 // 2, GW8 // 2, GH8 // 4,
                                        GW8 // 4))),
                # enough blocks for three warpgroups a block, the third
                # idle (Lq = 100 < 128)
                ("three warpgroups 264x100", (264, (100, 100), 128, "normal",
                                              None))):
            q, _, _ = flash_inputs(edge_gen, b, lq, lq, 128, d, dtype,
                                   payload)
            _, k, v = flash_inputs(edge_gen, b, lk, lk, 128, d, dtype,
                                   payload)
            flash_compare(fl, f"{name} {dtype} [{b},{lq},128]x[{b},{lk},"
                          f"{d}]{plan_tag(fl, q, k, v)}", q, k, v, swin)
    # the tf32x3 route's split key sweeps (as [3f]'s): B = 1 at D = 2, and
    # two batch entries at D = 128; a generator of their own
    split_gen = torch.Generator().manual_seed(65)
    for dtype in (torch.float32, torch.bfloat16):
        for name, (b, l, d, payload) in (
                ("split sweep B=1 L=2000 D=2", (1, 2000, 2, "flow")),
                ("split sweep L=1001", (2, 1001, 128, "normal"))):
            q, k, v = flash_inputs(split_gen, b, l, l, 128, d, dtype,
                                   payload)
            flash_compare(fl, f"{name} {dtype} [{b},{l},128]x[{b},{l},{d}]"
                          f"{plan_tag(fl, q, k, v)}", q, k, v, None)

    # times at the serving shapes and dtype (bf16): per call, and the 14
    # calls of one 1-scale pair (the launches this record counts); then at
    # the training shapes, per call and the 14 calls of one step; then the
    # f32 route at the serving classes (the 14 calls of an f32 pair) and
    # the training matching class, beside the CUDA-core route it replaced
    pair, _ = flash_timing(fl, gen, FLASH_SHAPES, W8, "1-scale pair",
                           plain=True)
    flash_timing(fl, torch.Generator().manual_seed(63), FLASH_TRAIN_SHAPES,
                 GW8, "training step", plain=False)
    f32_pair = flash_f32_timing(fl, torch.Generator().manual_seed(66))
    return dict(name="flash", route="cuda",
                source="opticalflowfromdepth_torch/csrc/flash.cu",
                replaces="opticalflowfromdepth_tpu/ops/flash.py:40",
                max_abs_err=worst, **pair,
                **{f"f32_{k}": v for k, v in f32_pair.items()})


def plan_tag(fl, q, k, v, bias=None) -> str:
    """The kernel's route for these operands (with a bias or without), with
    its query rows a block, blocks, waves and the runs of a split key
    sweep."""
    import torch
    p = fl.kernel_plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                       v.shape[2], q.dtype == torch.bfloat16,
                       bias is not None)
    return (f" ({p['route']}, {p['rows']} query rows a block, "
            f"{p['blocks']} blocks, {p['per_sm']} a SM, {p['waves']} "
            f"wave(s)" + (f", key sweep split in {p['splits']}"
                          if p["splits"] > 1 else "") + ")")


def sdpa_backend(run) -> str:
    """Which of ``F.scaled_dot_product_attention``'s backends ``run`` (a
    call of it, or its backward) went through, from the ATen ops it ran:
    "flash", "cudnn", "efficient" (the CUTLASS memory-efficient kernels)
    or "math" (plain products and a softmax); "unknown" if none shows."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    names = " ".join(e.key.lower() for e in prof.key_averages())
    for backend, keys in (("flash", ("_flash_attention",)),
                          ("cudnn", ("_cudnn_attention",)),
                          ("efficient", ("_efficient_attention",)),
                          ("math", ("_scaled_dot_product_attention_math",
                                    "_softmax"))):
        if any(key in names for key in keys):
            return backend
    return "unknown"


def flash_timing(fl, gen, shapes, grid_w, what, plain, old_route=None):
    """Kernel, SDPA and bound times of each bf16 shape class, its TFLOP/s
    and share of the bound, and the totals over the calls of ``what``
    (``plain``: the plain version timed too; ``old_route``: that route
    forced on the same inputs (``fl.launcher(route=...)``, its launch
    alone) timed beside the planned one, which must beat it at every
    class; its totals as ``old_ms``)."""
    import torch
    import torch.nn.functional as F
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                 old_ms=0.0)
    flops = exps = nbytes = 0.0
    for name, (b, l, c, d, payload, swin), n in shapes:
        q, k, v = flash_inputs(gen, b, l, l, c, d, torch.bfloat16, payload,
                               grid_w=grid_w)
        ms = cuda_ms(lambda: fl.flash_softmax_matmul(q, k, v, swin=swin))
        old_ms = 0.0
        if old_route is not None:
            _, launch_old, _ = fl.launcher(q, k, v, swin=swin,
                                           route=old_route)
            old_ms = cuda_ms(launch_old, reps=5, warm=1)
            if not ms < old_ms:
                fail(f"flash {what} {name}: the planned route "
                     f"({ms * 1e3:.1f} us) does not beat the forced "
                     f"{old_route} route ({old_ms * 1e3:.1f} us)")
        plain_ms = cuda_ms(lambda: fl.flash_softmax_matmul_plain(
            q, k, v, swin=swin), reps=3, warm=1) if plain else 0.0
        vb = v.to(torch.bfloat16)
        mask = None if swin is None else fl.swin_mask_dense(
            l, swin, b, "cuda").to(torch.bfloat16)[:, None]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], vb[:, None], attn_mask=mask))
        backend = sdpa_backend(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], vb[:, None], attn_mask=mask))
        f, e = 2.0 * b * l * l * (c + d), float(b * l * l)
        by = (q.numel() + k.numel() + vb.numel()) * 2 + b * l * d * 4
        t_ops = max(f / BF16_FLOP_PER_S, e / SFU_PER_S)
        bound_ms = max(t_ops, by / HBM_BYTES_PER_S) * 1e3
        bound_by = "operations" if t_ops >= by / HBM_BYTES_PER_S \
            else "bytes"
        print(f"  {what}: {name} bf16 [{b},{l},{c}]x[{b},{l},{d}]"
              f"{plan_tag(fl, q, k, v)}: kernel {ms * 1e3:.1f} us "
              f"({f / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of its "
              f"bound), " + (f"plain {plain_ms * 1e3:.1f} us, " if plain
                             else "") + f"SDPA ({backend}) {lib_ms * 1e3:.1f} us, "
              f"bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}: {f / 1e9:.2f} GFLOP, "
              f"{e / 1e6:.1f} M exp, {by / 1e6:.2f} MB); {n} per "
              f"{what.split()[-1]}"
              + (f"; the {old_route} route forced {old_ms * 1e3:.1f} us "
                 f"({old_ms / ms:.2f}x)" if old_route else ""), flush=True)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", bound_ms),
                         ("old_ms", old_ms)):
            total[key] += n * val
        flops, exps, nbytes = flops + n * f, exps + n * e, nbytes + n * by
        del q, k, v, vb, mask
        torch.cuda.empty_cache()
    t_ops = max(flops / BF16_FLOP_PER_S, exps / SFU_PER_S)
    bound_by = "operations" if t_ops >= nbytes / HBM_BYTES_PER_S \
        else "bytes"
    calls = sum(n for _, _, n in shapes)
    print(f"  the {calls} calls of one {what}: kernel "
          f"{total['ms'] * 1e3:.1f} us ({flops / total['ms'] / 1e9:.1f} "
          f"TFLOP/s, {total['bound_ms'] / total['ms']:.3f} of the bound), "
          + (f"plain {total['plain_ms'] * 1e3:.1f} us, " if plain else "")
          + f"SDPA {total['library_ms'] * 1e3:.1f} us, bound "
          f"{total['bound_ms'] * 1e3:.1f} us ({bound_by}: "
          f"{flops / 1e9:.1f} GFLOP, {exps / 1e6:.1f} M exp, "
          f"{nbytes / 1e6:.1f} MB)"
          + (f"; the {old_route} route forced {total['old_ms'] * 1e3:.1f} "
             f"us ({total['old_ms'] / total['ms']:.2f}x)" if old_route
             else ""), flush=True)
    if old_route is None:
        del total["old_ms"]
    return dict(total, bound_by=bound_by), calls


def flash_f32_timing(fl, gen):
    """The f32 route at the serving shape classes (and the 14 calls of an
    f32 1-scale pair) and at the training matching class: the kernel's
    launch alone (CUDA events), the CUDA-core route it replaced forced in
    the same run, the plain version (serving), SDPA in f32 (TF32 off), and
    the bounds at the split-TF32 peak and at the CUDA cores' f32 peak with
    the share of each. Returns the pair's totals for the kernels line
    (the bound at the split-TF32 peak, the route's)."""
    import torch
    import torch.nn.functional as F
    shapes = [(f"serving {name}", args, n) for name, args, n in FLASH_SHAPES
              if n] + [("training matching", FLASH_TRAIN_SHAPES[2][1], 0)]
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                 old_ms=0.0)
    work = [0.0, 0.0, 0.0]
    for name, (b, l, c, d, payload, swin), n in shapes:
        q, k, v = flash_inputs(gen, b, l, l, c, d, torch.float32, payload,
                               grid_w=W8 if n else GW8)
        v = v.float()
        _, launch, p = fl.launcher(q, k, v, swin=swin, with_lse=True)
        _, launch_old, _ = fl.launcher(q, k, v, swin=swin, with_lse=True,
                                       route="f32")
        ms = cuda_ms(launch)
        old_ms = cuda_ms(launch_old, reps=3, warm=1)
        plain_ms = cuda_ms(lambda: fl.flash_softmax_matmul_plain(
            q, k, v, swin=swin), reps=3, warm=1) if n else 0.0
        mask = None if swin is None else fl.swin_mask_dense(
            l, swin, b, "cuda")[:, None]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None], attn_mask=mask))
        f, e = 2.0 * b * l * l * (c + d), float(b * l * l)
        by = 4.0 * (q.numel() + k.numel() + v.numel() + b * l * (d + 1))
        bounds = [bound_ms(f, e, by, peak) for peak in
                  (TF32X3_FLOP_PER_S, FP32_FLOP_PER_S)]
        print(f"  f32 {name} [{b},{l},{c}]x[{b},{l},{d}] ({p.route}, key "
              f"sweep in {p.splits}): kernel {ms * 1e3:.1f} us "
              f"({f / ms / 1e9:.1f} TFLOP/s, {bounds[0][0] / ms:.3f} of its "
              f"split-TF32 bound {bounds[0][0] * 1e3:.1f} us, "
              f"{bounds[1][0] / ms:.3f} of its f32 bound "
              f"{bounds[1][0] * 1e3:.1f} us, {bounds[0][1]}); before, the "
              f"CUDA-core route {old_ms * 1e3:.1f} us; SDPA f32 "
              f"{lib_ms * 1e3:.1f} us" + (f"; plain {plain_ms * 1e3:.1f} us"
                                         if n else "")
              + (f"; {n} per pair" if n else ""), flush=True)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", bounds[0][0]),
                         ("old_ms", old_ms)):
            total[key] += n * val
        work = [w + n * x for w, x in zip(work, (f, e, by))]
        del q, k, v, mask
        torch.cuda.empty_cache()
    bound, by = bound_ms(*work, TF32X3_FLOP_PER_S)
    print(f"  the 14 calls of one f32 1-scale pair: kernel "
          f"{total['ms'] * 1e3:.1f} us ({bound / total['ms']:.3f} of the "
          f"split-TF32 bound {bound * 1e3:.1f} us, {by}), before "
          f"{total['old_ms'] * 1e3:.1f} us, plain "
          f"{total['plain_ms'] * 1e3:.1f} us, SDPA f32 "
          f"{total['library_ms'] * 1e3:.1f} us", flush=True)
    return dict(ms=total["ms"], plain_ms=total["plain_ms"], bound_ms=bound,
                bound_by=by, library_ms=total["library_ms"])


# GMFlow's flash calls in one training step (batch 16 of 368x560, so
# 46x70 tokens; windows of 23x35, shifted by 11 and 17): name, (B, L, C,
# D, payload, swin), calls per step
GH8, GW8 = GM_CROP[0] // 8, GM_CROP[1] // 8
FLASH_TRAIN_SHAPES = (
    ("window", (8 * GM_BATCH, GH8 * GW8 // 4, 128, 128, "normal", None), 6),
    ("window+swin", (8 * GM_BATCH, GH8 * GW8 // 4, 128, 128, "normal",
                     (2, GH8 // 2, GW8 // 2, GH8 // 4, GW8 // 4)), 6),
    ("matching", (GM_BATCH, GH8 * GW8, 128, 2, "grid", None), 1),
    ("propagation", (GM_BATCH, GH8 * GW8, 128, 2, "flow", None), 1),
)


def dropping_last_partial(fb):
    """A context in which every split sweep's reduction leaves its last
    partial sum out (a planted fault of the tf32x3 route)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        real = fb._kernel_fns
        fn_dq, fn_dkv, fn_reduce = real()

        def reduce_all_but_last(part, out, n, splits, mult, stream):
            return fn_reduce(part, out, n, splits - 1, mult, stream)
        fb._kernel_fns = lambda: (fn_dq, fn_dkv, reduce_all_but_last)
        try:
            yield
        finally:
            fb._kernel_fns = real
    return ctx()


def flash_bwd_compare(fl, fb, what, q, k, v, g, swin) -> float:
    """The two backward kernels against the plain backward on one input,
    from the forward kernel's out and LSE; returns the largest max abs
    diff of dq, dk, dv. Tolerance: f32, the sums run in another order and
    (tf32x3 route) the split-TF32 products drop ~2^-21 of each term,
    1e-4 of each gradient's max |ref|; bf16, ``bwd_bf16_tolerance`` row by
    row (dq) and key by key (dk, dv). Two planted faults must exceed it:
    dq scaled by 0.98, and dk and dv with the first 64-query tile left out
    of the kernel's sweep (its LSE set to 1e30, so its p is 0); where the
    tf32x3 route splits a sweep, a third: its reduction leaving the last
    partial sum out. A second launch on the same inputs must give the same
    bits (no atomics). On the tf32x3 route it also prints, for
    information, how far hi-only TF32 products would lie
    (``flash_backward_tf32(terms=1)``)."""
    import torch
    out, lse = fl.flash_softmax_matmul(q, k, v, swin=swin, with_lse=True)
    got = fb.flash_backward(q, k, v, out, lse, g, swin=swin)
    torch.cuda.synchronize()
    ref = fb.flash_backward_plain(q, k, v, out, lse, g, swin=swin)
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        if x.shape != r.shape or x.dtype != torch.float32 \
                or not bool(torch.isfinite(x).all()):
            fail(f"flash backward {what} {name}: {x.shape}/{x.dtype}, "
                 f"finite={bool(torch.isfinite(x).all())}")
    if q.dtype == torch.float32:
        tols = [1e-4 * float(r.abs().max()) for r in ref]
        rule = "|d| <= 1e-4 max|ref|"
    else:
        tols = fb.bwd_bf16_tolerance(q, k, v, out, lse, g, swin=swin)
        rule = "bwd_bf16_tolerance, row by row"
    ratios = [float(((x - r).abs() / t).max())
              for x, r, t in zip(got, ref, tols)]
    errs = [float((x - r).abs().max()) for x, r in zip(got, ref)]
    again = fb.flash_backward(q, k, v, out, lse, g, swin=swin)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"flash backward {what}: two launches on the same inputs "
             f"differ")
    lse_cut = lse.clone()
    lse_cut[:, :64] = 1e30
    cut = fb.flash_backward(q, k, v, out, lse_cut, g, swin=swin)
    faults = [float(((got[0] * 0.98 - ref[0]).abs() / tols[0]).max())] + [
        float(((cut[i] - ref[i]).abs() / tols[i]).max()) for i in (1, 2)]
    check(f"{what} ({rule}; max |d| dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv "
          f"{errs[2]:.3e}); |d| / tolerance dq {ratios[0]:.3f}, dk "
          f"{ratios[1]:.3f}, dv", ratios[2], 1.0)
    check("  dq and dk |d| / tolerance", max(ratios[:2]), 1.0)
    print(f"    planted faults, |d| / tolerance (each must exceed 1): dq x "
          f"0.98 {faults[0]:.2f}, first query tile left out: dk "
          f"{faults[1]:.2f}, dv {faults[2]:.2f}; two launches bit-equal",
          flush=True)
    if not min(faults) > 1.0:
        fail(f"flash backward {what}: a planted fault passes {faults}")
    p = fb.plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2], v.shape[2],
                q.dtype)
    if p.route == "tf32x3":
        hi = fb.flash_backward_tf32(q, k, v, out, lse, g, swin=swin, terms=1)
        hi_ratio = max(float(((x - r).abs() / t).max())
                       for x, r, t in zip(hi, ref, tols))
        line = (f"    for information, hi-only TF32 products (plain, terms=1)"
                f": |d| / tolerance {hi_ratio:.2f}; splits dq "
                f"{p.splits_dq}, dk/dv {p.splits_dkv}")
        if max(p.splits_dq, p.splits_dkv) > 1:
            with dropping_last_partial(fb):
                bad = fb.flash_backward(q, k, v, out, lse, g, swin=swin)
            split = [i for i, n in ((0, p.splits_dq), (1, p.splits_dkv),
                                    (2, p.splits_dkv)) if n > 1]
            drop = min(float(((bad[i] - ref[i]).abs() / tols[i]).max())
                       for i in split)
            line += (f"; planted fault, the last partial left out of the "
                     f"reduction: |d| / tolerance {drop:.2f} (must exceed 1)")
            if not drop > 1.0:
                fail(f"flash backward {what}: the dropped partial passes")
        print(line, flush=True)
    return max(errs)


# sha256 prefixes of the C = 128 bf16 wgmma routes' outputs on
# :func:`wgmma_digests`'s inputs, by nvcc release: the forward's out and LSE
# and the backward's dq, dk, dv, each recorded from the tree before its
# wgmma route took C = 256 as well
C128_DIGESTS = {"12.9": {"forward": ("f85cf99233e7b8b9", "014e7f5e48a0fbbe"),
                         "backward": ("dcf4718e1dac69d5",
                                      "4d617edf4f662b03")}}
# and the C = 256 wgmma routes', recorded from the tree before the
# mma.sync and CUDA-core kernels took widths past 256
C256_DIGESTS = {"12.9": {"forward": ("de87da402f7afd75", "0b8c79e72fc87db3"),
                         "backward": ("595b973e9536bb9a",
                                      "1c4a235bba5009bb")}}
WGMMA_DIGESTS = {128: C128_DIGESTS, 256: C256_DIGESTS}


def wgmma_digests(fl, fb, c: int = 128) -> dict:
    """The digests of :data:`WGMMA_DIGESTS` at C = ``c`` (128 or 256):
    windows with a Swin region edge inside a tile [8,130,c]x[..,c], and
    ragged [2,129,c]x[2,65,2], from a generator of their own: "forward"
    hashes the forward kernel's out and LSE, "backward" the backward
    kernels' dq, dk, dv from them."""
    import hashlib

    import torch
    gen = torch.Generator().manual_seed(78)
    digests = {"forward": [], "backward": []}
    for b, lq, lk, d, payload, swin in (
            (8, 130, 130, c, "normal", (2, 10, 13, 5, 6)),
            (2, 129, 65, 2, "flow", None)):
        q, _, _ = flash_inputs(gen, b, lq, lq, c, d, torch.bfloat16,
                               payload)
        _, k, v = flash_inputs(gen, b, lk, lk, c, d, torch.bfloat16,
                               payload)
        g = torch.randn(b, lq, d, generator=gen).cuda()
        out, lse = fl.flash_softmax_matmul(q, k, v, swin=swin, with_lse=True)
        for key, tensors in (
                ("forward", (out, lse)),
                ("backward", fb.flash_backward(q, k, v, out, lse, g,
                                               swin=swin))):
            h = hashlib.sha256()
            for t in tensors:
                h.update(t.contiguous().cpu().numpy().tobytes())
            digests[key].append(h.hexdigest()[:16])
    return {key: tuple(val) for key, val in digests.items()}


def nvcc_release() -> str:
    """The release of the nvcc that builds the kernels ("12.9")."""
    import re

    from opticalflowfromdepth_torch import _build
    out = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                         text=True).stdout
    found = re.search(r"release (\d+\.\d+)", out)
    return found.group(1) if found else "unknown"


def flash_bwd_phase(gen):
    import torch
    import torch.nn.functional as F
    from opticalflowfromdepth_torch.ops import flash as fl
    from opticalflowfromdepth_torch.ops import flash_bwd as fb

    print("[3f] flash backward: CUDA kernels (dq; dk and dv) vs plain",
          flush=True)
    worst = 0.0
    shapes = {name for name, _, _ in FLASH_TRAIN_SHAPES}
    # C = 64 and C = 32 take the mma.sync route. The wgmma route's tiles
    # are 64 rows (each ring tile, each consumer warpgroup) and 128 a
    # block: lengths of a tile + 1 and a tile - 1, and a Swin region edge
    # inside a key tile (window 10x13 shifted 5 and 6: rows from 65 on,
    # columns 7-12 of each window row). These draw from a generator of
    # their own, so the other cases and the later phases keep their draws.
    edge_gen = torch.Generator().manual_seed(61)
    cases = [(name, args) for name, args, _ in FLASH_TRAIN_SHAPES] + [
        ("ragged 200x300 D=2", (1, (200, 300), 64, 2, "flow", None)),
        ("extreme logits", (1, 256, 32, 2, "flow", None))]
    edges = [
        ("ragged 65x129", (1, (65, 129), 128, 128, "normal", None)),
        ("ragged 127x63", (2, (127, 63), 128, 128, "normal", None)),
        ("ragged 129x65 D=2", (1, (129, 65), 128, 2, "flow", None)),
        ("ragged 63x127 D=2", (2, (63, 127), 128, 2, "flow", None)),
        ("swin edge inside a tile", (8, 130, 128, 128, "normal",
                                     (2, 10, 13, 5, 6))),
        ("split sweep B=1 L=2000 D=2", (1, 2000, 128, 2, "flow", None)),
        ("split sweep L=1001", (2, 1001, 128, 128, "normal", None))]
    for dtype in (torch.float32, torch.bfloat16):
        for name, (b, l, c, d, payload, swin) in cases + edges:
            lq, lk = l if isinstance(l, tuple) else (l, l)
            draw = edge_gen if (name, (b, l, c, d, payload, swin)) in edges \
                else gen
            q, _, _ = flash_inputs(draw, b, lq, lq, c, d, dtype, payload,
                                   30.0 if name == "extreme logits" else 1.0)
            _, k, v = flash_inputs(draw, b, lk, lk, c, d, dtype, payload,
                                   30.0 if name == "extreme logits" else 1.0,
                                   grid_w=GW8)
            g = torch.randn(b, lq, d, generator=draw).cuda()
            route = fb.plan(b, lq, lk, c, d, dtype).route
            err = flash_bwd_compare(fl, fb, f"{name} {dtype} [{b},{lq},{c}]"
                                    f"x[{b},{lk},{d}] ({route})", q, k, v, g,
                                    swin)
            if dtype == torch.bfloat16 and name in shapes:
                worst = max(worst, err)
            del q, k, v, g
            torch.cuda.empty_cache()
        # ragged Lq = 100 against Lk = 63 (less than one key tile), D = 16
        q, _, _ = flash_inputs(gen, 2, 100, 100, 64, 16, dtype)
        _, k, v = flash_inputs(gen, 2, 63, 63, 64, 16, dtype)
        flash_bwd_compare(fl, fb, f"ragged Lq=100 Lk=63 D=16 {dtype}", q, k,
                          v, torch.randn(2, 100, 16, generator=gen).cuda(),
                          None)

    # the C = 128 and 256 wgmma routes' bits, against the recorded ones
    release = nvcc_release()
    for c, recorded in WGMMA_DIGESTS.items():
        got, want = wgmma_digests(fl, fb, c), recorded.get(release)
        for key, what in (("forward", "forward's (out, LSE)"),
                          ("backward", "backward's (dq, dk, dv)")):
            if want is None:
                print(f"  the C = {c} bf16 {what} bits (sha256): {got[key]}, "
                      f"not compared: recorded with nvcc "
                      f"{', '.join(recorded)}, built with {release}",
                      flush=True)
                continue
            print(f"  the C = {c} bf16 {what} bits (sha256): {got[key]}, "
                  f"recorded {want[key]} (nvcc {release})", flush=True)
            if got[key] != want[key]:
                fail(f"the C = {c} bf16 {what} bits changed: {got[key]}, "
                     f"recorded {want[key]}")

    # the autograd Function in f32 against autograd through a dense softmax
    x = [torch.randn(s, generator=gen).cuda()
         for s in ((8, 24, 32), (8, 24, 32), (8, 24, 32), (8, 24, 32))]
    swin = (2, 4, 6, 2, 3)
    ours = [t.clone().requires_grad_() for t in x[:3]]
    dense = [t.clone().requires_grad_() for t in x[:3]]
    before = (fb.flash_backward.launches_dq, fb.flash_backward.launches_dkv)
    fl.flash_softmax_matmul(*ours, swin=swin).backward(x[3])
    torch.cuda.synchronize()
    if (fb.flash_backward.launches_dq - before[0],
            fb.flash_backward.launches_dkv - before[1]) != (1, 1):
        fail("the flash Function's backward did not launch both kernels once")
    s = torch.matmul(dense[0], dense[1].transpose(1, 2)) * 32 ** -0.5
    (torch.softmax(s + fl.swin_mask_dense(24, swin, 8, "cuda"), -1)
     @ dense[2]).backward(x[3])
    check("the Function's f32 gradients vs autograd through a dense "
          "softmax, Swin [8, 24, 32] (|d| / max|ref|)",
          max(float((a.grad - r.grad).abs().max() / r.grad.abs().max())
              for a, r in zip(ours, dense)), 2e-5)

    # times at the training shapes: bf16 (every GMFlow training step; the
    # kernels line) and f32 (an f32 GMFlow step, --no_mixed_precision: the
    # tf32x3 route)
    records = flash_bwd_timing(fl, fb, F, gen, torch.bfloat16)
    flash_bwd_timing(fl, fb, F, gen, torch.float32)
    for rec in records:
        rec["max_abs_err"] = worst
    return records


def flash_bwd_timing(fl, fb, F, gen, dtype, shapes=FLASH_TRAIN_SHAPES,
                     old_route=None):
    """Each backward kernel launched alone at the training shapes (per
    launch, and the 14 + 14 launches of one step), against its bound,
    the plain backward and SDPA's backward asked for its outputs; returns
    the kernels line's records of the step (bf16). In f32 each bound is
    printed twice: at the split-TF32 peak (the tf32x3 route) and at the
    CUDA cores' f32 peak (the route before it). ``old_route``: that route
    forced on the same inputs is timed beside each kernel (the records'
    ``old_ms``), and each kernel must beat it at every shape."""
    import torch
    bf16 = dtype == torch.bfloat16
    esize = 2 if bf16 else 4
    peaks = ((BF16_FLOP_PER_S, "bf16"),) if bf16 else (
        (TF32X3_FLOP_PER_S, "split TF32"), (FP32_FLOP_PER_S, "f32"))
    step = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops=0.0,
                    exps=0.0, bytes=0.0, old_ms=0.0) for k in ("dq", "dkv")}
    lib_whole = 0.0
    for name, (b, l, c, d, payload, swin), n in shapes:
        q, k, v = flash_inputs(gen, b, l, l, c, d, dtype, payload,
                               grid_w=GW8)
        g = torch.randn(b, l, d, generator=gen).cuda()
        out, lse = fl.flash_softmax_matmul(q, k, v, swin=swin, with_lse=True)
        (dq, dk, dv), launch_dq, launch_dkv, plan = fb.launchers(
            q, k, v, out, lse, g, swin=swin)
        t_dq, t_dkv = cuda_ms(launch_dq), cuda_ms(launch_dkv)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(dq).all() & torch.isfinite(dk).all()):
            fail(f"flash backward timing {name}: non-finite gradients")
        old = ""
        if old_route is not None:
            _, old_dq, old_dkv, _ = fb.launchers(q, k, v, out, lse, g,
                                                 swin=swin, route=old_route)
            o_dq, o_dkv = cuda_ms(old_dq), cuda_ms(old_dkv)
            step["dq"]["old_ms"] += n * o_dq
            step["dkv"]["old_ms"] += n * o_dkv
            old = (f"; the {old_route} route forced: dq {o_dq * 1e3:.1f} us "
                   f"({o_dq / t_dq:.2f}x), dk/dv {o_dkv * 1e3:.1f} us "
                   f"({o_dkv / t_dkv:.2f}x)")
            if not (t_dq < o_dq and t_dkv < o_dkv):
                fail(f"flash backward {name}: the {plan.route} route "
                     f"({t_dq * 1e3:.1f} / {t_dkv * 1e3:.1f} us) loses to "
                     f"the {old_route} route ({o_dq * 1e3:.1f} / "
                     f"{o_dkv * 1e3:.1f} us)")
        t_wrap = cuda_ms(lambda: fb.flash_backward(q, k, v, out, lse, g,
                                                   swin=swin), reps=10)
        t_plain = cuda_ms(lambda: fb.flash_backward_plain(
            q, k, v, out, lse, g, swin=swin), reps=3, warm=1)
        # SDPA's backward at the same shapes and dtype (Swin mask as
        # attn_mask), asked for each kernel's outputs and for all three
        vb, gb = v.to(dtype), g.to(dtype)
        qs, ks, vs = (t[:, None].detach().requires_grad_()
                      for t in (q, k, vb))
        mask = None if swin is None else fl.swin_mask_dense(
            l, swin, b, "cuda").to(dtype)[:, None]
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        go = gb[:, None]
        lib_dq = cuda_ms(lambda: torch.autograd.grad(
            o, (qs,), go, retain_graph=True), reps=10)
        lib_dkv = cuda_ms(lambda: torch.autograd.grad(
            o, (ks, vs), go, retain_graph=True), reps=10)
        lib_all = cuda_ms(lambda: torch.autograd.grad(
            o, (qs, ks, vs), go, retain_graph=True), reps=10)
        backend = sdpa_backend(lambda: torch.autograd.grad(
            o, (qs, ks, vs), go, retain_graph=True))
        lib_whole += n * lib_all
        # the work each kernel's function needs: dq recomputes S and dP and
        # takes dS . K; dk/dv recomputes S and dP and takes P^T . G and
        # dS^T . Q. Each reads q, k, v, g (in the operand dtype), lse and
        # delta (f32) once and writes its gradients once (f32).
        pairs = float(b * l * l)
        rd = (q.numel() + k.numel() + vb.numel() + gb.numel()) * esize \
            + 2 * b * l * 4
        work = {"dq": (2 * pairs * (2 * c + d), rd + q.numel() * 4),
                "dkv": (2 * pairs * (2 * c + 2 * d),
                        rd + k.numel() * 4 + v.numel() * 4)}
        times = {"dq": (t_dq, lib_dq), "dkv": (t_dkv, lib_dkv)}
        line = []
        for key, (ops, by) in work.items():
            rec = step[key]
            for field, val in (("ms", times[key][0]), ("plain_ms", t_plain),
                               ("library_ms", times[key][1]), ("ops", ops),
                               ("exps", pairs), ("bytes", by)):
                rec[field] += n * val
            shares = [(bound_ms(ops, pairs, by, peak)[0], what)
                      for peak, what in peaks]
            bounds = ", ".join(f"{bd / times[key][0]:.3f} of its {what} "
                               f"bound {bd * 1e3:.2f} us"
                               for bd, what in shares)
            line.append(f"{key} {times[key][0] * 1e3:.1f} us, "
                        f"{ops / times[key][0] / 1e9:.1f} TFLOP/s, {bounds} "
                        f"(SDPA for its outputs {times[key][1] * 1e3:.1f} us)")
        splits = f", splits {plan.splits_dq}/{plan.splits_dkv}" \
            if plan.route == "tf32x3" else ""
        print(f"  {name} {dtype} [{b},{l},{c}]x[{b},{l},{d}] ({plan.route}"
              f"{splits}): " + "; ".join(line) + f"; the wrapper (delta, "
              f"casts, both) {t_wrap * 1e3:.1f} us, SDPA's whole backward "
              f"({backend}) {lib_all * 1e3:.1f} us; plain "
              f"{t_plain * 1e3:.1f} us; {n} "
              f"per step{old}", flush=True)
        del q, k, v, g, out, lse, qs, ks, vs, o, mask, dq, dk, dv
        torch.cuda.empty_cache()
    records = []
    for key, kernel, line_no in (("dq", "_bwd_dq_kernel", 64),
                                 ("dkv", "_bwd_dkv_kernel", 99)):
        rec = step[key]
        bounds = [bound_ms(rec["ops"], rec["exps"], rec["bytes"], peak)
                  for peak, _ in peaks]
        shares = ", ".join(f"{bd / rec['ms']:.3f} of the {what} bound "
                           f"{bd * 1e3:.1f} us ({by})"
                           for (bd, by), (_, what) in zip(bounds, peaks))
        print(f"  the 14 {key} launches of one {dtype} step: kernel "
              f"{rec['ms'] * 1e3:.1f} us ({rec['ops'] / rec['ms'] / 1e9:.1f} "
              f"TFLOP/s, {shares}), plain (the whole backward) "
              f"{rec['plain_ms'] * 1e3:.1f} us, SDPA for its outputs "
              f"{rec['library_ms'] * 1e3:.1f} us ({rec['ops'] / 1e9:.1f} "
              f"GFLOP, {rec['exps'] / 1e6:.1f} M exp, "
              f"{rec['bytes'] / 1e6:.1f} MB) [{kernel}]"
              + (f"; the {old_route} route forced {rec['old_ms'] * 1e3:.1f} "
                 f"us ({rec['old_ms'] / rec['ms']:.2f}x)"
                 if old_route is not None else ""), flush=True)
        records.append(dict(
            name=f"flash_bwd_{key}", route="cuda",
            source="opticalflowfromdepth_torch/csrc/flash_bwd.cu",
            replaces=f"opticalflowfromdepth_tpu/ops/flash_bwd.py:{line_no}",
            max_abs_err=0.0, ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=bounds[0][0], bound_by=bounds[0][1],
            library_ms=rec["library_ms"]))
        if old_route is not None:
            records[-1]["old_ms"] = rec["old_ms"]
    print(f"  one {dtype} step's 14 + 14 launches: "
          f"{(step['dq']['ms'] + step['dkv']['ms']) * 1e3:.1f} us; SDPA's "
          f"whole backward at the same 14 calls {lib_whole * 1e3:.1f} us",
          flush=True)
    return records


# the conv's shapes: RAFT-basic's stride-1 3x3 convolutions at Sintel
# serving (440x1024 padded; fnet's three stages on the stacked pair, the
# motion encoder's last conv, 256 -> 126, and the flow head's, 256 -> 2,
# at 1/8), the
# JAX tests' ragged case, and GMFlow's backbone layer1 at its training batch
# (16 pairs of 368x560, stacked); name, (B, H, W, C, CO)
CONV_SHAPES = (
    ("fnet layer1", (2, 220, 512, 64, 64)),
    ("fnet layer2", (2, 110, 256, 96, 96)),
    ("fnet layer3", (2, 55, 128, 128, 128)),
    ("motion encoder", (1, 55, 128, 256, 126)),
    ("flow head", (1, 55, 128, 256, 2)),
    ("ragged", (1, 33, 17, 8, 8)),
    ("gmflow train layer1", (2 * GM_BATCH, GM_CROP[0] // 2, GM_CROP[1] // 2,
                             64, 64)),
)


def conv_phase(gen, log=""):
    import torch
    import torch.nn.functional as F
    from opticalflowfromdepth_torch.ops import conv2d as cv

    print("[3g] 3x3 conv: CUDA kernel vs plain (f32 with TF32 off)",
          flush=True)
    entry = ""
    for line in log.splitlines():   # ptxas on the wgmma route's kernels
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif ("conv3x3_wgmma" in entry and ("registers" in line
                                            or "spill" in line)) \
                or ("conv3x3_wgmma" in line and "Performance" in line):
            print(f"  ptxas, wgmma route: {line.strip()}", flush=True)
    th = cv.KERNEL_TILE_H
    # inputs drawn on the card (the largest is 105 M values), seeded from
    # the phase's generator
    cg = torch.Generator(device="cuda").manual_seed(
        int(torch.randint(0, 2 ** 31, (1,), generator=gen)))

    def randn(*shape):
        return torch.randn(*shape, generator=cg, device="cuda")

    def ratio(f, ref, tol):
        return float(((f.float() - ref).abs() / tol).max())

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, (b, h, w_, c, co) in CONV_SHAPES:
            x = randn(b, h, w_, c).to(dtype)
            w = (randn(3, 3, c, co) / (3 * c ** 0.5)).to(dtype)
            p = cv.plan(b, h, w_, c, co, dtype, x.data_ptr() % 16 == 0,
                        w.data_ptr() % 16 == 0, sms)
            print(f"  {name} {dtype} [{b},{h},{w_},{c}]->{co}: route "
                  f"{p.route}, tile {p.tile[0]}x{p.tile[1]}, N {p.n} x "
                  f"{p.n_cot} CO tiles, weights "
                  f"{'resident' if p.resident else 'per chunk'}, ring "
                  f"{p.stages}, {p.smem} bytes of shared memory a block, "
                  f"grid {p.grid}", flush=True)
            if dtype == torch.bfloat16 and c % 8 == 0 and p.route != "wgmma":
                fail(f"conv {name}: bf16 at C % 8 == 0 with aligned "
                     f"pointers took the {p.route} route")
            got = cv.conv3x3_s1(x, w)
            again = cv.conv3x3_s1(x, w)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int16 if dtype ==
                                        torch.bfloat16 else torch.int32),
                               again.view(torch.int16 if dtype ==
                                          torch.bfloat16 else torch.int32)):
                fail(f"conv {name} {dtype}: two launches differ")
            del again
            # ops/conv2d.py:tolerance: another summation order of the same
            # exact products, and in bf16 one step of the output
            ref, tol = cv.conv3x3_s1_plain(x, w).float(), cv.tolerance(x, w)
            if got.shape != ref.shape or got.dtype != dtype \
                    or not bool(torch.isfinite(got).all()):
                fail(f"conv {name}: {got.shape}/{got.dtype}, finite="
                     f"{bool(torch.isfinite(got).all())}")
            d = (got.float() - ref).abs()
            # the planted faults: the (2, 2) tap left out; the last halo
            # row of each band of KERNEL_TILE_H rows read as zero (the
            # first row of the next band, seen from the band's last output
            # row); each band's top-left halo pixel read wrong (the
            # padding at the image's corner read as the corner pixel, TMA's
            # zero fill missed; inside the image read as zero); where the
            # plan has two CO tiles or more, the last tap's weights of the
            # second read one input channel off
            w_cut = w.clone()
            w_cut[2, 2] = 0
            x_cut = x.clone()
            x_cut[:, th::th] = 0
            halo = got.clone()
            halo[:, th - 1::th] = cv.conv3x3_s1(x_cut, w)[:, th - 1::th]
            corner = got.float()
            corner[:, 0, 0] += x[:, 0, 0].float() @ w[0, 0].float()
            inner = x[:, th - 1:h - 1:th, th - 1:w_ - 1:th].float()
            corner[:, th::th, th::th] -= inner @ w[0, 0].float()
            faults = {"tap (2,2) left out": cv.conv3x3_s1(x, w_cut),
                      "last halo row of each band zero": halo,
                      "top-left halo pixel of each band read wrong":
                          corner.to(dtype)}
            if p.n_cot >= 2:
                w_off = w.clone()
                w_off[2, 2, :, p.n:2 * p.n] = w[2, 2, :, p.n:2 * p.n].roll(
                    1, 0)
                faults["last tap of the second CO tile one channel off"] = \
                    cv.conv3x3_s1(x, w_off)
            ratios = {k: ratio(f, ref, tol) for k, f in faults.items()}
            err = float(d.max())
            check(f"{name} {dtype} [{b},{h},{w_},{c}]->{co} (|d| <= 2^-16 "
                  f"sum|x.w|{' + 2^-7|ref|' if dtype == torch.bfloat16 else ''}"
                  f"; max |d| {err:.3e}; two launches bit-equal); |d| / "
                  f"tolerance", float((d / tol).max()), 1.0)
            print("    planted faults, |d| / tolerance (each must exceed 1): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in ratios.items()),
                  flush=True)
            if not min(ratios.values()) > 1.0:
                fail(f"conv {name} {dtype}: a planted fault passes {ratios}")
            if dtype == torch.bfloat16 and name.startswith("gmflow"):
                worst = err
            del x, w, got, ref, tol, d, w_cut, x_cut, halo, corner, faults
            torch.cuda.empty_cache()

    # the Function (kernel forward, kernel dx, f32 dw products) against
    # autograd through F.conv2d, f32 with TF32 off, at GMFlow's shape
    b, h, w_, c, co = CONV_SHAPES[-1][1]
    x = randn(b, h, w_, c)
    w = randn(3, 3, c, co) / (3 * c ** 0.5)
    g = randn(b, h, w_, co)
    ours = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    before = cv.conv3x3_s1.launches
    cv.conv3x3_s1(*ours).backward(g)
    torch.cuda.synchronize()
    if cv.conv3x3_s1.launches - before != 2:
        fail("the conv Function did not launch the kernel for y and dx")
    refs = {}
    for what, fn in (("F.conv2d", lambda a, b_: F.conv2d(
            a.permute(0, 3, 1, 2), b_.permute(3, 2, 0, 1),
            padding=1).permute(0, 2, 3, 1)),
                     ("the plain version", cv.conv3x3_s1_plain)):
        lib = [x.clone().requires_grad_(), w.clone().requires_grad_()]
        fn(*lib).backward(g)
        refs[what] = [float((a.grad - r.grad).abs().max()
                            / r.grad.abs().max()) for a, r in zip(ours, lib)]
        del lib
    print(f"  the Function's gradients, f32, [{b},{h},{w_},{c}]->{co}, |d| / "
          f"max|ref|: " + "; ".join(f"vs autograd through {k}: dx {v[0]:.3e},"
                                   f" dw {v[1]:.3e}" for k, v in refs.items()),
          flush=True)
    # f32, TF32 off. cuDNN's own weight gradient, a sum over 1.6 M pixels,
    # read 2.0e-4 of max|ref| from the plain version's on an H100 (whose
    # dw, nine cuBLAS f32 products, equals the Function's bit for bit), so
    # 1e-3 against cuDNN, and 1e-5 against the plain version
    check("  vs autograd through F.conv2d, dx and dw", max(refs["F.conv2d"]),
          1e-3)
    check("  vs autograd through the plain version, dx and dw",
          max(refs["the plain version"]), 1e-5)
    del x, w, g, ours
    torch.cuda.empty_cache()

    # times, bf16: every shape, device time (one CUDA graph of 20 calls)
    # beside a call launched from the host; at GMFlow's layer1 and fnet's
    # the mma.sync route (the kernel for the bf16 inputs the wgmma route
    # does not take) in the same run; at GMFlow's the backward's dx launch
    # beside cuDNN's input gradient. The record holds GMFlow's training
    # shape.
    times = {}
    for name, (b, h, w_, c, co) in CONV_SHAPES:
        x = randn(b, h, w_, c).to(torch.bfloat16)
        w = (randn(3, 3, c, co) / (3 * c ** 0.5)).to(torch.bfloat16)
        ms = graph_ms(lambda: cv.conv3x3_s1(x, w))
        host_ms = cuda_ms(lambda: cv.conv3x3_s1(x, w))
        plain_ms = cuda_ms(lambda: cv.conv3x3_s1_plain(x, w), reps=5)
        xc = x.permute(0, 3, 1, 2)                  # NCHW view, channels_last
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib_ms = graph_ms(lambda: F.conv2d(xc, wc, padding=1))
        ops = 2.0 * b * h * w_ * 9 * c * co
        nbytes = (x.numel() + b * h * w_ * co + w.numel()) * 2
        bound_by = "operations" if ops / BF16_FLOP_PER_S >= \
            nbytes / HBM_BYTES_PER_S else "bytes"
        bound_ms = max(ops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        p = cv.plan(b, h, w_, c, co, torch.bfloat16, sms=sms)
        extra = ""
        if name in ("gmflow train layer1", "fnet layer1"):
            old_ms = graph_ms(lambda: cv._conv_cuda(x, w, route="mma_sync"))
            extra += f", the mma.sync route {old_ms * 1e3:.1f} us"
        if name == "gmflow train layer1":
            g = randn(b, h, w_, co).to(torch.bfloat16)
            w_rot = w.flip(0, 1).transpose(2, 3).contiguous()
            dx_ms = graph_ms(lambda: cv.conv3x3_s1(g, w_rot))
            gc = g.permute(0, 3, 1, 2)
            lib_dx_ms = graph_ms(lambda: torch.nn.grad.conv2d_input(
                xc.shape, wc, gc, padding=1))
            extra += (f"; dx launch {dx_ms * 1e3:.1f} us, cuDNN's input "
                      f"gradient {lib_dx_ms * 1e3:.1f} us")
            del g, w_rot, gc
        print(f"  {name} bf16 [{b},{h},{w_},{c}]->{co} ({p.route}, N "
              f"{p.n} x {p.n_cot}, grid {p.grid[0]}): kernel "
              f"{ms * 1e3:.1f} us (device; a call from the host "
              f"{host_ms * 1e3:.1f} us), plain {plain_ms * 1e3:.1f} us, "
              f"F.conv2d (cuDNN, channels_last) {lib_ms * 1e3:.1f} us, bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}: {ops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB); {ops / ms / 1e9:.1f} TFLOP/s, "
              f"{bound_ms / ms:.3f} of the bound{extra}", flush=True)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=lib_ms)
        del x, w, xc, wc
        torch.cuda.empty_cache()
    return dict(name="conv3x3", route="cuda",
                source="opticalflowfromdepth_torch/csrc/conv3x3.cu",
                replaces="opticalflowfromdepth_tpu/ops/conv2d.py:31",
                max_abs_err=worst, **times["gmflow train layer1"])


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


def launch_counts():
    """Every kernel wrapper's launch count, under the kernels line's
    names."""
    from opticalflowfromdepth_torch.ops.conv2d import conv3x3_s1
    from opticalflowfromdepth_torch.ops.flash import flash_softmax_matmul
    from opticalflowfromdepth_torch.ops.flash_bwd import flash_backward
    from opticalflowfromdepth_torch.ops.fused_corr import \
        fused_corr_lookup_cat
    from opticalflowfromdepth_torch.ops.forward_warp import forward_warp
    from opticalflowfromdepth_torch.ops.instance_norm import instance_norm
    return {"fused_corr_lookup": fused_corr_lookup_cat.launches,
            "fused_corr_lookup_bwd": fused_corr_lookup_cat.bwd_launches,
            "instance_norm": instance_norm.launches,
            "flash": flash_softmax_matmul.launches,
            "flash_bwd_dq": flash_backward.launches_dq,
            "flash_bwd_dkv": flash_backward.launches_dkv,
            "conv3x3": conv3x3_s1.launches,
            "forward_warp": forward_warp.launches}


def zero_launch_counts() -> None:
    from opticalflowfromdepth_torch.ops.conv2d import conv3x3_s1
    from opticalflowfromdepth_torch.ops.flash import flash_softmax_matmul
    from opticalflowfromdepth_torch.ops.flash_bwd import flash_backward
    from opticalflowfromdepth_torch.ops.fused_corr import \
        fused_corr_lookup_cat
    from opticalflowfromdepth_torch.ops.forward_warp import forward_warp
    from opticalflowfromdepth_torch.ops.instance_norm import instance_norm
    fused_corr_lookup_cat.launches = fused_corr_lookup_cat.bwd_launches = 0
    instance_norm.launches = flash_softmax_matmul.launches = 0
    flash_backward.launches_dq = flash_backward.launches_dkv = 0
    conv3x3_s1.launches = forward_warp.launches = 0


def want_launches(**counts):
    """The counts a path must show: those named, every other kernel 0."""
    want = dict.fromkeys(launch_counts(), 0)
    want.update(counts)
    return want


def main_path_phase():
    import numpy as np
    import torch
    from opticalflowfromdepth_torch.eval.infer import raft_infer_fn
    from opticalflowfromdepth_torch.eval.padder import InputPadder
    from opticalflowfromdepth_torch.models.raft import RAFT

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
    zero_launch_counts()
    times = []
    for i1, i2 in pairs[1:]:
        t = time.perf_counter()
        flow = serve(i1, i2)
        times.append((time.perf_counter() - t) * 1e3)
        if flow.shape != (1,) + SINTEL + (2,) or not np.isfinite(flow).all():
            fail(f"main path flow {flow.shape}, finite="
                 f"{bool(np.isfinite(flow).all())}")
    launches = launch_counts()
    n = len(times)
    print(f"  launches over {n} pairs: {launches}", flush=True)
    want = want_launches(fused_corr_lookup=iters * n, instance_norm=15 * n)
    if launches != want:
        fail(f"serving launch counts {launches}, want {want}")
    print(f"  ms per pair: {[round(x, 3) for x in times]} (mean "
          f"{sum(times) / n:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    profile(lambda: serve(*pairs[1]), sum(times) / n, "pair")
    return launches


# name stems of the kernels in opticalflowfromdepth_torch/csrc
PORT_KERNELS = ("corr_fwd_tiles", "fused_corr_fwd_kernel", "corr_bwd_",
                "instance_norm_fwd", "flash_fwd_", "flash_bwd_",
                "merge_splits", "reduce_splits", "conv3x3_", "warp_kernel")


def profile(run, unprofiled_ms: float, what: str, named=None) -> None:
    """Device time by kernel over one more ``run()``, and the busy share of
    an unprofiled run's time (the profiler's own start-up inflates its
    wall clock, so that is not the denominator); returns the busy ms.
    ``named``: a list of (label, key substrings): those kernels' summed
    device time, launches and share of the busy time, each printed on a
    line of its own."""
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

    # device-side events only: a CPU op's row repeats its kernels' time,
    # and so does a user annotation's range on the device (the optimizer's
    # `Optimizer.step#AdamW.step`)
    rows = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False)
                   and dev_us(e) > 0), key=lambda e: -dev_us(e))
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    print(f"  profile of one {what}: device busy {busy_ms:.3f} ms against "
          f"{unprofiled_ms:.3f} ms per unprofiled {what} (busy "
          f"{100 * busy_ms / unprofiled_ms:.1f}%, idle "
          f"{100 - 100 * busy_ms / unprofiled_ms:.1f}%)", flush=True)
    for e in rows[:16]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}", flush=True)
    # the port's own kernels below those rows
    for e in rows[16:]:
        if any(k in e.key for k in PORT_KERNELS):
            print(f"    {dev_us(e) / 1e3:9.3f} ms  {e.count:5d}x  "
                  f"{e.key[:90]} (the port's)", flush=True)
    for label, keys in named or ():
        hits = [e for e in rows if any(k in e.key for k in keys)]
        ms = sum(dev_us(e) for e in hits) / 1e3
        print(f"  {label}: {ms:.3f} ms a {what}, "
              f"{sum(e.count for e in hits)} launches, "
              f"{100 * ms / busy_ms:.1f}% of the busy time", flush=True)
    host = sorted((e for e in prof.key_averages()
                   if not str(getattr(e, "device_type", "")).endswith("CUDA")
                   and e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)
    print(f"  host time by op (self, profiled {what}):", flush=True)
    for e in host[:8]:
        print(f"    {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}", flush=True)
    return busy_ms


# --------------------------------------------------------------------------
# phases 6, 7 and 8: training
# --------------------------------------------------------------------------

def seeded_classifier(seed: int, dtype):
    """The frozen classifier: the reference's random init from ``seed``
    (its linear head included)."""
    import torch
    from opticalflowfromdepth_torch.models.classifier import Classifier
    from opticalflowfromdepth_torch.models.layers import init_weights_
    cls = Classifier(dtype=dtype)
    init_weights_(cls, torch.Generator().manual_seed(seed))
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
    from opticalflowfromdepth_torch.train import raft_train as rt
    from opticalflowfromdepth_torch.train.runner import (RunnerConfig,
                                                          TrainRunner)
    from opticalflowfromdepth_torch.train.state import load_checkpoint
    from opticalflowfromdepth_torch.utils import profiling as prof

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
    timer = []          # utils.profiling.StepTimer over the timed steps

    def recorded_step(state, batch, gen):
        state, m = step(state, batch, gen)
        losses.append(float(m["total_loss"]))        # waits for the card
        stamps.append(time.perf_counter())
        for tm in timer:
            tm.tick(m["total_loss"])                 # fences on the card
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
    zero_launch_counts()
    timed = 5
    rcfg.num_steps = 1 + timed
    torch.cuda.synchronize()
    timer.append(prof.StepTimer(frames_per_step=b, warmup=0))
    t0 = time.perf_counter()
    timer[0].start()
    runner.run()
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    timed_steps = timer.pop().summary()
    launches = launch_counts()
    print(f"  launches over {timed} steps: {launches}", flush=True)
    want = want_launches(fused_corr_lookup=iters * timed,
                         fused_corr_lookup_bwd=iters * timed,
                         instance_norm=15 * timed)
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

    # utils.profiling: a trace of one more step (read in [19])
    log_dir = os.path.join(tmp, "trace")
    with prof.trace(log_dir):
        with prof.annotate("ofd_train_step"):
            rcfg.num_steps += 1
            runner.run()
        torch.cuda.synchronize()
    runner.batches.close()             # stops the loader's thread
    traces = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    profiling = {"timer": timed_steps, "host_ms": step_ms,
                 "trace_bytes": os.path.getsize(traces[0]),
                 "trace_events": len(events),
                 "annotated": sum(e.get("name") == "ofd_train_step"
                                  for e in events),
                 "kernels": sum(e.get("cat") == "kernel" for e in events),
                 "traces": len(traces)}
    return launches, profiling


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


# --------------------------------------------------------------------------
# phases 9 and 10: GMFlow serving
# --------------------------------------------------------------------------

GMFLOW_RECIPES = {1: ((2,), (-1,), (-1,)), 2: ((2, 8), (-1, 4), (-1, 1))}


def gmflow_parity_phase():
    import copy

    import numpy as np
    import torch
    from opticalflowfromdepth_torch.eval.infer import gmflow_infer_fn
    from opticalflowfromdepth_torch.models.gmflow import GMFlow

    print("[9] GMFlow 64x96, f32: card vs CPU", flush=True)
    rng = np.random.default_rng(12)
    i1, i2 = smooth_pairs(rng, 1, 64, 96)
    for ns in (1, 2):
        model = GMFlow(num_scales=ns, upsample_factor=8 if ns == 1 else 4,
                       generator=torch.Generator().manual_seed(13))
        sp, cr, pr = GMFLOW_RECIPES[ns]
        on_cpu = gmflow_infer_fn(copy.deepcopy(model), sp, cr, pr,
                                 device="cpu")
        cpu = on_cpu(i1, i2)
        # the model's own response on the CPU to input noise of 1e-4 gray
        # levels, the size of f32 rounding
        nudge = np.abs(on_cpu(i1 + 1e-4 * rng.standard_normal(i1.shape)
                              .astype(np.float32), i2) - cpu)
        gpu = gmflow_infer_fn(model, sp, cr, pr, device="cuda")(i1, i2)
        d = np.abs(gpu - cpu)
        what = "1-scale" if ns == 1 else "refine"
        print(f"  {what}: |flow| max {np.abs(cpu).max():.3f} px; the CPU "
              f"against itself with the nudged image (a reading, not a "
              f"limit): max {nudge.max():.3e}, 99th percentile "
              f"{np.quantile(nudge, 0.99):.3e}, median "
              f"{np.median(nudge):.3e} px", flush=True)
        # f32 both sides (TF32 off). 1 scale: the 2e-2 px of the CPU tests
        # against the JAX model (tests/test_torch_gmflow.py). Refine: its
        # local matching amplifies f32 rounding (the nudge reading above:
        # 0.434 px max, 9.0e-2 px at the 99th percentile on an H100), so the
        # max is held to a fixed 0.6 px, the 99th percentile to 0.2 px and
        # the median to 1e-2 px; the card read 0.209 px, 8.2e-2 px and
        # 2.3e-3 px.
        check(f"{what} flow card vs CPU (px)", float(d.max()),
              2e-2 if ns == 1 else 0.6)
        if ns == 2:
            check("  99th percentile (px)", float(np.quantile(d, 0.99)), 0.2)
        check("  median (px)", float(np.median(d)), 1e-2)


def gmflow_serving_phase():
    import numpy as np
    import torch
    from opticalflowfromdepth_torch.eval.infer import gmflow_infer_fn
    from opticalflowfromdepth_torch.eval.occlusion import \
        forward_backward_consistency_check
    from opticalflowfromdepth_torch.eval.padder import InputPadder
    from opticalflowfromdepth_torch.models.gmflow import GMFlow

    print(f"[10] GMFlow serving: bf16, 1 scale, 3 pairs of {SINTEL[0]}x"
          f"{SINTEL[1]} (padding factor 16)", flush=True)
    rng = np.random.default_rng(14)
    pairs = [[rng.uniform(0, 255, (1,) + SINTEL + (3,)).astype(np.float32)
              for _ in range(2)] for _ in range(4)]

    def want(flash, n):
        return want_launches(flash=flash * n, instance_norm=15 * n)

    def server(num_scales, bidir, factor):
        sp, cr, pr = GMFLOW_RECIPES[num_scales]
        model = GMFlow(num_scales=num_scales,
                       upsample_factor=8 if num_scales == 1 else 4,
                       dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(15))
        infer = gmflow_infer_fn(model, sp, cr, pr, pred_bidir_flow=bidir,
                                device="cuda")
        padder = InputPadder(pairs[0][0].shape, padding_factor=factor)

        def serve(i1, i2):
            a, b = padder.pad(i1, i2)
            return padder.unpad(infer(a, b))
        return serve

    def check_flow(flow, rows, what):
        if flow.shape != (rows,) + SINTEL + (2,) \
                or not np.isfinite(flow).all():
            fail(f"{what} flow {flow.shape}, finite="
                 f"{bool(np.isfinite(flow).all())}")

    serve = server(1, False, 16)
    t = time.perf_counter()
    serve(*pairs[0])                                   # warm-up pair
    print(f"  warm-up pair {(time.perf_counter() - t) * 1e3:.1f} ms",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    times = []
    for i1, i2 in pairs[1:]:
        t = time.perf_counter()
        flow = serve(i1, i2)
        times.append((time.perf_counter() - t) * 1e3)
        check_flow(flow, 1, "serving")
    launches = launch_counts()
    n = len(times)
    print(f"  launches over {n} pairs: {launches}", flush=True)
    if launches != want(14, n):
        fail(f"GMFlow serving launch counts {launches}, want {want(14, n)}")
    print(f"  ms per pair: {[round(x, 3) for x in times]} (mean "
          f"{sum(times) / n:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; |flow| "
          f"max {np.abs(flow).max():.3f} px", flush=True)
    profile(lambda: serve(*pairs[1]), sum(times) / n, "pair")

    print("  one bidirectional pair with the occlusion check", flush=True)
    serve = server(1, True, 16)
    serve(*pairs[0])                                   # warm-up
    zero_launch_counts()
    t = time.perf_counter()
    flow = serve(*pairs[1])
    ms = (time.perf_counter() - t) * 1e3
    got = launch_counts()
    check_flow(flow, 2, "bidirectional")
    occ = forward_backward_consistency_check(
        *(torch.from_numpy(np.ascontiguousarray(f[None])).cuda()
          for f in flow))
    if any(o.shape != (1,) + SINTEL for o in occ):
        fail(f"occlusion masks {[tuple(o.shape) for o in occ]}")
    print(f"  {ms:.3f} ms; launches {got}; occluded fraction fwd "
          f"{float(occ[0].mean()):.4f}, bwd {float(occ[1].mean()):.4f}",
          flush=True)
    if got != want(15, 1):
        fail(f"bidirectional launch counts {got}, want {want(15, 1)}")

    print("  one refine pair (2 scales, padding factor 32)", flush=True)
    serve = server(2, False, 32)
    serve(*pairs[0])                                   # warm-up
    zero_launch_counts()
    t = time.perf_counter()
    flow = serve(*pairs[1])
    ms = (time.perf_counter() - t) * 1e3
    got = launch_counts()
    check_flow(flow, 1, "refine")
    print(f"  {ms:.3f} ms; launches {got}; |flow| max "
          f"{np.abs(flow).max():.3f} px", flush=True)
    if got != want(26, 1):
        fail(f"refine launch counts {got}, want {want(26, 1)}")
    return launches


# --------------------------------------------------------------------------
# phases 11 and 12: GMFlow training
# --------------------------------------------------------------------------

GM_REFINE = dict(num_scales=2, upsample_factor=4, attn_splits_list=(2, 8),
                 corr_radius_list=(-1, 4), prop_radius_list=(-1, 1))


def smooth_pairs(rng, b, h, w):
    """``b`` pairs of smooth images (bilinear upsampled 8x12 noise) in
    [0, 255], NHWC numpy: random-noise images make matching ambiguous and
    amplify f32 rounding."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    low = torch.from_numpy(rng.uniform(0, 255, (2 * b, 3, 8, 12)).astype(
        np.float32))
    img = F.interpolate(low, size=(h, w), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    return np.ascontiguousarray(img[:b]), np.ascontiguousarray(img[b:])


def gmflow_train_parity_phase():
    import copy

    import numpy as np
    import torch
    from opticalflowfromdepth_torch.data.loader import to_device
    from opticalflowfromdepth_torch.train import gmflow_train as gt

    print("[11] GMFlow train step, 64x96, batch 2, f32, classifier on: card "
          "vs CPU", flush=True)
    rng = np.random.default_rng(16)
    i1, i2 = smooth_pairs(rng, 2, 64, 96)
    batch = dict(image1=i1, image2=i2,
                 flow=rng.normal(0, 3, (2, 64, 96, 2)).astype(np.float32),
                 valid=np.ones((2, 64, 96), np.float32),
                 label=np.eye(4, dtype=np.float32)[[0, 2]])
    cls = seeded_classifier(6, torch.float32)
    for extra, what in (({}, "1 scale"), (GM_REFINE, "refine")):
        cfg = gt.GMFlowTrainConfig(batch_size=2, image_size=(64, 96),
                                   mixed_precision=False, add_classifier=True,
                                   num_steps=100, **extra)
        out = {}
        for dev in ("cpu", "cuda"):
            state = gt.init_state(cfg, seed=8, device=dev)
            grads = {}
            adam_step = state.optimizer.step

            def step_keeping_grads(state=state, grads=grads,
                                   adam_step=adam_step):
                grads.update({n: p.grad.to("cpu", copy=True) for n, p
                              in state.model.named_parameters()})
                return adam_step()
            state.optimizer.step = step_keeping_grads
            step = gt.make_train_step(cfg, copy.deepcopy(cls), device=dev)
            state, m = step(state, to_device(batch, dev))
            out[dev] = ({k: float(v) for k, v in m.items()}, grads,
                        {k: v.cpu() for k, v in
                         state.model.state_dict().items()})
        (m_cpu, g_cpu, p_cpu), (m_card, g_card, p_card) = out["cpu"], \
            out["cuda"]
        # f32 on both sides (TF32 off). Metrics: 1e-4 relative (refine
        # 5e-4: its local matching amplifies f32 rounding, and the CPU
        # tests against the JAX step measured 1.4e-4); the accuracy and
        # outlier rates count pixels, and a pixel within rounding of a
        # threshold may count on the other side: two pixels allowed
        rel = 1e-4 if what == "1 scale" else 5e-4
        worst = max(abs(m_card[k] - v) / (max(abs(v), 1e-6) * rel
                                          + (2 / 12288 if "px_" in k else 0))
                    for k, v in m_cpu.items())
        print(f"  {what}: total_loss CPU {m_cpu['total_loss']:.6f}, card "
              f"{m_card['total_loss']:.6f}", flush=True)
        check(f"{what} loss and metrics, |d| / limit ({rel:g} relative, "
              "2 pixels for the rates)", worst, 1.0)
        # the raw gradients before the clip: 2e-4 of the global norm, the
        # backbone's first conv 1e-3 (the port's CPU step alone at 1 and
        # 4 threads differs there by 9.5e-5 / 4.95e-4 of the norm, 1 scale
        # / refine: the 15 instance norms' backward amplifies rounding)
        norm = float(torch.sqrt(sum((g ** 2).sum() for g in g_cpu.values())))
        parts = {}
        for part in ("backbone.", "transformer.", "feature_flow_attn.",
                     "upsampler."):
            keys = [k for k in g_cpu if k.startswith(part)]
            n_part = float(torch.sqrt(sum((g_cpu[k] ** 2).sum()
                                          for k in keys)))
            e_part = float(torch.sqrt(sum(((g_card[k] - g_cpu[k]) ** 2).sum()
                                          for k in keys)))
            parts[part] = (n_part, e_part / max(n_part, 1e-30))
        print(f"  {what}: gradient global norm CPU {norm:.4f}; norm and "
              "|card - CPU| / |CPU| by module: " + ", ".join(
                  f"{k[:-1]} {n:.4e} {r:.3e}" for k, (n, r) in parts.items()),
              flush=True)
        if not all(n > 0 for n, _ in parts.values()):
            fail(f"GMFlow {what}: a module got no gradient on the CPU")
        excess = max(float((g_card[k] - g).abs().max()) / norm
                     / (1e-3 if k == "backbone.conv1.weight" else 2e-4)
                     for k, g in g_cpu.items())
        check(f"{what} every raw gradient, |d| / (2e-4 of the global norm; "
              "1e-3 for backbone.conv1)", excess, 1.0)
        check(f"{what} every parameter after the update",
              max(float((p_card[k].float() - v.float()).abs().max())
                  for k, v in p_cpu.items()), 2e-4)


def gmflow_train_path_phase(tmp: str):
    import math

    import numpy as np
    import torch
    from opticalflowfromdepth_torch.data.datasets import AugmentedShards
    from opticalflowfromdepth_torch.data.loader import Loader, to_device
    from opticalflowfromdepth_torch.eval.cli import load_state_dict
    from opticalflowfromdepth_torch.eval.infer import gmflow_infer_fn
    from opticalflowfromdepth_torch.models.gmflow import GMFlow
    from opticalflowfromdepth_torch.train import gmflow_train as gt
    from opticalflowfromdepth_torch.train.runner import (RunnerConfig,
                                                          TrainRunner)
    from opticalflowfromdepth_torch.train.state import load_checkpoint

    b, (ch, cw) = GM_BATCH, GM_CROP
    print(f"[12] GMFlow training path: full width (128 channels, 6 blocks, "
          f"FFN x4), bf16, 1 scale, classifier on, batch {b} of {ch}x{cw} "
          "crops from 384x576 shards", flush=True)
    shards = os.path.join(tmp, "gmflow_shards")
    os.makedirs(shards)
    t = time.perf_counter()
    write_shards(shards, 16, 384, 576, seed=5)
    print(f"  wrote 16 shards in {time.perf_counter() - t:.1f} s", flush=True)
    loader = Loader(AugmentedShards(shards, crop_size=GM_CROP, seed=0),
                    batch_size=b, num_workers=4, seed=0)
    cfg = gt.GMFlowTrainConfig(batch_size=b, image_size=GM_CROP,
                               mixed_precision=True, add_classifier=True)
    step = gt.make_train_step(cfg, seeded_classifier(4, torch.bfloat16))
    losses, stamps = [], []

    def recorded_step(state, batch, gen):
        state, m = step(state, batch, gen)
        losses.append(float(m["total_loss"]))        # waits for the card
        stamps.append(time.perf_counter())
        return state, m

    rcfg = RunnerConfig(log_dir=os.path.join(tmp, "gmflow_run"), num_steps=1,
                        val_freq=10 ** 9, save_ckpt_freq=8,
                        save_latest_freq=8)
    runner = TrainRunner(rcfg, gt.init_state(cfg, seed=0), recorded_step,
                         loader, infer_fn_factory=gt.infer_fn_factory(cfg),
                         seed=0)
    t = time.perf_counter()
    runner.run()                                        # warm-up step
    torch.cuda.synchronize()
    print(f"  warm-up step {(time.perf_counter() - t) * 1e3:.1f} ms",
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    timed = 5
    rcfg.num_steps = 1 + timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run()
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    print(f"  launches over {timed} steps: {launches}", flush=True)
    want = want_launches(flash=14 * timed, flash_bwd_dq=14 * timed,
                         flash_bwd_dkv=14 * timed, instance_norm=15 * timed)
    if launches != want:
        fail(f"GMFlow training launch counts {launches}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"GMFlow training loss not finite: {losses}")
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
    busy_ms = profile(one_more_step, step_ms, "step")

    # the input pipeline alone: batches from a fresh loader, no training
    it = iter(Loader(AugmentedShards(shards, crop_size=GM_CROP, seed=1),
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
                              gt.init_state(cfg, seed=1))
    if resumed.step != 8:
        fail(f"latest checkpoint holds step {resumed.step}, want 8")
    serve = GMFlow(dtype=torch.bfloat16)
    serve.load_state_dict(load_state_dict(
        os.path.join(ckpt, "step_8_weights.pth")), strict=True)
    rng = np.random.default_rng(17)
    pair = [rng.uniform(0, 255, (1, ch, cw, 3)).astype(np.float32)
            for _ in range(2)]
    flow = gmflow_infer_fn(serve, cfg.attn_splits_list, cfg.corr_radius_list,
                           cfg.prop_radius_list, device="cuda")(*pair)
    trained = runner.infer_fn_factory(runner.state)(*pair)
    if flow.shape != (1, ch, cw, 2) or not np.isfinite(flow).all() \
            or not np.array_equal(flow, trained):
        fail(f"served flow from the trained weights {flow.shape}, finite="
             f"{bool(np.isfinite(flow).all())}, the same as the runner's "
             f"infer_fn_factory: {np.array_equal(flow, trained)}")
    print(f"  latest (step 8) resumed; step_8_weights served one pair "
          f"through gmflow_infer_fn, the same flow as the runner's "
          f"infer_fn_factory: |flow| max {np.abs(flow).max():.3f} px",
          flush=True)

    # the step alone, on a batch already on the card: what a step costs
    # without the input pipeline
    state = runner.state
    batch = to_device(next(runner.batches), "cuda")
    step(state, batch, None)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        state, _ = step(state, batch, None)
    torch.cuda.synchronize()
    alone_ms = (time.perf_counter() - t) * 1e3 / 3
    print(f"  the step alone on a batch already on the card: {alone_ms:.3f} "
          f"ms per step over 3 ({b * 1e3 / alone_ms:.3f} pairs/s); the "
          f"profiled step's device busy time is {100 * busy_ms / alone_ms:.1f}"
          "% of it", flush=True)

    # a batch whose target holds a NaN: the step is skipped
    bad = to_device(next(runner.batches), "cuda")
    bad["flow"][0, 0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = [v["exp_avg"].clone()
               for v in state.optimizer.adamw.state.values()]
    n0, c0 = state.step, state.optimizer.count
    state, m = step(state, bad, None)
    same = all(torch.equal(v, before[k])
               for k, v in state.model.state_dict().items()) and all(
        torch.equal(v["exp_avg"], mo) for v, mo in
        zip(state.optimizer.adamw.state.values(), moments))
    print(f"  NaN batch: total_loss {float(m['total_loss'])}, skipped_nan "
          f"{float(m['skipped_nan'])}, step {n0} -> {state.step}, "
          f"parameters and moments unchanged: {same}", flush=True)
    if not (float(m["skipped_nan"]) == 1.0 and same and state.step == n0
            and state.optimizer.count == c0):
        fail("the NaN batch was not skipped")
    runner.batches.close()             # stops the loader's thread
    return launches, alone_ms


def gmflow_learning_phase():
    import numpy as np
    import torch
    import torch.nn.functional as F
    from opticalflowfromdepth_torch.data.loader import to_device
    from opticalflowfromdepth_torch.train import gmflow_train as gt

    b, (h, w), n = 4, (192, 288), 30
    print(f"[12] GMFlow learning check: {n} steps on one fixed batch of {b} "
          f"{h}x{w} pairs (smooth images, image2 shifted by a known "
          "integer flow), bf16", flush=True)
    rng = np.random.default_rng(18)
    big = F.interpolate(torch.from_numpy(
        rng.uniform(0, 255, (b, 3, 24, 36)).astype(np.float32)),
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
    cfg = gt.GMFlowTrainConfig(batch_size=b, image_size=(h, w), num_steps=n)
    state = gt.init_state(cfg, seed=2)
    step = gt.make_train_step(cfg)
    losses = []
    for _ in range(n):
        state, m = step(state, batch)
        losses.append(float(m["total_loss"]))
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"  losses {[round(x, 3) for x in losses]}", flush=True)
    print(f"  mean loss of steps 1-5 {first:.4f}, of steps {n - 4}-{n} "
          f"{last:.4f}", flush=True)
    if not last < first:
        fail(f"the GMFlow loss did not fall: {first:.4f} -> {last:.4f}")


# --------------------------------------------------------------------------
# phase 13: evaluation
# --------------------------------------------------------------------------

KITTI_SIZE = (375, 1242)


def write_eval_trees(root: str, seed: int) -> dict:
    """Seeded benchmark trees in the reference's layout, written by the
    port's own writers (Pillow for frames, ``write_flo``,
    ``write_flow_kitti``): Sintel ``training/clean`` (one scene of 4
    frames, ``.flo`` ground truth, occlusion maps), KITTI ``training`` (3
    pairs, sparse ``flow_occ`` on the 1/64 px grid, so a PNG round trip is
    exact), the Sintel ``test`` split (clean and final, scenes of 3 and 2
    frames) and KITTI ``testing`` (2 pairs). Returns the ground truth."""
    import numpy as np
    from PIL import Image
    from opticalflowfromdepth_torch.data import frame_io

    rng = np.random.default_rng(seed)

    def image(path, hw):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)
                        ).save(path)

    gt = {"sintel": [], "occ": [], "kitti": []}
    train = os.path.join(root, "Sintel", "training")
    for i in range(4):
        image(os.path.join(train, "clean", "alley_1",
                           f"frame_{i + 1:04d}.png"), SINTEL)
    for sub in ("flow", "occlusions"):
        os.makedirs(os.path.join(train, sub, "alley_1"))
    for i in range(3):
        # speeds in all three buckets (< 10, 10-40, > 40 px), some leaving
        # the frame
        flow = (rng.normal(0, 1, SINTEL + (2,)) * rng.choice(
            [3.0, 20.0, 60.0], SINTEL + (1,))).astype(np.float32)
        frame_io.write_flo(os.path.join(train, "flow", "alley_1",
                                        f"frame_{i + 1:04d}.flo"), flow)
        occ = rng.uniform(size=SINTEL) > 0.8
        Image.fromarray(occ.astype(np.uint8) * 255).save(os.path.join(
            train, "occlusions", "alley_1", f"frame_{i + 1:04d}.png"))
        gt["sintel"].append(flow)
        gt["occ"].append(occ)
    kitti = os.path.join(root, "KITTI", "training")
    os.makedirs(os.path.join(kitti, "flow_occ"))
    for i in range(3):
        for t in (10, 11):
            image(os.path.join(kitti, "image_2", f"{i:06d}_{t}.png"),
                  KITTI_SIZE)
        flow = (np.round(rng.normal(0, 30, KITTI_SIZE + (2,)) * 64) / 64
                ).astype(np.float32)
        valid = rng.uniform(size=KITTI_SIZE) > 0.6
        frame_io.write_flow_kitti(os.path.join(kitti, "flow_occ",
                                               f"{i:06d}_10.png"), flow,
                                  valid)
        gt["kitti"].append((flow, valid))
    for dstype in ("clean", "final"):
        for scene, n in (("alley_9", 3), ("bandage_9", 2)):
            for i in range(n):
                image(os.path.join(root, "Sintel", "test", dstype, scene,
                                   f"frame_{i + 1:04d}.png"), SINTEL)
    for i in range(2):
        for t in (10, 11):
            image(os.path.join(root, "KITTI", "testing", "image_2",
                               f"{i:06d}_{t}.png"), KITTI_SIZE)
    return gt


def expected_metrics(flows_sintel, flows_kitti, gt, matched_unmatched):
    """The validators' numbers recomputed in numpy from the flows the
    model returned (unpadded) and the ground truth as written."""
    import numpy as np
    out = {}
    epe = [np.sqrt(((f - g) ** 2).sum(-1)) for f, g in
           zip(flows_sintel, gt["sintel"])]
    allepe = np.concatenate([e.ravel() for e in epe])
    out["sintel_clean_epe"] = allepe.mean()
    for k in (1, 3, 5):
        out[f"sintel_clean_{k}px"] = (allepe > k).mean()
    if matched_unmatched:
        mag = [np.sqrt((g ** 2).sum(-1)) for g in gt["sintel"]]
        for name, sel in (("s0_10", lambda m: m < 10),
                          ("s10_40", lambda m: (m >= 10) & (m <= 40)),
                          ("s40+", lambda m: m > 40)):
            out[f"sintel_clean_{name}"] = np.concatenate(
                [e[sel(m)] for e, m in zip(epe, mag)]).mean()
        h, w = SINTEL
        xs = np.arange(w, dtype=np.float32)[None]
        ys = np.arange(h, dtype=np.float32)[:, None]
        inside = [(xs + g[..., 0] >= 0) & (xs + g[..., 0] <= w - 1)
                  & (ys + g[..., 1] >= 0) & (ys + g[..., 1] <= h - 1)
                  & (np.abs(g[..., 0]) <= w - 1) & (np.abs(g[..., 1]) <= h - 1)
                  for g in gt["sintel"]]
        m = [i & ~o for i, o in zip(inside, gt["occ"])]
        out["sintel_clean_matched"] = np.concatenate(
            [e[s] for e, s in zip(epe, m)]).mean()
        out["sintel_clean_unmatched"] = np.concatenate(
            [e[~s] for e, s in zip(epe, m)]).mean()
    per_image, outliers = [], []
    for f, (g, valid) in zip(flows_kitti, gt["kitti"]):
        e = np.sqrt(((f - g) ** 2).sum(-1))
        mag = np.sqrt((g ** 2).sum(-1))
        per_image.append(e[valid].mean())
        outliers.append(((e > 3) & (e / np.maximum(mag, 1e-9) > 0.05))[valid])
    out["kitti_epe"] = np.mean(per_image)
    out["kitti_f1"] = 100 * np.concatenate(outliers).mean()
    return {k: float(v) for k, v in out.items()}


def eval_phase(tmp: str) -> dict:
    """[13] The evaluation path at full size through ``eval.cli.main``;
    returns the launch counts over its RAFT and GMFlow runs."""
    import numpy as np
    import torch
    from opticalflowfromdepth_torch.data import frame_io
    from opticalflowfromdepth_torch.eval import cli
    from opticalflowfromdepth_torch.eval import infer as infer_mod
    from opticalflowfromdepth_torch.eval import validators as V
    from opticalflowfromdepth_torch.eval.padder import InputPadder
    from opticalflowfromdepth_torch.models.gmflow import GMFlow
    from opticalflowfromdepth_torch.models.raft import RAFT

    print(f"[13] evaluation through eval.cli: Sintel {SINTEL[0]}x{SINTEL[1]} "
          f"and KITTI {KITTI_SIZE[0]}x{KITTI_SIZE[1]} trees, validators and "
          "submissions, RAFT-basic and GMFlow at full width, bf16, seeded "
          "weights", flush=True)
    root = os.path.join(tmp, "datasets")
    t = time.perf_counter()
    gt = write_eval_trees(root, seed=19)
    print(f"  wrote the trees in {time.perf_counter() - t:.1f} s", flush=True)
    # the PNG codec on this host's CPU: a KITTI ground truth file as the
    # port writes it (16-bit RGB, row filter 0), written and read 3 times
    path = os.path.join(tmp, "codec.png")
    t = time.perf_counter()
    for _ in range(3):
        frame_io.write_flow_kitti(path, *gt["kitti"][0])
    write_ms = (time.perf_counter() - t) / 3 * 1e3
    t = time.perf_counter()
    for _ in range(3):
        frame_io.read_flow_kitti(path)
    print(f"  the PNG codec on this host's CPU, {KITTI_SIZE[0]}x"
          f"{KITTI_SIZE[1]} 16-bit RGB, row filter 0: write_flow_kitti "
          f"{write_ms:.1f} ms, read_flow_kitti "
          f"{(time.perf_counter() - t) / 3 * 1e3:.1f} ms per file",
          flush=True)

    # (b) an infer_fn that returns the padded ground truth scores 0: the
    # cv2-free readers (the PNG codec, .flo) and the padding agree
    for name, mode, truth in (("sintel", "sintel", gt["sintel"]),
                              ("kitti", "kitti", [f for f, _ in gt["kitti"]])):
        flows = iter(truth)
        res = V.VALIDATORS[name](
            lambda a, b, it=flows, mode=mode: InputPadder(
                SINTEL if mode == "sintel" else KITTI_SIZE, mode=mode
            ).pad(next(it)[None])[0], root=root)
        scores = {k: v for k, v in res.items() if k.endswith(("epe", "f1"))}
        print(f"  (b) the padded ground truth as the flow: {scores}",
              flush=True)
        if any(v != 0.0 for v in scores.values()):
            fail(f"the ground truth does not score 0 on {name}: {scores}")

    # a recording infer_fn: what the CLI's infer functions were asked and
    # what they returned
    calls = []
    factories = {"raft": infer_mod.raft_infer_fn,
                 "gmflow": infer_mod.gmflow_infer_fn}

    def recording(factory):
        def make(*args, **kwargs):
            fn = factory(*args, **kwargs)

            def infer(image1, image2, **kw):
                out = fn(image1, image2, **kw)
                calls.append(dict(shape=image1.shape, init="flow_init" in kw,
                                  flow=out[-1] if isinstance(out, tuple)
                                  else out))
                return out
            return infer
        return make

    infer_mod.raft_infer_fn = recording(factories["raft"])
    infer_mod.gmflow_infer_fn = recording(factories["gmflow"])
    launches = dict.fromkeys(launch_counts(), 0)
    sintel_pad = {8: InputPadder(SINTEL, padding_factor=8),
                  16: InputPadder(SINTEL, padding_factor=16)}
    kitti_pad = {f: InputPadder(KITTI_SIZE, mode="kitti", padding_factor=f)
                 for f in (8, 16)}
    for model_name, factor, per_call, val_flags, subs in (
            ("raft", 8, dict(fused_corr_lookup=24, instance_norm=15),
             ["--evaluate_matched_unmatched", "--with_speed_metric",
              "--count_time"], ("sintel", "kitti")),
            ("gmflow", 16, dict(flash=14, instance_norm=15),
             ["--count_time"], ("kitti",))):
        gen = torch.Generator().manual_seed(20)
        model = RAFT(corr_impl="fused", dtype=torch.bfloat16, generator=gen) \
            if model_name == "raft" else GMFlow(dtype=torch.bfloat16,
                                                generator=gen)
        ckpt = os.path.join(tmp, f"{model_name}.pth")
        torch.save(model.state_dict(), ckpt)
        base = ["--model", model_name, "--ckpt", ckpt, "--data_root", root,
                "--padding_factor", str(factor)]

        calls.clear()
        zero_launch_counts()
        t = time.perf_counter()
        res = cli.main(base + ["--val", "sintel", "kitti"] + val_flags)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t
        got = launch_counts()
        n = len(calls)
        # (c) exact launch counts per validated pair (the 5 warm-up and 100
        # timed passes of --count_time, 3 Sintel and 3 KITTI pairs)
        want = want_launches(**{k: v * n for k, v in per_call.items()})
        print(f"  {model_name} --val sintel kitti {' '.join(val_flags)}: "
              f"{n} passes in {val_s:.1f} s; launches {got}", flush=True)
        if n != 5 + 100 + 3 + 3 or got != want:
            fail(f"{model_name} validation: {n} passes, launches {got}, want "
                 f"{want}")
        for key in launches:
            launches[key] += got[key]
        padded = sintel_pad[factor].pad(
            np.zeros((1,) + SINTEL + (3,), np.float32))[0].shape
        if any(c["shape"] != padded for c in calls[:108]) or not all(
                np.isfinite(c["flow"]).all() for c in calls):
            fail(f"{model_name}: Sintel passes not of the padded shape "
                 f"{padded}, or non-finite flows")
        # (a) the validators' numbers against a numpy recomputation from
        # the flows the infer_fn returned, within 1e-6 relative
        want_m = expected_metrics(
            [sintel_pad[factor].unpad(c["flow"])[0] for c in calls[105:108]],
            [kitti_pad[factor].unpad(c["flow"])[0] for c in calls[108:111]],
            gt, model_name == "raft")
        worst = max(abs(res[k] - v) / max(abs(v), 1e-12)
                    for k, v in want_m.items())
        print(f"  {model_name} metrics: " + ", ".join(
            f"{k} {v:.6g}" for k, v in res.items()), flush=True)
        check(f"  (a) {len(want_m)} metrics vs the numpy recomputation, "
              "relative", worst, 1e-6)
        if set(res) - set(want_m) != {"inference_time_ms"}:
            fail(f"{model_name}: metrics {sorted(res)}, recomputed "
                 f"{sorted(want_m)}")

        # (d) the submissions: names, unpadded shapes, the flows written
        for sub in subs:
            out_dir = os.path.join(tmp, f"{model_name}_{sub}_submission")
            calls.clear()
            zero_launch_counts()
            cli.main(base + ["--submission", sub, "--output_path", out_dir]
                     + (["--warm_start"] if sub == "sintel" else []))
            got = launch_counts()
            want = want_launches(**{k: v * len(calls)
                                    for k, v in per_call.items()})
            if got != want:
                fail(f"{model_name} {sub} submission launches {got}, want "
                     f"{want}")
            for key in launches:
                launches[key] += got[key]
            if sub == "sintel":
                names = [f"{d}/{s}/frame{i:04d}.flo"
                         for d in ("clean", "final")
                         for s, n_pairs in (("alley_9", 2), ("bandage_9", 1))
                         for i in range(1, n_pairs + 1)]
                inits = [c["init"] for c in calls]
                if inits != [False, True, False] * 2:
                    fail(f"warm start: flow_init given {inits}, want "
                         "[False, True, False] x 2")
                for name, c in zip(names, calls):
                    flo = frame_io.read_flo(os.path.join(out_dir, name))
                    if not np.array_equal(
                            flo, sintel_pad[factor].unpad(c["flow"])[0]):
                        fail(f"sintel submission {name}: {flo.shape}, not "
                             "the flow the model returned")
            else:
                names = ["000000_10.png", "000001_10.png"]
                for name, c in zip(names, calls):
                    flow, valid = frame_io.read_flow_kitti(
                        os.path.join(out_dir, name))
                    # the format holds (png - 2^15) / 64 for png in [0,
                    # 65535]: the writer clips to that range (as the JAX
                    # package's does), then truncates to 1/64 px
                    want_f = np.clip(kitti_pad[factor].unpad(c["flow"])[0],
                                     -2 ** 15 / 64, (65535 - 2 ** 15) / 64)
                    d = np.abs(flow - want_f).max()
                    if flow.shape != KITTI_SIZE + (2,) \
                            or not (valid == 1).all() or d > 1 / 64:
                        fail(f"kitti submission {name}: {flow.shape}, max "
                             f"|d| {d:.3e} px")
            found = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                           for d, _, fs in os.walk(out_dir) for f in fs)
            if found != sorted(names) or len(calls) != len(names):
                fail(f"{model_name} {sub} submission wrote {found}, want "
                     f"{sorted(names)}")
            print(f"  (d) {model_name} --submission {sub}"
                  f"{' --warm_start' if sub == 'sintel' else ''}: "
                  f"{len(names)} files, unpadded, the flows the model "
                  f"returned (KITTI within 1/64 px, clipped to +-512 px); "
                  f"launches {got}",
                  flush=True)

        # times: inference at Sintel (the CLI's --count_time) and KITTI
        # size, 5 warm-up and 20 timed passes of the padded pair, host
        # clock, each ending in the copy of the flow to the host; and the
        # validation of 3 pairs per dataset
        infer = factories[model_name](model)
        pair = [np.random.default_rng(21).uniform(
            0, 255, KITTI_SIZE + (3,)).astype(np.float32) for _ in range(2)]
        for _ in range(5):
            V._run_padded(infer, *pair, "kitti", factor)
        t = time.perf_counter()
        for _ in range(20):
            V._run_padded(infer, *pair, "kitti", factor)
        kitti_ms = (time.perf_counter() - t) / 20 * 1e3
        per_pair = {}
        for name in ("sintel", "kitti"):
            t = time.perf_counter()
            V.VALIDATORS[name](infer, root=root, padding_factor=factor)
            per_pair[name] = (time.perf_counter() - t) / 3 * 1e3
        print(f"  {model_name} inference_time_ms: Sintel "
              f"{res['inference_time_ms']:.3f} (--count_time, 100 passes), "
              f"KITTI {kitti_ms:.3f} (20 passes); ms per validated pair "
              f"(reading, inference, metrics): Sintel {per_pair['sintel']:.3f}"
              f", KITTI {per_pair['kitti']:.3f}", flush=True)
    infer_mod.raft_infer_fn = factories["raft"]
    infer_mod.gmflow_infer_fn = factories["gmflow"]
    return launches


# --------------------------------------------------------------------------
# phases 3h, 14 and 15: the synthesis engine
# --------------------------------------------------------------------------

SYNTH = (384, 512)                 # the synthesis CLI's default size
WARP_CASES = ("zero", "translation", "i.i.d. +-20 px",
              "rotation off the image", "four targets", "constant depth",
              "collisions")


def warp_inputs(gen, b, c, h, w, case):
    """Seeded obj [B, C, H, W], flow [B, 2, H, W] and depth [B, 1, H, W],
    made on the generator's device, for one of ``WARP_CASES``."""
    import math

    import torch
    dev = gen.device
    obj = torch.randn(b, c, h, w, generator=gen, device=dev)
    depth = torch.rand(b, 1, h, w, generator=gen, device=dev) * 99 + 1
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    if case == "zero":
        flow = torch.zeros(b, 2, h, w, device=dev)
    elif case == "translation":         # a permutation of the kept part
        flow = torch.stack([torch.full((h, w), 7.0, device=dev),
                            torch.full((h, w), -3.0, device=dev)])
    elif case == "rotation off the image":
        # 25 degrees about a pivot right of and above the image: whole
        # regions clamp onto the border column and row
        cx, cy, t = 1.9 * w, -0.7 * h, math.radians(25.0)
        x1 = (xx - cx) * math.cos(t) - (yy - cy) * math.sin(t) + cx
        y1 = (xx - cx) * math.sin(t) + (yy - cy) * math.cos(t) + cy
        flow = torch.stack([x1 - xx, y1 - yy])
    elif case == "four targets":        # every pixel onto one of 4
        flow = torch.stack([(xx % 2) * (w // 2) - xx,
                            (yy % 2) * (h // 2) - yy])
    else:
        flow = (torch.rand(b, 2, h, w, generator=gen, device=dev) * 2 - 1) \
            * 20
    flow = flow.expand(b, 2, h, w).contiguous()
    if case == "constant depth":        # raster-order ties everywhere
        depth.fill_(42.0)
        flow = flow.round()
    elif case == "collisions":          # depths >= 1000: hit, no write
        depth[torch.rand(depth.shape, generator=gen, device=dev) < 0.4] = \
            1000.0
        depth[torch.rand(depth.shape, generator=gen, device=dev) < 0.1] = \
            5000.0
    return obj, flow, depth


def reversed_tie_inputs(obj, flow, depth):
    """The planted fault's inputs: the sources in reverse raster order
    with flows that keep each one's target (x + (t + 0.5 - x) is exact),
    so the kernel's smallest index is the largest of the original ones:
    the tie-break reversed."""
    import torch
    b, c, h, w = obj.shape
    n = h * w
    yy, xx = torch.meshgrid(torch.arange(h, device=obj.device),
                            torch.arange(w, device=obj.device),
                            indexing="ij")
    p0 = torch.stack([xx, yy]).float()
    tx = torch.clamp(p0[0] + flow[:, 0], 0, w - 1).floor()
    ty = torch.clamp(p0[1] + flow[:, 1], 0, h - 1).floor()
    rev = lambda t: t.reshape(*t.shape[:2], n).flip(-1).reshape(t.shape)
    tgt = rev(torch.stack([tx, ty], 1)) + 0.5
    return rev(obj), (tgt - p0).contiguous(), rev(depth)


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def warp_bound_ms(b, c, h, w) -> float:
    """The warp's bound: its inputs read once (obj, flow, depth: C + 3
    planes) and its outputs written once (out, valid, collision: C + 2),
    f32, at the card's memory rate."""
    return b * h * w * 4 * ((c + 3) + (c + 2)) / HBM_BYTES_PER_S * 1e3


def forward_warp_phase(log: str = ""):
    import torch
    from opticalflowfromdepth_torch.ops import forward_warp as fw

    print("[3h] forward warp: CUDA kernel vs plain, bit for bit", flush=True)
    for line in log.splitlines():     # ptxas -v of the kernel
        if "registers" in line or "spill" in line:
            print(f"  warp_kernel: {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(31)
    n_cases = 0
    for (h, w) in (SYNTH, (33, 17)):
        for b in (1, 15):
            for c in (7, 6, 4, 2):
                for case in WARP_CASES:
                    obj, flow, depth = warp_inputs(gen, b, c, h, w, case)
                    before = fw.forward_warp.launches
                    got = fw.forward_warp(obj, flow, depth)
                    torch.cuda.synchronize()
                    if fw.forward_warp.launches != before + 1:
                        fail(f"forward warp [{b},{c},{h},{w}] {case}: the "
                             "wrapper did not launch its kernel")
                    ref = fw.forward_warp_plain(obj, flow, depth)
                    for g, r, what in zip(got, ref, ("out", "valid",
                                                     "collision")):
                        if not same_bits(g, r):
                            fail(f"forward warp [{b},{c},{h},{w}] {case}: "
                                 f"{what} differs from the plain version in "
                                 f"{int((g != r).sum())} values")
                    if case == "translation":   # (7, -3): away from the
                        # rows and columns that clamping piles up, a shift
                        if not torch.equal(got[0][..., 1:h - 3, 7:w - 1],
                                           obj[..., 4:, 0:w - 8]) or \
                                int(got[1].sum()) != b * (h - 3) * (w - 7):
                            fail(f"forward warp [{b},{c},{h},{w}]: the "
                                 "translation is not a permutation")
                    if case == "four targets" and int(got[1].sum()) != 4 * b:
                        fail("forward warp: four targets, valid "
                             f"{int(got[1].sum())}")
                    if case == "collisions" and not got[2].any():
                        fail("forward warp: no collision marked")
                    n_cases += 1
    print(f"  {n_cases} cases ({len(WARP_CASES)} flows at B = 1 and 15, C = "
          f"7, 6, 4 and 2, {SYNTH[0]}x{SYNTH[1]} and 33x17): out, valid and "
          "collision bit-equal to the plain version", flush=True)

    c, (h, w) = 6, SYNTH
    inputs = {(b, case): warp_inputs(gen, b, c, h, w, case)
              for b in (15, 1)
              for case in ("i.i.d. +-20 px", "rotation off the image",
                           "four targets", "constant depth")}
    first = fw.forward_warp(*inputs[15, "i.i.d. +-20 px"])
    again = fw.forward_warp(*inputs[15, "i.i.d. +-20 px"])
    if not all(same_bits(x, y) for x, y in zip(first, again)):
        fail("forward warp: two launches on the same inputs differ")
    # back to back on other inputs: each launch resets its own z-buffer
    pair = [fw.forward_warp(*inputs[15, case]) for case in
            ("rotation off the image", "four targets")]
    for got, case in zip(pair, ("rotation off the image", "four targets")):
        if not all(same_bits(x, y) for x, y in
                   zip(got, fw.forward_warp_plain(*inputs[15, case]))):
            fail(f"forward warp: {case} launched right after another "
                 "input differs from the plain version")
    ties = inputs[15, "constant depth"]
    ref = fw.forward_warp_plain(*ties)
    faulty = fw.forward_warp(*reversed_tie_inputs(*ties))
    n_bad = int((faulty[0] != ref[0]).any(1).sum())
    print(f"  two launches bit-equal, and two launches back to back on other "
          f"inputs each bit-equal; planted fault (the tie-break reversed: "
          f"the largest source index wins) changes {n_bad} of {15 * h * w} "
          "targets (must fail)", flush=True)
    if not all(same_bits(x, y) for x, y in zip(faulty[1:], ref[1:])) or \
            n_bad == 0:
        fail("forward warp: the planted tie-break fault is not caught")
    # the grouping's planted fault: each group of equal targets keeps its
    # largest key
    changed = {}
    for case in ("constant depth", "four targets", "rotation off the image"):
        args = inputs[15, case]
        bad = fw._forward_warp_cuda(*args, plant_fault=True)[0]
        changed[case] = int((bad != fw.forward_warp_plain(*args)[0])
                            .any(1).sum())
    print(f"  planted fault (a group's largest key wins) changes "
          f"{changed} targets (each must fail)", flush=True)
    if not all(changed.values()):
        fail(f"forward warp: the grouping's planted fault is not caught "
             f"{changed}")

    times = {}
    for (b, case), args in inputs.items():
        if case == "constant depth":
            continue
        obj, flow, depth = args
        ms = graph_ms(lambda: fw.forward_warp(obj, flow, depth))
        host_ms = cuda_ms(lambda: fw.forward_warp(obj, flow, depth))
        plain_ms = cuda_ms(lambda: fw.forward_warp_plain(obj, flow, depth),
                           reps=5)
        # the plain version's z-buffer pass alone: one scatter_reduce amin
        n, dev = h * w, flow.device
        p1 = torch.stack(torch.meshgrid(
            torch.arange(w, device=dev, dtype=torch.float32),
            torch.arange(h, device=dev, dtype=torch.float32),
            indexing="xy"))[None] + flow
        idx = (torch.arange(b, device=dev)[:, None] * n
               + (p1[:, 1].clamp(0, h - 1).long() * w
                  + p1[:, 0].clamp(0, w - 1).long()).reshape(b, n)
               ).reshape(-1)
        key = ((fw._sortable_u32(depth.reshape(b, n)) << 31)
               | torch.arange(n, device=dev)).reshape(-1)
        zbuf = torch.empty(b * n, dtype=torch.int64, device=dev)
        scatter_ms = graph_ms(lambda: zbuf.fill_(fw._EMPTY).scatter_reduce_(
            0, idx, key, "amin"))
        bound_ms = warp_bound_ms(b, c, h, w)
        print(f"  [{b},{c},{h},{w}] {case}: kernel {ms * 1e3:.1f} us "
              f"(device, one CUDA graph; a call from the host "
              f"{host_ms * 1e3:.1f} us), plain {plain_ms * 1e3:.1f} us, "
              f"its z-buffer pass alone (scatter_reduce amin) "
              f"{scatter_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us "
              f"(bytes: {bound_ms * HBM_BYTES_PER_S / 1e9:.1f} MB, inputs "
              f"and outputs once), {bound_ms / ms:.3f} of it", flush=True)
        times[b, case] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by="bytes", library_ms=None)
        del idx, key, zbuf, p1
    del inputs
    torch.cuda.empty_cache()
    return dict(name="forward_warp", route="cuda",
                source="opticalflowfromdepth_torch/csrc/forward_warp.cu",
                replaces="opticalflowfromdepth_tpu/ops/forward_warp.py:42",
                max_abs_err=0.0, **times[15, "i.i.d. +-20 px"])


def synth_source(seed: int, h: int, w: int, stereo: bool = False):
    """A smooth procedural image [3, H, W] in [0, 255] and its depth
    (through smooth_closer) or disparity [1, H, W], f32 numpy."""
    import numpy as np
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.clip(np.stack([np.sin(xx / (w / 9) + c + seed)
                            * np.cos(yy / (h / 7)) * 90 + 120
                            for c in range(3)])
                  + r.uniform(0, 20, (3, h, w)), 0, 255).astype(np.float32)
    if stereo:
        dep = 30 + 25 * np.sin(xx / (w / 6)) * np.cos(yy / (h / 5))
    else:
        dep = 1.0 / (255.0 - np.clip(120 + 60 * np.sin(xx / (w / 5) + seed)
                                     * np.cos(yy / (h / 4)), 0, 240))
    return img, dep[None].astype(np.float32)


def synth_parity_phase():
    import numpy as np
    import torch
    from opticalflowfromdepth_torch.ops import forward_warp as fw
    from opticalflowfromdepth_torch.synth import pipeline as sp

    h, w = 96, 128
    print(f"[14] synthesis {h}x{w}: card vs CPU (synthesize_sample_packed, "
          "same image, depth and draws)", flush=True)
    torch.set_num_threads(os.cpu_count() or 1)
    for stereo in (False, True):
        img, dep = synth_source(5, h, w, stereo)
        draws = sp.draw_sample(torch.Generator().manual_seed(7), h, w)
        cpu = sp.synthesize_sample_packed(torch.from_numpy(img),
                                          torch.from_numpy(dep), draws,
                                          stereo)
        before = fw.forward_warp.launches
        gpu = sp.synthesize_sample_packed(torch.from_numpy(img).cuda(),
                                          torch.from_numpy(dep).cuda(),
                                          draws, stereo)
        torch.cuda.synchronize()
        launches = fw.forward_warp.launches - before
        if launches != sp.warps_per_image():
            fail(f"synthesis on the card launched the warp {launches} "
                 f"times, want {sp.warps_per_image()}")
        worst = 0.0
        parts = []
        for k, ref in cpu.items():
            got = gpu[k].cpu()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                fail(f"synthesis card vs CPU: {k} {got.shape} {got.dtype}, "
                     f"want {ref.shape} {ref.dtype}")
            g, r = got.float().numpy(), ref.float().numpy()
            # u8: 1 gray level; f16: one f16 step (1e-3 + 1e-3 |x|)
            tol = 1.0 if got.dtype == torch.uint8 else 1e-3 + 1e-3 * abs(r)
            bad = ~(np.abs(g - r) <= tol)
            share = float(bad.reshape(-1, h * w).any(0).mean()) \
                if bad.ndim > 1 else float(bad.mean())
            worst = max(worst, share)
            parts.append(f"{k} {100 * share:.3f}% (max |d| "
                         f"{np.abs(g - r).max():.4g})")
        print(f"  {'DIML (disparity)' if stereo else 'ReDWeb (depth)'}: "
              f"{launches} warp launches; pixels beyond the tolerance: "
              + ", ".join(parts), flush=True)
        # the warp truncates its targets, so an f32 rounding of a flow
        # (cos/sin on the card) can move a pixel: at most 0.5% of them
        check("  share of pixels beyond 1 gray level / one f16 step",
              worst, 0.005)


def write_synth_trees(root: str, h: int = 480, w: int = 640) -> dict:
    """A fake ReDWeb tree of 4 procedural images (JPEG + 8-bit PNG
    closeness, by Pillow) and a DIML tree of one (PNG pair + 16-bit
    disparity by the port's ``write_png16``); their list files."""
    import numpy as np
    from PIL import Image
    from opticalflowfromdepth_torch.data.frame_io import write_png16
    lists = {}
    red = os.path.join(root, "ReDWeb")
    os.makedirs(os.path.join(red, "Imgs"))
    os.makedirs(os.path.join(red, "RDs"))
    for i in range(4):
        img, _ = synth_source(20 + i, h, w)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        close = np.clip(120 + 60 * np.sin(xx / 53 + i) * np.cos(yy / 41)
                        + 30 * np.sin(xx / 11), 0, 255).astype(np.uint8)
        Image.fromarray(np.moveaxis(img, 0, -1).astype(np.uint8)).save(
            os.path.join(red, "Imgs", f"r{i}.jpg"), quality=90)
        Image.fromarray(close).save(os.path.join(red, "RDs", f"r{i}.png"))
    lists["ReDWeb"] = os.path.join(root, "ReDWeb_list.txt")
    with open(lists["ReDWeb"], "w") as f:
        f.write("".join(f"r{i}.jpg\n" for i in range(4)))
    diml = os.path.join(root, "DIML", "train", "LR")
    for sub in ("outleft", "outright", "disparity"):
        os.makedirs(os.path.join(diml, sub))
    left, disp = synth_source(30, h, w, stereo=True)
    right, _ = synth_source(31, h, w)
    for sub, im in (("outleft", left), ("outright", right)):
        Image.fromarray(np.moveaxis(im, 0, -1).astype(np.uint8)).save(
            os.path.join(diml, sub, "d0.png"))
    # 16-bit disparity in the dataset's units (x 255/63 when read)
    write_png16(os.path.join(diml, "disparity", "d0.png"),
                np.round(disp[0] * 255 / 63 * 4).astype(np.uint16))
    lists["DIML"] = os.path.join(root, "DIML_list.txt")
    with open(lists["DIML"], "w") as f:
        f.write("d0.png\n")
    return lists


SHARD_KEYS = {"img0_1", "img1_1", "depth0_1", "depth1_1", "flow_1",
              "back_flow_1", "img0_2", "img1_2", "depth0_2", "depth1_2",
              "flow_2", "back_flow_2", "label"}


def check_shard(path: str, schedule) -> None:
    """One shard file's keys, dtypes, shapes, label and finite flows."""
    import numpy as np
    h, w = SYNTH
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    name = os.path.basename(path)
    if name.endswith("_group.npz"):
        if data["group"].shape != (44, h, w) or \
                data["group"].dtype != np.float16:
            fail(f"{name}: group {data['group'].shape}")
        return
    if set(data) != SHARD_KEYS:
        fail(f"{name}: keys {sorted(data)}")
    a = int(name.rsplit("_a", 1)[1].split(".")[0])
    if int(data["label"]) != schedule[a]:
        fail(f"{name}: label {int(data['label'])}, want {schedule[a]}")
    for k, v in data.items():
        want = ((np.uint8, (h, w, 3)) if k.startswith("img") else
                (np.float16, (h, w)) if k.startswith("depth") else
                (np.float16, (h, w, 2)) if "flow" in k else
                (np.int32, ()))
        if v.dtype != want[0] or v.shape != want[1]:
            fail(f"{name}: {k} {v.dtype} {v.shape}, want {want}")
        if "flow" in k and not np.isfinite(v).all():
            fail(f"{name}: {k} not finite")


def synth_path_phase(tmp: str):
    import functools
    import math
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from opticalflowfromdepth_torch.data.datasets import (AugmentedShards,
                                                         ConcatDataset)
    from opticalflowfromdepth_torch.data.loader import Loader, to_device
    from opticalflowfromdepth_torch.data.source import SOURCES, _resize_chw
    from opticalflowfromdepth_torch.ops import forward_warp as fw
    from opticalflowfromdepth_torch.data import native_io
    from opticalflowfromdepth_torch.synth import cli
    from opticalflowfromdepth_torch.synth import pipeline as sp
    from opticalflowfromdepth_torch.synth import writer as sw
    from opticalflowfromdepth_torch.train import raft_train as rt

    h, w = SYNTH
    print(f"[15] synthesis path: synth.cli at {h}x{w} from fake ReDWeb (4 "
          "images) and DIML (1) trees of 480x640, 1 epoch; the shards "
          "through AugmentedShards into RAFT-basic training", flush=True)
    lists = write_synth_trees(tmp)
    outs = {d: os.path.join(tmp, "shards", d) for d in ("ReDWeb", "DIML")}
    plain_calls = [0]
    real_plain = fw.forward_warp_plain

    def counting_plain(*args):
        plain_calls[0] += 1
        return real_plain(*args)

    fw.forward_warp_plain = counting_plain    # the card path must not call it
    real_writer = sw.ShardWriter
    writers = []

    def recording_writer(*args, **kw):        # the CLI's default writer
        writers.append(real_writer(*args, **kw))
        return writers[-1]
    sw.ShardWriter = recording_writer
    zero_launch_counts()
    results = {}
    try:
        for dataset, n_img in (("ReDWeb", 4), ("DIML", 1)):
            before = launch_counts()["forward_warp"]
            results[dataset] = cli.main([
                "--dataset", dataset,
                "--data_root", os.path.join(tmp, dataset),
                "--list_file", lists[dataset], "--out", outs[dataset],
                "--epochs", "1", "--height", str(h), "--width", str(w)])
            got = launch_counts()["forward_warp"] - before
            if got != n_img * sp.warps_per_image():
                fail(f"{dataset}: {got} warp launches for {n_img} images, "
                     f"want {n_img * sp.warps_per_image()}")
    finally:
        fw.forward_warp_plain = real_plain
        sw.ShardWriter = real_writer
    launches = launch_counts()
    if len(writers) != 2 or any(wr.enc is None or wr.enc.blobs >=
                                wr.enc.entries for wr in writers):
        fail("[15] the CLI did not write through the native encoder")
    print(f"  the CLI's writers: the native encoder, blobs / entries "
          f"{[(wr.enc.blobs, wr.enc.entries) for wr in writers]}",
          flush=True)
    if launches != want_launches(forward_warp=5 * sp.warps_per_image()):
        fail(f"synthesis launch counts {launches}")
    if plain_calls[0]:
        fail(f"the card's synthesis ran forward_warp_plain {plain_calls[0]} "
             "times")
    print(f"  launches over 5 images: {launches} ({sp.warps_per_image()} an "
          "image; forward_warp_plain never called)", flush=True)

    # the same 5 images through the Python writer (use_native=False), after
    # the counts were read: each file of the two trees must hold equal arrays
    outs_py = {d: os.path.join(tmp, "shards_py", d) for d in outs}
    results_py = {}
    sw.ShardWriter = functools.partial(real_writer, use_native=False)
    try:
        for dataset in outs:
            results_py[dataset] = cli.main([
                "--dataset", dataset,
                "--data_root", os.path.join(tmp, dataset),
                "--list_file", lists[dataset], "--out", outs_py[dataset],
                "--epochs", "1", "--height", str(h), "--width", str(w)])
    finally:
        sw.ShardWriter = real_writer
    t = time.perf_counter()
    pairs = [(os.path.join(outs[d], f), os.path.join(outs_py[d], f))
             for d in outs for f in sorted(os.listdir(outs[d]))]
    if sorted(os.path.basename(b) for _, b in pairs) != sorted(
            f for d in outs_py.values() for f in os.listdir(d)):
        fail("[15] the native and the Python writers wrote other files")

    def same_file(pair):
        a = native_io.load_npz(pair[0])      # the codec on the native tree,
        with np.load(pair[1]) as z:          # numpy on the Python one
            b = {k: z[k] for k in z.files}
        return sorted(a) == sorted(b) and all(
            a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            and np.array_equal(a[k], b[k]) for k in a)
    with ThreadPoolExecutor(8) as pool:
        differ = [p[0] for p, ok in zip(pairs, pool.map(same_file, pairs))
                  if not ok]
    if differ:
        fail(f"[15] native and Python shards differ: {differ[:3]}")
    print(f"  the same 5 images through the Python writer (use_native="
          f"False): {len(pairs)} files, each holding arrays equal to the "
          f"native writer's (dtype, shape, values; checked in "
          f"{time.perf_counter() - t:.1f} s)", flush=True)
    for label, res in (("native", results), ("python", results_py)):
        for dataset, r in res.items():
            n = r["images"]
            print(f"  writer {label}, {dataset}: {n / r['seconds']:.3f} "
                  f"images/s; write {r['write_s'] / n:.3f} s an image (its "
                  f"4 threads, summed), the CLI waited "
                  f"{r['write_wait_s'] / n:.3f} s an image", flush=True)
    shutil.rmtree(os.path.join(tmp, "shards_py"))

    files = sorted(os.path.join(out, f) for out in outs.values()
                   for f in os.listdir(out))
    stems = {}
    for f in files:
        stem = os.path.basename(f).rsplit("_g", 1)[0] \
            if "_group" not in f else os.path.basename(f)[:-10]
        stems[stem] = stems.get(stem, 0) + 1
    if len(stems) != 5 or set(stems.values()) != {61}:
        fail(f"files per image: {stems}")
    t = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda f: check_shard(f, sp.AUGMENT_SCHEDULE), files))
    print(f"  {len(files)} files, 61 an image: keys, dtypes, shapes, labels "
          f"(AUGMENT_SCHEDULE) and finite flows checked in "
          f"{time.perf_counter() - t:.1f} s; "
          f"{sum(os.path.getsize(f) for f in files) / 2 ** 20:.0f} MiB",
          flush=True)
    for dataset, r in results.items():
        n = r["images"]
        print(f"  {dataset}: {n} images in {r['seconds']:.3f} s (host "
              f"clock), {n / r['seconds']:.3f} images/s; ms per image: "
              f"synthesis {np.mean(r['synth_ms']):.3f} (device, CUDA "
              f"events; {[round(x, 3) for x in r['synth_ms']]}), "
              f"device->host {np.mean(r['d2h_ms']):.3f} (host clock, "
              f"overlapping the next image), write "
              f"{r['write_s'] * 1e3 / n:.3f} (the writer's 4 threads, "
              f"summed), of which the CLI waited "
              f"{r['write_wait_s'] * 1e3 / n:.3f}", flush=True)

    # one image at full size, alone: host clock, then a profile
    src = SOURCES["ReDWeb"](os.path.join(tmp, "ReDWeb"), lists["ReDWeb"])[0]
    img = torch.from_numpy(_resize_chw(src.img0, (h, w))).cuda()
    dep = torch.from_numpy(_resize_chw(src.depth_or_disp, (h, w))).cuda()
    draws = sp.draw_sample(torch.Generator().manual_seed(12345), h, w)

    def one_image():
        return sp.synthesize_sample_packed(img, dep, draws)
    one_image()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        one_image()
    torch.cuda.synchronize()
    image_ms = (time.perf_counter() - t) * 1e3 / 3
    torch.cuda.reset_peak_memory_stats()
    # the CLI overlaps an image's copy and write with the next image's
    # synthesis only if the synthesis never waits for the card
    def waits(run):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return [str(x.message) for x in seen     # not the mode's own note
                if "synchroniz" in str(x.message).lower()
                and "prototype" not in str(x.message)]
    if not waits(lambda: dep.sum().item()):     # the detector sees one
        fail("the synchronization detector missed a .item()")
    syncs = waits(one_image)
    torch.cuda.synchronize()
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):     # the ATen ops an image takes
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            CountOps.n += 1
            return func(*args, **(kwargs or {}))
    with CountOps():
        one_image()
    torch.cuda.synchronize()
    print(f"  one image's synthesis alone: {image_ms:.3f} ms (host clock, "
          f"synchronized, mean of 3); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"{CountOps.n} ATen ops dispatched; {len(syncs)} waits for the "
          "card while enqueuing it", flush=True)
    if syncs:
        fail(f"one image's synthesis waits for the card: {syncs[:3]}")
    profile(one_image, image_ms, "image")

    # the image's warps, recorded from one more image and replayed one by
    # one: device time summed, beside the bound
    recorded = []
    launch = fw._forward_warp_cuda

    def recording(obj, flow, depth, **kw):
        recorded.append(tuple(t.contiguous().clone()
                              for t in (obj, flow, depth)))
        return launch(obj, flow, depth, **kw)

    fw._forward_warp_cuda = recording
    try:
        one_image()
    finally:
        fw._forward_warp_cuda = launch
    torch.cuda.synchronize()
    if len(recorded) != sp.warps_per_image():
        fail(f"one image recorded {len(recorded)} warps, want "
             f"{sp.warps_per_image()}")
    for args in recorded:
        if not all(same_bits(x, y) for x, y in
                   zip(fw.forward_warp(*args), fw.forward_warp_plain(*args))):
            fail(f"forward warp {tuple(args[0].shape)} of the image differs "
                 "from the plain version")
    warp_ms = [graph_ms(lambda: fw.forward_warp(*args)) for args in recorded]
    bound_ms = sum(warp_bound_ms(*args[0].shape) for args in recorded)
    shapes = {}
    for args in recorded:
        shapes[tuple(args[0].shape)] = shapes.get(tuple(args[0].shape), 0) + 1
    print(f"  the image's {len(recorded)} warps ({shapes}), each bit-equal to "
          f"the plain version, replayed one by one (device time, one CUDA "
          f"graph each), summed: kernel {sum(warp_ms) * 1e3:.1f} us; bound "
          f"{bound_ms * 1e3:.1f} us ({bound_ms / sum(warp_ms):.3f} of it); "
          f"B = 1: "
          f"{sum(t for t, a in zip(warp_ms, recorded) if len(a[0]) == 1) * 1e3:.1f}"
          f" us, B = 15: "
          f"{sum(t for t, a in zip(warp_ms, recorded) if len(a[0]) > 1) * 1e3:.1f}"
          " us", flush=True)
    del recorded

    # the shards into training: AugmentedShards -> Loader -> 3 RAFT steps
    b, (ch, cw), iters = TRAIN_BATCH, TRAIN_CROP, TRAIN_ITERS
    loader = Loader(ConcatDataset([AugmentedShards(o, crop_size=TRAIN_CROP,
                                                   seed=0)
                                   for o in outs.values()]),
                    batch_size=b, num_workers=4, seed=0)
    cfg = rt.RAFTTrainConfig(batch_size=b, image_size=TRAIN_CROP,
                             iters=iters, mixed_precision=True,
                             corr_impl="fused", add_classifier=True)
    step = rt.make_train_step(cfg, seeded_classifier(4, torch.bfloat16))
    state = rt.init_state(cfg, seed=0)
    tgen = torch.Generator(device="cuda").manual_seed(0)
    losses = []
    batches = iter(loader)
    for _ in range(3):
        batch = to_device(next(batches), "cuda")
        state, m = step(state, batch, tgen)
        losses.append(float(m["total_loss"]))
    batches.close()
    if not all(math.isfinite(x) for x in losses):
        fail(f"training on synthesized shards: loss {losses}")
    print(f"  3 RAFT-basic steps (bf16, fused correlation, batch {b} of "
          f"{ch}x{cw} crops) on the synthesized shards: losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    return launches, outs


# --------------------------------------------------------------------------
# phase 16: the training CLI
# --------------------------------------------------------------------------

PLAIN_VERSIONS = (("fused_corr", "fused_corr_lookup_cat_plain"),
                  ("fused_corr", "fused_corr_lookup_cat_bwd_plain"),
                  ("instance_norm", "instance_norm_plain"),
                  ("flash", "flash_softmax_matmul_plain"),
                  ("flash_bwd", "flash_backward_plain"),
                  ("conv2d", "conv3x3_s1_plain"),
                  ("forward_warp", "forward_warp_plain"))


class PlainCalls:
    """Counts the calls of every kernel's plain version while it is
    entered (a path on the card must make none)."""

    def __enter__(self):
        import importlib
        self.calls = {}
        self.saved = []
        for mod, name in PLAIN_VERSIONS:
            m = importlib.import_module(f"opticalflowfromdepth_torch.ops."
                                        f"{mod}")
            real = getattr(m, name)
            self.saved.append((m, name, real))
            self.calls[name] = 0

            def counting(*args, _real=real, _name=name, **kw):
                self.calls[_name] += 1
                return _real(*args, **kw)
            setattr(m, name, counting)
        return self

    def __exit__(self, *exc):
        for m, name, real in self.saved:
            setattr(m, name, real)

    def check(self, what: str) -> None:
        if any(self.calls.values()):
            fail(f"{what}: plain versions called {self.calls}")


class FlashRoutes:
    """Counts the flash forward's launches by route while entered
    (``ops/flash.py:launcher`` names each call's route)."""

    def __enter__(self):
        from opticalflowfromdepth_torch.ops import flash as fl
        self.fl, self.real, self.routes = fl, fl.launcher, {}

        def counting(*args, **kw):
            res = self.real(*args, **kw)
            self.routes[res[2].route] = self.routes.get(res[2].route, 0) + 1
            return res
        fl.launcher = counting
        return self

    def __exit__(self, *exc):
        self.fl.launcher = self.real

    def check(self, what: str, want: dict) -> None:
        print(f"  the flash forward's routes: {self.routes}", flush=True)
        if self.routes != want:
            fail(f"{what}: flash forward routes {self.routes}, want {want}")


# the flash forward's kernels in a profile: the wgmma route's (both widths)
# and the mma.sync route's
FLASH_FWD_NAMED = [("the flash forward's wgmma kernels", ("flash_fwd_wgmma",)),
                   ("the flash forward's mma.sync kernels",
                    ("flash_fwd_bf16",))]


def train_cli_phase(tmp: str, outs: dict) -> None:
    import math

    import numpy as np
    import torch
    from opticalflowfromdepth_torch.data.datasets import fetch_train_dataset
    from opticalflowfromdepth_torch.data.loader import Loader
    from opticalflowfromdepth_torch.eval.cli import load_state_dict
    from opticalflowfromdepth_torch.eval.infer import raft_infer_fn
    from opticalflowfromdepth_torch.models.raft import RAFT
    from opticalflowfromdepth_torch.train import cli
    from opticalflowfromdepth_torch.train import raft_train as rt
    from opticalflowfromdepth_torch.train.state import save_weights

    b, (ch, cw), iters = TRAIN_BATCH, TRAIN_CROP, TRAIN_ITERS
    print(f"[16] training CLI: train.cli --model raft --stage mixed on "
          f"[15]'s ReDWeb and DIML shards (re-augmented), the frozen "
          f"classifier from a .pth; the defaults: RAFT-basic, batch {b} of "
          f"{ch}x{cw}, {iters} iters, bf16", flush=True)
    ckpt = save_weights(tmp, seeded_classifier(4, torch.float32),
                        "classifier")
    log_dir = os.path.join(tmp, "cli_run")
    common = ["--stage", "mixed", "--redweb_shards", outs["ReDWeb"],
              "--diml_shards", outs["DIML"], "--add_classifier",
              "--classifier_ckpt", ckpt]
    record = {"stamps": [], "losses": []}
    real_make = rt.make_train_step

    def recording_make(cfg, classifier=None, device="cuda", mesh=None):
        step = real_make(cfg, classifier, device, mesh)
        record.update(step=step, cfg=cfg)

        def recorded(state, batch, gen):
            state, m = step(state, batch, gen)
            record["losses"].append(float(m["total_loss"]))   # waits
            record["stamps"].append(time.perf_counter())
            if len(record["stamps"]) == 1:          # after the warm-up step
                zero_launch_counts()
            record.update(batch=batch, gen=gen)
            return state, m
        return recorded

    timed = 5
    rt.make_train_step = recording_make
    try:
        with PlainCalls() as plain:
            zero_launch_counts()
            state = cli.main(common + [
                "--model", "raft", "--log_dir", log_dir,
                "--num_steps", str(1 + timed), "--save_latest_freq",
                str(1 + timed), "--save_ckpt_freq", str(1 + timed)])
            torch.cuda.synchronize()
            launches = launch_counts()
    finally:
        rt.make_train_step = real_make
    plain.check("the training CLI (RAFT)")
    want = want_launches(fused_corr_lookup=iters * timed,
                         fused_corr_lookup_bwd=iters * timed,
                         instance_norm=15 * timed)
    if launches != want:
        fail(f"training CLI launch counts {launches}, want {want}")
    losses = record["losses"]
    if state.step != 1 + timed or not all(map(math.isfinite, losses)):
        fail(f"training CLI: step {state.step}, losses {losses}")
    stamps = record["stamps"]
    per_step = [(y - x) * 1e3 for x, y in zip(stamps, stamps[1:])]
    step_ms = (stamps[-1] - stamps[0]) * 1e3 / timed
    print(f"  launches over the {timed} steps after the warm-up: "
          f"{launches}; plain versions called 0 times", flush=True)
    print(f"  losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"  ms per step (host clock, loss read each step): {step_ms:.3f} "
          f"over {timed} steps ({[round(x, 3) for x in per_step]}); "
          f"{b * 1e3 / step_ms:.3f} pairs/s", flush=True)
    for f in ("args.json", "checkpoints/latest.pth",
              f"checkpoints/step_{1 + timed}_weights.pth"):
        if not os.path.exists(os.path.join(log_dir, f)):
            fail(f"training CLI wrote no {f}")
    if not any(f.endswith("_parameters") for f in os.listdir(log_dir)):
        fail("training CLI wrote no _parameters sidecar")

    # the step alone, on the last batch (resident)
    step, batch, gen = record["step"], record["batch"], record["gen"]
    step(state, batch, gen)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(timed):
        step(state, batch, gen)
    torch.cuda.synchronize()
    alone_ms = (time.perf_counter() - t) * 1e3 / timed
    # the input pipeline alone: the mixed stage re-augmented, 4 threads
    ds = fetch_train_dataset("mixed", TRAIN_CROP, shards_root={
        "redweb": outs["ReDWeb"], "diml": outs["DIML"]}, seed=1)
    it = iter(Loader(ds, batch_size=b, num_workers=4, seed=1))
    next(it)
    t = time.perf_counter()
    for _ in range(4):
        host = next(it)
    loader_ms = (time.perf_counter() - t) * 1e3 / 4
    it.close()
    t = time.perf_counter()
    for i in range(4):
        ds[i]
    sample_ms = (time.perf_counter() - t) * 1e3 / 4
    if host["image1"].shape != (b, ch, cw, 3) or not all(
            np.isfinite(host[k]).all() for k in ("flow", "valid")):
        fail(f"re-augmented batch {host['image1'].shape}")
    print(f"  the step alone on a resident batch: {alone_ms:.3f} ms; the "
          f"loader alone (mixed, re-augmented, 4 threads, batch {b}): "
          f"{loader_ms:.1f} ms per batch; one sample on this thread "
          f"{sample_ms:.1f} ms", flush=True)

    # --resume for 2 more steps, then the weights served
    state = cli.main(common + [
        "--model", "raft", "--log_dir", log_dir, "--num_steps",
        str(3 + timed), "--save_latest_freq", "2", "--save_ckpt_freq", "2",
        "--resume", os.path.join(log_dir, "checkpoints", "latest.pth")])
    if state.step != 3 + timed:
        fail(f"training CLI --resume ended at step {state.step}")
    serve = RAFT(corr_impl="fused", dtype=torch.bfloat16)
    serve.load_state_dict(load_state_dict(os.path.join(
        log_dir, "checkpoints", f"step_{3 + timed}_weights.pth")),
        strict=True)
    rng = np.random.default_rng(16)
    pair = [rng.uniform(0, 255, (1, ch, cw, 3)).astype(np.float32)
            for _ in range(2)]
    flow = raft_infer_fn(serve, iters=24, device="cuda")(*pair)
    if flow.shape != (1, ch, cw, 2) or not np.isfinite(flow).all():
        fail(f"served flow from the CLI's weights {flow.shape}")
    print(f"  --resume from latest (step {1 + timed}) to step {state.step}; "
          f"step_{state.step}_weights served one pair: |flow| max "
          f"{np.abs(flow).max():.3f} px", flush=True)

    # --model gmflow at full width: 2 steps
    gb = GM_BATCH
    with PlainCalls() as plain:
        zero_launch_counts()
        t = time.perf_counter()
        state = cli.main(common + [
            "--model", "gmflow", "--batch_size", str(gb), "--log_dir",
            os.path.join(tmp, "cli_gmflow"), "--num_steps", "2",
            "--save_latest_freq", "2", "--save_ckpt_freq", "2"])
        torch.cuda.synchronize()
        gm_s = time.perf_counter() - t
        launches = launch_counts()
    plain.check("the training CLI (GMFlow)")
    want = want_launches(flash=28, flash_bwd_dq=28, flash_bwd_dkv=28,
                         instance_norm=30)
    if launches != want or state.step != 2:
        fail(f"training CLI (GMFlow) launch counts {launches}, want {want}; "
             f"step {state.step}")
    print(f"  --model gmflow (full width, batch {gb} of {GM_CROP[0]}x"
          f"{GM_CROP[1]}, bf16): 2 steps in {gm_s:.1f} s with model set-up "
          f"(host clock); launches {launches} (14 + 14 + 14 flash and 15 "
          f"instance norms a step); plain versions called 0 times",
          flush=True)
    return {"step_ms": step_ms, "loader_ms": loader_ms, "alone_ms": alone_ms}


# --------------------------------------------------------------------------
# phase 19: the host's data plane, the bilateral filter, profiling
# --------------------------------------------------------------------------

def bilateral_depth(h: int, w: int, seed: int):
    """A smooth depth with two steps, 5% spikes and 3% zeros (holes)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 10 + 3 * np.sin(xx / 37) * np.cos(yy / 29)
    d[:, w // 2:] += 40
    d[h // 2:, : w // 3] = 5.0
    d += rng.uniform(0, 0.5, (h, w))
    d[rng.random((h, w)) < 0.05] *= 3
    d[rng.random((h, w)) < 0.03] = 0.0
    return d.astype(np.float32)


def host_data_phase(shards_12: str, cli_16: dict, profiling_7: dict,
                    codec_s: float, card: str) -> None:
    import ctypes
    import types

    import numpy as np
    import torch
    from opticalflowfromdepth_torch.data import datasets as dsm
    from opticalflowfromdepth_torch.data import native_io
    from opticalflowfromdepth_torch.data.loader import Loader
    from opticalflowfromdepth_torch.ops.bilateral import (
        sparse_bilateral_filtering)

    print(f"[19] the host's data plane, the bilateral filter, profiling "
          f"({card})", flush=True)
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    zlib_version = native_io._lib().zlibVersion
    zlib_version.restype = ctypes.c_char_p    # the zlib the codec linked
    print(f"  the codec (csrc/shardio.cc): {gxx.splitlines()[0]}; zlib "
          f"{zlib_version().decode()}; built in {codec_s:.2f} s (g++ -O3, "
          "at [2]; nan: built before)", flush=True)

    # [12]'s loader alone through the codec and through np.load, in turns
    def np_load(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def loader_ms(decoder: str) -> float:
        real = dsm.native_io
        if decoder == "np.load":
            dsm.native_io = types.SimpleNamespace(load_npz=np_load)
        try:
            it = iter(Loader(dsm.AugmentedShards(shards_12,
                                                 crop_size=GM_CROP, seed=1),
                             batch_size=GM_BATCH, num_workers=4, seed=1))
            next(it)
            t = time.perf_counter()
            for _ in range(4):
                batch = next(it)
            ms = (time.perf_counter() - t) * 1e3 / 4
            it.close()
        finally:
            dsm.native_io = real
        if batch["image1"].shape != (GM_BATCH,) + GM_CROP + (3,):
            fail(f"[19] loader batch {batch['image1'].shape}")
        return ms
    times = {"codec": [], "np.load": []}
    for decoder in ("codec", "np.load", "np.load", "codec"):
        times[decoder].append(loader_ms(decoder))
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"  [12]'s loader alone (16 shards of 384x576, deflated by "
          f"np.savez_compressed; batch {GM_BATCH} of {GM_CROP[0]}x"
          f"{GM_CROP[1]}, 4 threads), ms per batch: through the codec "
          f"{mean['codec']:.1f} ({[round(x, 1) for x in times['codec']]}), "
          f"through np.load {mean['np.load']:.1f} "
          f"({[round(x, 1) for x in times['np.load']]}): "
          f"{mean['codec'] / mean['np.load']:.3f}x; beside [16]: "
          f"{cli_16['step_ms']:.3f} ms per step, its loader alone "
          f"{cli_16['loader_ms']:.1f} ms a batch of {TRAIN_BATCH} "
          f"(re-augmented, through the codec), the step alone "
          f"{cli_16['alone_ms']:.3f} ms", flush=True)

    # the bilateral filter: the card against the CPU at 480x640, exact
    h, w = 480, 640
    depth = torch.from_numpy(bilateral_depth(h, w, seed=19))
    t = time.perf_counter()
    want = sparse_bilateral_filtering(depth)
    cpu_ms = (time.perf_counter() - t) * 1e3
    dev = depth.cuda()
    card_ms = cuda_ms(lambda: sparse_bilateral_filtering(dev), reps=10)
    got = sparse_bilateral_filtering(dev).cpu()
    changed = int((want != depth).sum())
    differ = int((got != want).sum())
    if differ or changed < 1000:
        fail(f"[19] bilateral filter: {differ} pixels of the card's differ "
             f"from the CPU's; {changed} changed")
    print(f"  sparse_bilateral_filtering (5, 5) at {h}x{w}: the card's "
          f"output equal to the CPU's at every pixel ({changed} pixels "
          f"filtered); {card_ms:.3f} ms on the card (CUDA events, mean of "
          f"10), {cpu_ms:.1f} ms on the CPU (host clock, one call)",
          flush=True)

    # utils.profiling around [7]
    s = profiling_7["timer"]
    host = profiling_7["host_ms"]
    if s.get("steps_timed") != 5 or abs(s["mean_ms"] - host) > 0.05 * host:
        fail(f"[19] StepTimer {s} against [7]'s {host:.3f} ms per step")
    print(f"  StepTimer over [7]'s 5 steps (fenced on the loss): mean "
          f"{s['mean_ms']:.3f} ms, p50 {s['p50_ms']:.3f}, p90 "
          f"{s['p90_ms']:.3f}, {s['frames_per_s']:.3f} pairs/s; [7]'s own "
          f"host clock {host:.3f} ms per step "
          f"({s['mean_ms'] / host:.4f}x)", flush=True)
    if (profiling_7["traces"] != 1 or profiling_7["trace_bytes"] == 0
            or profiling_7["annotated"] < 1 or profiling_7["kernels"] == 0):
        fail(f"[19] trace of one [7] step: {profiling_7}")
    print(f"  trace of one [7] step: one Chrome trace of "
          f"{profiling_7['trace_bytes']} bytes, {profiling_7['trace_events']}"
          f" events, {profiling_7['kernels']} of them kernels on the card, "
          f"the annotation 'ofd_train_step' {profiling_7['annotated']}x",
          flush=True)


# --------------------------------------------------------------------------
# phases 3i, 17 and 18: the parallel layer
# --------------------------------------------------------------------------

# [3i]'s shapes: name, (B, L, C, D, payload, grid width)
RING_SHAPES = (
    ("serving matching", (1, H8 * W8, 128, 2, "grid", W8)),
    ("training matching", (GM_BATCH, GH8 * GW8, 128, 2, "grid", GW8)),
    ("ragged L=1001", (2, 1001, 128, 2, "flow", 128)),
    ("ragged L=1001 D=128", (2, 1001, 128, 128, "normal", 128)),
)


def ring_fwd_bwd(fn, q, k, v, g, group):
    """``fn(q, k, v, group)`` forward and backward from ``g``: (out, [dq,
    dk, dv])."""
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = fn(qq, kk, vv, group)
    out.backward(g)
    return out.detach(), [t.grad for t in (qq, kk, vv)]


def f32_work(b, lq, lk, c, d):
    """Operations (forward, dq, dk/dv), exponentials and bytes (forward,
    dq, dk/dv) of one f32 flash call on [B, Lq, C] x [B, Lk, C | D]: the
    forward S and P.V; dq S, dP and dS.K; dk/dv S, dP, P^T.G and dS^T.Q.
    Each reads its inputs once (f32; the backward q, k, v, g, lse and
    delta) and writes its outputs once."""
    pairs = float(b * lq * lk)
    ins = 4 * (b * lq * c + b * lk * c + b * lk * d)
    ops = (2 * pairs * (c + d), 2 * pairs * (2 * c + d),
           2 * pairs * (2 * c + 2 * d))
    by = (ins + 4 * b * lq * (d + 1),
          ins + 4 * b * lq * (d + 2) + 4 * b * lq * c,
          ins + 4 * b * lq * (d + 2) + 4 * b * lk * (c + d))
    return ops, pairs, by


def ring_phase(gen):
    import torch
    import torch.nn.functional as F
    from opticalflowfromdepth_torch.ops import flash as fl
    from opticalflowfromdepth_torch.ops import flash_bwd as fb
    from opticalflowfromdepth_torch.parallel import sequence as sq

    print("[3i] the sequence-parallel ring on the card: ring_softmax_matmul "
          "over LocalRing(n), n = 1, 2, 4, f32 (the flash kernels' f32 "
          "routes), forward and backward", flush=True)
    merge = sq.merge_step

    def faulty_merge(out, lse, out_s, lse_s):
        # the step's output taken without its LSE correction
        new_out, new = merge(out, lse, out_s, lse_s)
        return new_out + out_s * (1 - torch.exp(lse_s - new))[..., None], new

    times = {}
    for name, (b, l, c, d, payload, grid_w) in RING_SHAPES:
        q, k, v = flash_inputs(gen, b, l, l, c, d, torch.float32, payload,
                               grid_w=grid_w)
        v = v.float()
        g = torch.randn(b, l, d, generator=gen).cuda()
        dense = ring_fwd_bwd(lambda a, bb, cc, _: fl.flash_softmax_matmul(
            a, bb, cc), q, k, v, g, None)
        tol = [1e-4 * float(v.abs().max())] + [
            1e-4 * float(t.abs().max()) for t in dense[1]]
        for n in (1, 2, 4):
            ring = sq.LocalRing(n)
            what = f"{name} [{b},{l},{c}]x[{b},{l},{d}] n={n}"
            torch.cuda.synchronize()
            zero_launch_counts()
            got = ring_fwd_bwd(sq.ring_softmax_matmul, q, k, v, g, ring)
            torch.cuda.synchronize()
            launches = launch_counts()
            want = want_launches(flash=n * n, flash_bwd_dq=n * n,
                                 flash_bwd_dkv=n * n)
            if launches != want:
                fail(f"[3i] {what}: launches {launches}, want {want}")
            again = ring_fwd_bwd(sq.ring_softmax_matmul, q, k, v, g, ring)
            if not all(torch.equal(a, r) for a, r in
                       zip([got[0]] + got[1], [again[0]] + again[1])):
                fail(f"[3i] {what}: two rings on the same inputs differ")
            plain = ring_fwd_bwd(sq.ring_softmax_matmul_plain, q, k, v, g,
                                 ring)
            for ref, against in ((plain, "the plain ring"),
                                 (dense, "one unsharded f32 flash call")):
                ratios = [float((a - r).abs().max()) / t for a, r, t in zip(
                    [got[0]] + got[1], [ref[0]] + ref[1], tol)]
                check(f"{what} vs {against}: |d| / tolerance (1e-4 of "
                      f"max|v| for out, of max|ref| for dq, dk, dv) out "
                      f"{ratios[0]:.3f}, dq {ratios[1]:.3f}, dk "
                      f"{ratios[2]:.3f}, dv", ratios[3], 1.0)
                check("  out, dq and dk |d| / tolerance", max(ratios[:3]),
                      1.0)
            if n > 1:
                sq.merge_step = faulty_merge
                try:
                    bad = sq.ring_softmax_matmul(q, k, v, ring)
                finally:
                    sq.merge_step = merge
                ratio = float((bad - dense[0]).abs().max()) / tol[0]
                print(f"    planted fault, a merge without the step's LSE "
                      f"correction: |d| / tolerance {ratio:.2f} (must "
                      f"exceed 1); two rings bit-equal; launches {n * n} "
                      f"forward, {n * n} dq, {n * n} dk/dv", flush=True)
                if not ratio > 1.0:
                    fail(f"[3i] {what}: the planted merge fault passes")
            del got, again, plain
            # times: the ring alone, forward and forward + backward
            t_f = cuda_ms(lambda: sq.ring_softmax_matmul(q, k, v, ring),
                          reps=3, warm=1)
            t_fb = cuda_ms(lambda: ring_fwd_bwd(sq.ring_softmax_matmul, q, k,
                                                v, g, ring), reps=3, warm=1)
            t_pfb = cuda_ms(lambda: ring_fwd_bwd(sq.ring_softmax_matmul_plain,
                                                 q, k, v, g, ring),
                            reps=2, warm=1)
            # one step's kernels alone at the step's shape (the longest
            # slices), each launched without the wrapper's casts; each also
            # on the CUDA-core route it had before (tf32x3)
            lq = -(-l // n)
            qs, ks, vs, gs = (t[:, :lq].contiguous() for t in (q, k, v, g))
            (out, lse), launch_f, fplan = fl.launcher(qs, ks, vs,
                                                      with_lse=True)
            _, old_f, _ = fl.launcher(qs, ks, vs, with_lse=True, route="f32")
            launch_f()
            _, launch_dq, launch_dkv, plan = fb.launchers(qs, ks, vs, out,
                                                          lse, gs)
            _, old_dq, old_dkv, _ = fb.launchers(qs, ks, vs, out, lse, gs,
                                                 route="f32")
            k_f = cuda_ms(launch_f, reps=3, warm=1)
            k_dq = cuda_ms(launch_dq, reps=3, warm=1)
            k_dkv = cuda_ms(launch_dkv, reps=3, warm=1)
            o_f = cuda_ms(old_f, reps=2, warm=1)
            o_dq = cuda_ms(old_dq, reps=2, warm=1)
            o_dkv = cuda_ms(old_dkv, reps=2, warm=1)
            ops, exps, by = f32_work(b, lq, lq, c, d)
            line = []
            for kn, t, t_old, o, x in (("forward", k_f, o_f, ops[0], by[0]),
                                       ("dq", k_dq, o_dq, ops[1], by[1]),
                                       ("dk/dv", k_dkv, o_dkv, ops[2],
                                        by[2])):
                b3, b1 = (bound_ms(o, exps, x, peak) for peak in
                          (TF32X3_FLOP_PER_S, FP32_FLOP_PER_S))
                line.append(
                    f"{kn} {t * 1e3:.1f} us ({o / t / 1e9:.2f} TFLOP/s, "
                    f"{b3[0] / t:.4f} of its split-TF32 bound "
                    f"{b3[0] * 1e3:.1f} us, {b1[0] / t:.4f} of its f32 "
                    f"bound {b1[0] * 1e3:.1f} us, {b1[1]}; before, the "
                    f"CUDA-core route: {t_old * 1e3:.1f} us)")
            print(f"    the f32 kernels at one step's shape [{b},{lq},{c}]"
                  f"x[{b},{lq},{d}] (forward {fplan.route}, key sweep in "
                  f"{fplan.splits}; backward {plan.route}, splits dq "
                  f"{plan.splits_dq}, dk/dv {plan.splits_dkv}): "
                  + "; ".join(line), flush=True)
            ring_ops = [o * n * n for o in f32_work(b, l / n, l / n, c, d)[0]]
            t_b = max(t_fb - t_f, 1e-6)
            print(f"    the ring: forward {t_f:.3f} ms, forward + backward "
                  f"{t_fb:.3f} ms (backward {t_b:.3f} ms; "
                  f"{ring_ops[0] / t_f / 1e9:.2f} and "
                  f"{(ring_ops[1] + ring_ops[2]) / t_b / 1e9:.2f} "
                  f"TFLOP/s); the plain ring forward + backward "
                  f"{t_pfb:.3f} ms", flush=True)
            times[(name, n)] = dict(fwd=t_f, fb=t_fb, plain_fb=t_pfb,
                                    k_fwd=k_f, k_dq=k_dq, k_dkv=k_dkv,
                                    old_fwd=o_f, old_dq=o_dq, old_dkv=o_dkv)
            del qs, ks, vs, gs, out, lse
            torch.cuda.empty_cache()
        # the library call for the whole f32 forward and its gradients
        qs, ks, vs = (t[:, None].detach().clone().requires_grad_()
                      for t in (q, k, v))
        lib_f = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs),
                        reps=3, warm=1)

        def lib_fb():
            F.scaled_dot_product_attention(qs, ks, vs).backward(g[:, None])
        lib_fb_ms = cuda_ms(lib_fb, reps=3, warm=1)
        o = F.scaled_dot_product_attention(qs, ks, vs)
        lib_b = cuda_ms(lambda: torch.autograd.grad(
            o, (qs, ks, vs), g[:, None], retain_graph=True), reps=3, warm=1)
        whole = times[(name, 1)]
        ops, exps, by = f32_work(b, l, l, c, d)
        print(f"  {name}: SDPA f32 (the library call) forward {lib_f:.3f} "
              f"ms, forward + backward {lib_fb_ms:.3f} ms, the backward "
              f"alone {lib_b:.3f} ms; the kernels' forward "
              f"{whole['k_fwd']:.3f} ms (before: {whole['old_fwd']:.3f} ms), "
              f"dq + dk/dv {whole['k_dq'] + whole['k_dkv']:.3f} ms (before: "
              f"{whole['old_dq'] + whole['old_dkv']:.3f} ms); unsharded f32 "
              f"bounds at {FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s: forward "
              f"{bound_ms(ops[0], exps, by[0], FP32_FLOP_PER_S)[0]:.3f} ms, "
              f"dq {bound_ms(ops[1], exps, by[1], FP32_FLOP_PER_S)[0]:.3f}, "
              f"dk/dv {bound_ms(ops[2], exps, by[2], FP32_FLOP_PER_S)[0]:.3f}"
              f"; at {TF32X3_FLOP_PER_S / 1e12:.0f} (split TF32): forward "
              f"{bound_ms(ops[0], exps, by[0], TF32X3_FLOP_PER_S)[0]:.3f}, dq "
              f"{bound_ms(ops[1], exps, by[1], TF32X3_FLOP_PER_S)[0]:.3f}, "
              f"dk/dv "
              f"{bound_ms(ops[2], exps, by[2], TF32X3_FLOP_PER_S)[0]:.3f} "
              f"({ops[0] / 1e9:.1f}, {ops[1] / 1e9:.1f}, {ops[2] / 1e9:.1f} "
              f"GFLOP)", flush=True)
        del q, k, v, g, dense, qs, ks, vs, o
        torch.cuda.empty_cache()
    return times


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def smooth_batch(seed, b, h, w):
    """A resident training batch on the card: ``b`` smooth image pairs, a
    noisy target, 90% valid, one-hot labels."""
    import numpy as np
    from opticalflowfromdepth_torch.data.loader import to_device
    rng = np.random.default_rng(seed)
    i1, i2 = smooth_pairs(rng, b, h, w)
    return to_device(dict(
        image1=i1, image2=i2,
        flow=rng.normal(0, 3, (b, h, w, 2)).astype(np.float32),
        valid=(rng.uniform(size=(b, h, w)) > 0.1).astype(np.float32),
        label=np.eye(4, dtype=np.float32)[rng.integers(0, 4, b)]), "cuda")


def data_parallel_phase():
    import torch
    import torch.distributed as dist
    from opticalflowfromdepth_torch.parallel import mesh as pm
    from opticalflowfromdepth_torch.train import gmflow_train as gt
    from opticalflowfromdepth_torch.train import raft_train as rt

    print(f"[17] data parallelism over NCCL at world size 1: 2 RAFT-basic "
          f"steps ([7]'s shape: batch {TRAIN_BATCH} of {TRAIN_CROP[0]}x"
          f"{TRAIN_CROP[1]}, {TRAIN_ITERS} iters, bf16, classifier, batch "
          f"norm live, add_noise) and 2 GMFlow steps ([12]'s: batch "
          f"{GM_BATCH} of {GM_CROP[0]}x{GM_CROP[1]}, bf16, classifier) "
          "through init_distributed() / make_mesh(), against the same steps "
          "with no process group: the parameters bit for bit", flush=True)
    raft_cfg = rt.RAFTTrainConfig(batch_size=TRAIN_BATCH,
                                  image_size=TRAIN_CROP, iters=TRAIN_ITERS,
                                  mixed_precision=True, corr_impl="fused",
                                  add_classifier=True, add_noise=True)
    gm_cfg = gt.GMFlowTrainConfig(batch_size=GM_BATCH, image_size=GM_CROP,
                                  mixed_precision=True, add_classifier=True)
    batches = {"raft": [smooth_batch(s, TRAIN_BATCH, *TRAIN_CROP)
                        for s in (20, 21)],
               "gmflow": [smooth_batch(s, GM_BATCH, *GM_CROP)
                          for s in (22, 23)]}

    def run(module, cfg, key, mesh):
        state = module.init_state(cfg, seed=0, mesh=mesh)
        step = module.make_train_step(cfg, seeded_classifier(
            4, torch.bfloat16), mesh=mesh)
        gen = torch.Generator(device="cuda").manual_seed(0)
        losses = []
        for b in batches[key]:
            state, m = step(state, b, gen)
            losses.append(float(m["total_loss"]))
        return ({k: v.clone() for k, v in state.model.state_dict().items()},
                losses)

    deterministic = torch.backends.cudnn.deterministic
    # cuDNN's own algorithms may add in another order from run to run;
    # every kernel of the port is deterministic
    torch.backends.cudnn.deterministic = True
    saved = {k: os.environ.get(k) for k in pm.ENV + ("LOCAL_RANK",)}
    try:
        ref = {"raft": run(rt, raft_cfg, "raft", None),
               "gmflow": run(gt, gm_cfg, "gmflow", None)}
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(
            free_port()), RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        device = pm.init_distributed()
        mesh = pm.make_mesh()
        print(f"  init_distributed() -> {device}, backend "
              f"{dist.get_backend()}, world {dist.get_world_size()}; mesh "
              f"data {mesh.data_rank}/{mesh.data_world}, model_parallel "
              f"{mesh.model_parallel}, distributed {mesh.distributed}",
              flush=True)
        if not (dist.get_backend() == "nccl" and mesh.distributed
                and device == torch.device("cuda", 0)):
            fail("[17] init_distributed did not join NCCL on cuda:0")
        zero_launch_counts()
        got = {"raft": run(rt, raft_cfg, "raft", mesh)}
        launches = launch_counts()
        want = want_launches(fused_corr_lookup=2 * TRAIN_ITERS,
                             fused_corr_lookup_bwd=2 * TRAIN_ITERS,
                             instance_norm=30)
        if launches != want:
            fail(f"[17] RAFT launches {launches}, want {want}")
        got["gmflow"] = run(gt, gm_cfg, "gmflow", mesh)
        for key in ("raft", "gmflow"):
            (p_ref, l_ref), (p_dp, l_dp) = ref[key], got[key]
            same = [k for k in p_ref if torch.equal(p_ref[k], p_dp[k])]
            print(f"  {key}: losses without a group {l_ref}, over NCCL "
                  f"{l_dp}; {len(same)} of {len(p_ref)} parameters and "
                  "buffers bit-equal", flush=True)
            if len(same) != len(p_ref):
                again = run(rt if key == "raft" else gt,
                            raft_cfg if key == "raft" else gm_cfg, key, None)
                repeat = all(torch.equal(again[0][k], p_ref[k])
                             for k in p_ref)
                fail(f"[17] {key}: the data-parallel steps differ from the "
                     f"steps without a group (the latter repeat bit for "
                     f"bit: {repeat})")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.backends.cudnn.deterministic = deterministic
    print("  process group destroyed", flush=True)


def sequence_parallel_phase(alone_12: float):
    import copy

    import numpy as np
    import torch
    from opticalflowfromdepth_torch.data.loader import to_device
    from opticalflowfromdepth_torch.models.gmflow import GMFlow
    from opticalflowfromdepth_torch.parallel.mesh import ProcessMesh
    from opticalflowfromdepth_torch.parallel.sequence import LocalRing
    from opticalflowfromdepth_torch.train import gmflow_train as gt

    print("[18] sequence-parallel GMFlow: model_parallel = 2 over "
          "LocalRing(2) (the ring for matching and propagation, and at "
          "splits 1 full attention, f32; the windows split in two)",
          flush=True)
    rng = np.random.default_rng(19)
    i1, i2 = smooth_pairs(rng, 2, 64, 96)
    imgs = [torch.from_numpy(a).permute(0, 3, 1, 2).cuda() for a in (i1, i2)]
    for splits in (1, 2):
        out = []
        for group in (None, LocalRing(2)):
            model = GMFlow(generator=torch.Generator().manual_seed(3),
                           group=group).cuda().eval()
            with torch.no_grad():
                out.append(model(*imgs, (splits,), (-1,), (-1,),
                                 training=False)["flow_preds"][-1])
        check(f"f32 64x96 forward, splits {splits}, LocalRing(2) vs "
              f"unsharded: |d| / (5e-3 px + 1e-3 |ref|), JAX's tolerance "
              f"(max |d| {float((out[1] - out[0]).abs().max()):.3e} px)",
              max_rel_excess(out[1], out[0], 1e-3, 5e-3), 1.0)

    # one f32 step's raw gradients, sharded and not
    batch = to_device(dict(
        image1=i1, image2=i2,
        flow=rng.normal(0, 3, (2, 64, 96, 2)).astype(np.float32),
        valid=np.ones((2, 64, 96), np.float32),
        label=np.eye(4, dtype=np.float32)[[0, 2]]), "cuda")
    cls = seeded_classifier(6, torch.float32)
    res = []
    for mp, mesh in ((1, None), (2, ProcessMesh.local(2))):
        cfg = gt.GMFlowTrainConfig(batch_size=2, image_size=(64, 96),
                                   mixed_precision=False, add_classifier=True,
                                   num_steps=100, model_parallel=mp)
        state = gt.init_state(cfg, seed=8, mesh=mesh)
        grads = {}
        adam_step = state.optimizer.step

        def keep(state=state, grads=grads, adam_step=adam_step):
            grads.update({n: p.grad.clone() for n, p
                          in state.model.named_parameters()})
            return adam_step()
        state.optimizer.step = keep
        state, m = gt.make_train_step(cfg, copy.deepcopy(cls))(state, batch)
        res.append(({k: float(v) for k, v in m.items()}, grads))
    (m_ref, g_ref), (m_sp, g_sp) = res
    print("  f32 step metrics, unsharded / LocalRing(2): " + ", ".join(
        f"{k} {v:.6f} / {m_sp[k]:.6f}" for k, v in sorted(m_ref.items())),
        flush=True)
    worst = max(abs(m_sp[k] - v) / (max(abs(v), 1e-6) * 1e-4
                                    + (2 / 12288 if "px_" in k else 0))
                for k, v in m_ref.items())
    check("f32 step, splits 2: loss and metrics, |d| / limit (1e-4 "
          "relative, 2 pixels for the rates)", worst, 1.0)
    norm = float(torch.sqrt(sum((g ** 2).sum() for g in g_ref.values())))
    excess = max(float((g_sp[k] - g).abs().max()) / norm
                 / (1e-3 if k == "backbone.conv1.weight" else 2e-4)
                 for k, g in g_ref.items())
    check(f"f32 step, splits 2: every raw gradient, |d| / ([11]'s 2e-4 of "
          f"the global norm {norm:.4f}; 1e-3 for backbone.conv1)", excess,
          1.0)

    # full width: the reference's recipe
    b = GM_BATCH
    cfg = gt.GMFlowTrainConfig(batch_size=b, image_size=GM_CROP,
                               mixed_precision=True, add_classifier=True,
                               model_parallel=2)
    state = gt.init_state(cfg, seed=0, mesh=ProcessMesh.local(2))
    step = gt.make_train_step(cfg, seeded_classifier(4, torch.bfloat16))
    batch = smooth_batch(24, b, *GM_CROP)
    t = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    print(f"  full width (128 channels, 6 blocks, FFN x4, 1 scale), bf16, "
          f"classifier on, batch {b} of {GM_CROP[0]}x{GM_CROP[1]}, "
          f"model_parallel 2: warm-up step {(time.perf_counter() - t) * 1e3:.1f}"
          f" ms, loss {float(m['total_loss']):.4f}", flush=True)
    timed = 3
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    losses = []
    with PlainCalls() as plain:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(timed):
            state, m = step(state, batch)
            losses.append(m["total_loss"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3 / timed
    plain.check("[18]")
    launches = launch_counts()
    print(f"  launches over {timed} steps: {launches}", flush=True)
    # a step: 12 window calls, each split in two (24), and two rings of 4
    # steps (matching, propagation): 32 flash forwards, 32 dq, 32 dk/dv
    want = want_launches(flash=32 * timed, flash_bwd_dq=32 * timed,
                         flash_bwd_dkv=32 * timed, instance_norm=15 * timed)
    if launches != want:
        fail(f"[18] launch counts {launches}, want {want}")
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not all(
            bool(torch.isfinite(p).all()) for p in state.model.parameters()):
        fail(f"[18] losses {losses} or parameters not finite")
    print(f"  losses {[round(x, 4) for x in losses]}; plain versions called "
          f"0 times", flush=True)
    print(f"  ms per step: {step_ms:.3f} over {timed} steps on a batch "
          f"already on the card (host clock, synchronized; both ranks' "
          f"work run in turn on one card, not a multi-GPU time), "
          f"{b * 1e3 / step_ms:.3f} pairs/s; [12]'s step alone "
          f"{alone_12:.3f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    profile(lambda: step(state, batch), step_ms, "step",
            named=[("the f32 forward (tf32x3 kernel and its merge)",
                    ("flash_fwd_tf32", "merge_splits"))])
    return launches


# --------------------------------------------------------------------------
# slice 15: the flash kernels' dense bias and widths up to 256 ([3j]);
# GMFlow at 256 channels ([20], [21], [22])
# --------------------------------------------------------------------------

BIAS_WIDTHS_C = (1, 8, 24, 100, 200, 256)
BIAS_WIDTHS_D = (1, 3, 24, 130, 256)


def wide_shapes(shapes, c: int):
    """``shapes`` (FLASH_SHAPES or FLASH_TRAIN_SHAPES) at C = c, the
    windows' D = c, the classes a path calls."""
    return tuple((name, (b, l, c, c if d == 128 else d, payload, swin), n)
                 for name, (b, l, _, d, payload, swin), n in shapes if n)


# GMFlow at feature_channels = 256: its flash calls at Sintel serving (a
# 1-scale pair) and at the training recipe (a step), as FLASH_SHAPES and
# FLASH_TRAIN_SHAPES with C = 256 and the windows' D = 256
FLASH256_SHAPES = wide_shapes(FLASH_SHAPES, 256)
FLASH256_TRAIN_SHAPES = wide_shapes(FLASH_TRAIN_SHAPES, 256)
# GMFlow's four flash shape classes with a dense [B, L, L] bias: name, (B,
# L, D, payload), calls of the bias-free shape per 1-scale pair or step
BIAS_SHAPES = (
    ("serving windows", (8, H8 * W8 // 4, 128, "normal"), 12),
    ("training windows", (8 * GM_BATCH, GH8 * GW8 // 4, 128, "normal"), 12),
    ("serving matching", (1, H8 * W8, 2, "grid"), 2),
    ("training matching", (GM_BATCH, GH8 * GW8, 2, "grid"), 2),
)


# the backward's wgmma route's edges at C = 256: name, (B, Lq, Lk, D,
# payload, swin)
WIDE_EDGES = (
    ("ragged 65x129", (1, 65, 129, 256, "normal", None)),
    ("ragged 129x65", (2, 129, 65, 256, "normal", None)),
    ("ragged 200x129", (1, 200, 129, 256, "normal", None)),
    ("ragged 65x200 D=2", (2, 65, 200, 2, "flow", None)),
    ("ragged 129x65 D=2", (1, 129, 65, 2, "flow", None)),
    ("ragged 200x200 D=2", (2, 200, 200, 2, "flow", None)),
    ("swin edge inside a tile", (8, 130, 130, 256, "normal",
                                 (2, 10, 13, 5, 6))),
    ("swin edge inside a tile D=2", (8, 130, 130, 2, "flow",
                                     (2, 10, 13, 5, 6))),
)


def upper_columns_fault(fl, fb, q, k, v, g, swin, keep: int = 128,
                        both: bool = True) -> None:
    """A fault only a kernel wider than ``keep`` columns can have: the
    kernels launched on q (and, with ``both``, k) whose columns past
    ``keep`` are zeroed (at C = 256 and ``keep`` = 128: a kernel that read
    two of its four panels; at C = 512 and ``keep`` = 256: two of its four
    128-column panels). The forward's out, held against the plain forward
    of the full operands, must land over ``bf16_tolerance``; with ``g``
    (not None) the backward's gradients, held against the plain backward
    of the full operands from the full forward's out and LSE, each over
    ``bwd_bf16_tolerance``. Prints how far."""
    import torch

    def cut(t):
        return torch.cat([t[..., :keep], torch.zeros_like(t[..., keep:])], -1)
    qz, kz = cut(q), (cut(k) if both else k)
    what = (f"q and k's columns past {keep}" if both
            else f"q's columns past {keep}")
    ref_out = fl.flash_softmax_matmul_plain(q, k, v, swin=swin)
    fwd = float(((fl.flash_softmax_matmul(qz, kz, v, swin=swin) - ref_out)
                 .abs() / fl.bf16_tolerance(q, k, v, swin=swin)).max())
    print(f"    planted fault, {what} zeroed, forward: out |d| / tolerance "
          f"{fwd:.2f} (must exceed 1)", flush=True)
    if not fwd > 1.0:
        fail(f"flash forward at C = {q.shape[2]}: {what} zeroed pass {fwd}")
    if g is None:
        return
    out, lse = fl.flash_softmax_matmul(q, k, v, swin=swin, with_lse=True)
    ref = fb.flash_backward_plain(q, k, v, out, lse, g, swin=swin)
    tols = fb.bwd_bf16_tolerance(q, k, v, out, lse, g, swin=swin)
    got = fb.flash_backward(qz, kz, v, out, lse, g, swin=swin)
    ratios = [float(((x - r).abs() / t).max())
              for x, r, t in zip(got, ref, tols)]
    print(f"    planted fault, {what} zeroed, backward: |d| / tolerance "
          f"(each must exceed 1): dq {ratios[0]:.2f}, dk {ratios[1]:.2f}, "
          f"dv {ratios[2]:.2f}", flush=True)
    if not min(ratios) > 1.0:
        fail(f"flash backward at C = {q.shape[2]}: {what} zeroed pass "
             f"{ratios}")


def flash_tolerance(fl, q, k, v, bias=None, swin=None):
    """[3e]'s tolerance of the forward kernel against the plain version:
    f32 1e-4 of max|v|; bf16 ``bf16_tolerance`` row by row (with the
    bias)."""
    import torch
    if q.dtype == torch.float32:
        return 1e-4 * float(v.abs().max())
    return fl.bf16_tolerance(q, k, v, swin=swin, bias=bias)


def flash_bias_compare(fl, what, q, k, v, bias, swin=None, plant=False,
                       masked_rows=None, route=None) -> float:
    """The kernel with a dense bias against the plain version with it on
    the same inputs (out within :func:`flash_tolerance`, the LSE within 1e-4
    + 1e-6 |ref|), two launches bit-equal; returns the out's max abs diff.
    ``masked_rows``: rows the bias masks whole (-1e30 on every key), which
    must hold the mean of v over the real keys and the LSE -1e30 + log(Lk),
    as JAX's dense oracle. ``plant``: two planted faults must exceed the
    tolerance: the bias's last key column dropped (zeroed; the case's bias
    weighs that column +8), and on a base-2 route (wgmma, tf32x3) the bias
    added to the base-2 scores unscaled by log2(e) (the kernel handed bias
    / log2(e)). ``route``: that route forced (``fl.launcher(route=...)``)
    instead of the planned one."""
    import math

    import torch

    def call(bias_, with_lse=False):
        if route is None:
            return fl.flash_softmax_matmul(q, k, v, bias=bias_, swin=swin,
                                           with_lse=with_lse)
        res, launch, _ = fl.launcher(q, k, v, swin=swin, with_lse=with_lse,
                                     route=route, bias=bias_)
        launch()
        return res if with_lse else res[0]
    got, lse = call(bias, True)
    again, again_lse = call(bias, True)
    torch.cuda.synchronize()
    ref, ref_lse = fl.flash_softmax_matmul_plain(q, k, v, swin=swin,
                                                 with_lse=True, bias=bias)
    if got.shape != ref.shape or got.dtype != torch.float32 \
            or not bool(torch.isfinite(got).all()):
        fail(f"flash bias {what}: {got.shape}/{got.dtype}, finite="
             f"{bool(torch.isfinite(got).all())}")
    if not (torch.equal(got, again) and torch.equal(lse, again_lse)):
        fail(f"flash bias {what}: two launches on the same inputs differ")
    tol = flash_tolerance(fl, q, k, v, bias, swin)
    err = float((got - ref).abs().max())
    tag = plan_tag(fl, q, k, v, bias) if route is None else \
        f" ({route}, forced)"
    line = (f"  {what}{tag}: max |d| {err:.3e}, "
            f"|d| / tolerance {float(((got - ref).abs() / tol).max()):.3f}, "
            f"lse {max_rel_excess(lse, ref_lse, 1e-6, 1e-4):.3f}")
    if masked_rows is not None:
        b, rows = masked_rows
        mean = v.to(q.dtype).float()[b].mean(0)
        t_rows = tol if isinstance(tol, float) else tol[b, rows]
        dev = float(((got[b, rows] - mean).abs() / t_rows).max())
        want = -1e30 + math.log(k.shape[1])
        lse_dev = max_rel_excess(lse[b, rows], torch.full_like(
            lse[b, rows], want), 1e-6, 1e-4)
        line += (f"; rows masked whole: |out - mean v| / tolerance "
                 f"{dev:.3f}, lse {lse_dev:.3f}")
        if not (dev <= 1.0 and lse_dev <= 1.0):
            fail(f"flash bias {what}: rows masked whole give {got[b, rows]}"
                 f" / lse {lse[b, rows]}, want the mean {mean}, {want}")
    if plant:
        cut = bias.clone()
        cut[..., -1] = 0
        faults = [call(cut)]
        names = ["the bias's last key column dropped"]
        ran = route or fl.plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                               v.shape[2], q.dtype).route
        if ran in ("wgmma", "tf32x3"):
            faults.append(call(bias / fl.LOG2E))
            names.append("the bias unscaled by log2(e)")
        ratios = [float(((f - ref).abs() / tol).max()) for f in faults]
        line += ("; planted faults, |d| / tolerance (each must exceed 1): "
                 + ", ".join(f"{n} {r:.2f}" for n, r in zip(names, ratios)))
        if not min(ratios) > 1.0:
            fail(f"flash bias {what}: a planted fault passes {ratios}")
    print(line + "; two launches bit-equal", flush=True)
    check(f"{what}: out |d| / tolerance",
          float(((got - ref).abs() / tol).max()), 1.0)
    check(f"{what}: lse |d| / (1e-4 + 1e-6 |ref|)",
          max_rel_excess(lse, ref_lse, 1e-6, 1e-4), 1.0)
    return err


def flash_width_compare(fl, fb, what, q, k, v, g) -> float:
    """Forward and backward kernels at a width the tiles need padded,
    against the plain versions on the unpadded operands: out within
    :func:`flash_tolerance`, the LSE within 1e-4 + 1e-6 |ref|; dq, dk, dv
    within [3f]'s tolerance (f32 1e-4 of each gradient's max |ref|, bf16
    ``bwd_bf16_tolerance``); each twice, bit-equal. Returns |d| /
    tolerance of out, the LSE, dq, dk and dv."""
    import torch
    out, lse = fl.flash_softmax_matmul(q, k, v, with_lse=True)
    grads = fb.flash_backward(q, k, v, out, lse, g)
    again = fl.flash_softmax_matmul(q, k, v, with_lse=True)
    grads_again = fb.flash_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    ref, ref_lse = fl.flash_softmax_matmul_plain(q, k, v, with_lse=True)
    ref_g = fb.flash_backward_plain(q, k, v, out, lse, g)
    shapes = [tuple(t.shape) for t in (out,) + tuple(grads)]
    want = [tuple(t.shape) for t in (ref,) + tuple(ref_g)]
    if shapes != want or not all(bool(torch.isfinite(t).all())
                                 for t in (out,) + tuple(grads)):
        fail(f"flash widths {what}: shapes {shapes}, want {want}, or not "
             f"finite")
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])
            and all(torch.equal(x, y) for x, y in zip(grads, grads_again))):
        fail(f"flash widths {what}: two launches on the same inputs differ")
    tol = flash_tolerance(fl, q, k, v)
    if q.dtype == torch.float32:
        tols = [1e-4 * float(r.abs().max()) for r in ref_g]
    else:
        tols = fb.bwd_bf16_tolerance(q, k, v, out, lse, g)
    ratios = [float(((out - ref).abs() / tol).max()),
              max_rel_excess(lse, ref_lse, 1e-6, 1e-4)] + [
        float(((x - r).abs() / t).max()) for x, r, t in zip(grads, ref_g,
                                                             tols)]
    return ratios


def flash_bias_width_phase(gen):
    import torch
    import torch.nn.functional as F
    from opticalflowfromdepth_torch.models.gmflow import \
        shift_window_attn_mask
    from opticalflowfromdepth_torch.ops import flash as fl
    from opticalflowfromdepth_torch.ops import flash_bwd as fb

    print("[3j] flash: the dense bias on every forward route and widths up "
          "to 256 forward and backward, CUDA kernels vs plain", flush=True)
    # the reference's Swin mask as a dense bias (shift_window_attn_mask,
    # tiled over the batch), against the in-kernel swin= call and the plain
    # version: the serving and the training windows
    for name, (b, hw, ww, l) in (
            ("serving", (8, (H8 // 2, W8 // 2), (H8 // 4, W8 // 4),
                         H8 * W8 // 4)),
            ("training", (8 * GM_BATCH, (GH8 // 2, GW8 // 2),
                          (GH8 // 4, GW8 // 4), GH8 * GW8 // 4))):
        swin = (2, hw[0], hw[1], ww[0], ww[1])
        mask = shift_window_attn_mask(2 * hw[0], 2 * hw[1], hw[0], hw[1],
                                      ww[0], ww[1], "cuda")
        bias = mask.repeat(b // 4, 1, 1)
        if not torch.equal(bias, fl.swin_mask_dense(l, swin, b, "cuda")):
            fail(f"[3j] {name}: the tiled shift_window_attn_mask is not "
                 f"swin_mask_dense")
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = flash_inputs(gen, b, l, l, 128, 128, dtype)
            what = f"{name} windows + Swin as a bias {dtype} [{b},{l},128]"
            flash_bias_compare(fl, what, q, k, v, bias)
            got = fl.flash_softmax_matmul(q, k, v, bias=bias)
            swin_out = fl.flash_softmax_matmul(q, k, v, swin=swin)
            tol = flash_tolerance(fl, q, k, v, swin=swin)
            check(f"{what}: against the in-kernel swin= call, |d| / "
                  f"tolerance", float(((got - swin_out).abs() / tol).max()),
                  1.0)
            del q, k, v
        del bias, mask
        torch.cuda.empty_cache()
    # a random-normal bias and a -100 block bias at the matching shapes
    # (B = 1: the tf32x3 route splits its key sweep; B = 16: unsplit), the
    # planted faults on the normal bias (its last key column weighed +8)
    for name, (b, l) in (("serving matching", (1, H8 * W8)),
                         ("training matching", (GM_BATCH, GH8 * GW8))):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = flash_inputs(gen, b, l, l, 128, 2, dtype, "grid",
                                   grid_w=W8 if b == 1 else GW8)
            bias = torch.randn(b, l, l, generator=gen).cuda()
            bias[..., -1] += 8.0
            flash_bias_compare(fl, f"{name} normal bias {dtype} [{b},{l},128]"
                               f"x[{b},{l},2]", q, k, v, bias, plant=True)
            bias.zero_()
            bias[:, : l // 2, l // 2:] = -100.0
            flash_bias_compare(fl, f"{name} -100 block bias {dtype}", q, k, v,
                               bias)
            del q, k, v, bias
            torch.cuda.empty_cache()
    # every route, with rows the bias masks whole (-1e30), Lk a multiple of
    # the key tile and ragged, bias with swin, and the planted faults
    route_gen = torch.Generator().manual_seed(71)
    for dtype, c, d, b, lq, lk, swin in (
            (torch.bfloat16, 128, 128, 8, 130, 130, (2, 10, 13, 5, 6)),
            (torch.bfloat16, 128, 2, 1, 100, 128, None),
            (torch.bfloat16, 128, 128, 2, 127, 100, None),
            (torch.bfloat16, 64, 16, 2, 100, 128, None),
            (torch.bfloat16, 64, 2, 2, 100, 100, None),
            (torch.bfloat16, 256, 256, 8, 130, 130, (2, 10, 13, 5, 6)),
            (torch.bfloat16, 256, 2, 2, 333, 301, None),
            (torch.float32, 128, 2, 1, 2000, 2000, None),      # split sweep
            (torch.float32, 128, 128, 2, 1001, 1001, None),    # split sweep
            (torch.float32, 128, 2, 16, 100, 128, None),       # unsplit
            (torch.float32, 128, 128, 8, 130, 130, (2, 10, 13, 5, 6)),
            (torch.float32, 64, 16, 2, 100, 100, None),
            (torch.float32, 64, 2, 2, 100, 128, None),
            (torch.float32, 256, 256, 8, 130, 130, (2, 10, 13, 5, 6))):
        q, _, _ = flash_inputs(route_gen, b, lq, lq, c, d, dtype)
        _, k, v = flash_inputs(route_gen, b, lk, lk, c, d, dtype)
        bias = torch.randn(b, lq, lk, generator=route_gen).cuda()
        bias[..., -1] += 8.0
        rows = [0, lq // 2, lq - 1]
        bias[b - 1, rows] = -1e30
        case = f"route case {dtype} [{b},{lq},{c}]x[{b},{lk},{d}]" + (
            f" swin {swin}" if swin else "")
        flash_bias_compare(fl, case, q, k, v, bias, swin=swin, plant=True,
                           masked_rows=(b - 1, rows))
        if dtype == torch.bfloat16 and c == 256:
            # the mma.sync route that C = 256 took before the wgmma one,
            # forced: its bias stays covered
            flash_bias_compare(fl, case, q, k, v, bias, swin=swin,
                               plant=True, masked_rows=(b - 1, rows),
                               route="mma_sync")
    # the Function with a bias on the card: JAX's dense backward in plain
    # PyTorch, the same on both devices; the bias's gradient zeros
    q, k, v = (t.requires_grad_() for t in flash_inputs(
        route_gen, 2, 100, 100, 64, 16, torch.float32))
    bias = torch.randn(2, 100, 100, generator=route_gen).cuda() \
        .requires_grad_()
    gout = torch.randn(2, 100, 16, generator=route_gen).cuda()
    grads = torch.autograd.grad(fl.flash_softmax_matmul(q, k, v, bias=bias),
                                (q, k, v, bias), gout)
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v, bias)]
    want = torch.autograd.grad(fl.flash_softmax_matmul(*cpu[:3],
                                                       bias=cpu[3]),
                               cpu, gout.cpu())
    check("the Function with a bias: card's gradients vs the CPU's (f32, "
          "dense recompute), max |d|",
          max(float((x.cpu() - y).abs().max()) for x, y in
              zip(grads[:3], want[:3])), 1e-4)
    if bool(grads[3].any()):
        fail("[3j] the bias's gradient is not zeros")

    # widths: C x D, bf16 and f32, forward and backward, padded to the
    # kernels' tiles and sliced back, against the plain versions
    width_gen = torch.Generator().manual_seed(72)
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for c in BIAS_WIDTHS_C:
            for d in BIAS_WIDTHS_D:
                q, _, _ = flash_inputs(width_gen, 2, 150, 150, c, d, dtype)
                _, k, v = flash_inputs(width_gen, 2, 130, 130, c, d, dtype)
                g = torch.randn(2, 150, d, generator=width_gen).cuda()
                bf16 = dtype == torch.bfloat16
                fp = fl.kernel_plan(2, 150, 130, c, d, bf16)
                bp = fb.kernel_plan(2, 150, 130, c, d, bf16)
                r = flash_width_compare(fl, fb, f"C={c} D={d} {dtype}", q, k,
                                        v, g)
                worst[(dtype, c, d)] = r
                cp, dp = fl.padded_widths(c, d)
                print(f"  widths {dtype} C={c} D={d} (padded {cp}x{dp}; "
                      + "; ".join(
                          f"{what} {p['route']}, {p['chunks']} chunk(s), "
                          f"{p['smem']} B shared, {p['regs']} registers"
                          for what, p in (("forward", fp),
                                          ("dq", bp["dq"]),
                                          ("dk/dv", bp["dkv"])))
                      + f"): |d| / tolerance out {r[0]:.3f}, lse "
                      f"{r[1]:.3f}, dq {r[2]:.3f}, dk {r[3]:.3f}, dv "
                      f"{r[4]:.3f}; two launches bit-equal", flush=True)
    check("every width, forward and backward, |d| / tolerance",
          max(max(r) for r in worst.values()), 1.0)
    # the C side's plans at every padded width the wrappers hand the
    # kernels (every C, D in 1..256): each block fits an SM
    largest = {}
    for bf16 in (True, False):
        for cp in range(16, 257, 16):
            for dp in [2] + list(range(16, 257, 16)):
                plans = [fl.kernel_plan(4, 300, 300, cp, dp, bf16, bias)
                         for bias in (False, True)]
                plans += list(fb.kernel_plan(4, 300, 300, cp, dp,
                                             bf16).values())
                for p in plans:
                    if p["per_sm"] < 1 or p["smem"] > 232448:
                        fail(f"[3j] C={cp} D={dp} bf16={bf16}: a block the "
                             f"card cannot hold: {p}")
                    key = (p["route"], bf16)
                    largest[key] = max(largest.get(key, 0), p["smem"])
    print("  the C side's plans at every padded width (C 16..256, D 2 or "
          "16..256, both dtypes, forward with a bias and without, dq, "
          "dk/dv): every block fits an SM; the largest a route takes, "
          "bytes: " + ", ".join(f"{r} {'bf16' if b else 'f32'} {n}"
                                for (r, b), n in sorted(largest.items())),
          flush=True)
    # widths past 256 run the kernels (C = 257 with D = 8, C = 8 with D =
    # 257: forward, dq and dk/dv each launched once, within tolerance of
    # the plain versions; [3k] holds them at every width); a bias of
    # another shape raises
    past_gen = torch.Generator().manual_seed(86)
    for c, d in ((257, 8), (8, 257)):
        q, k, v = flash_inputs(past_gen, 1, 8, 8, c, d, torch.float32)
        before = launch_counts()
        r = flash_width_compare(fl, fb, f"C={c} D={d}", q, k, v,
                                torch.randn_like(v))
        ran = {key: launch_counts()[key] - before[key]
               for key in ("flash", "flash_bwd_dq", "flash_bwd_dkv")}
        print(f"  C={c} D={d} f32 (past 256): launches {ran}; |d| / "
              f"tolerance out {r[0]:.3f}, lse {r[1]:.3f}, dq {r[2]:.3f}, dk "
              f"{r[3]:.3f}, dv {r[4]:.3f}", flush=True)
        if ran != dict(flash=2, flash_bwd_dq=2, flash_bwd_dkv=2) \
                or not max(r) <= 1.0:
            fail(f"[3j] C={c} D={d}: launches {ran}, |d| / tolerance {r}")
    q = torch.randn(1, 8, 8, device="cuda")
    try:
        fl.flash_softmax_matmul(q, q, q, bias=torch.zeros(1, 8, device="cuda"))
    except ValueError:
        pass
    else:
        fail("[3j] a bias of the wrong shape ran")

    # times with a bias at GMFlow's shape classes (bf16), against the
    # bound (the bias's bytes read once set it) and SDPA with the bias as
    # its attn_mask (bf16: SDPA takes a float mask in q's dtype)
    total = dict(ms=0.0, library_ms=0.0, bound_ms=0.0, plain_ms=0.0,
                 ops=0.0, exps=0.0, bytes=0.0)
    for name, (b, l, d, payload), n in BIAS_SHAPES:
        q, k, v = flash_inputs(gen, b, l, l, 128, d, torch.bfloat16, payload,
                               grid_w=W8 if b == 1 else GW8)
        bias = torch.randn(b, l, l, generator=gen).cuda()
        ms = cuda_ms(lambda: fl.flash_softmax_matmul(q, k, v, bias=bias))
        bare = cuda_ms(lambda: fl.flash_softmax_matmul(q, k, v))
        plain_ms = cuda_ms(lambda: fl.flash_softmax_matmul_plain(
            q, k, v, bias=bias), reps=2, warm=1)
        vb, mb = v.to(torch.bfloat16), bias.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], vb[:, None], attn_mask=mb[:, None],
            scale=1.0 / 128 ** 0.5), reps=10)
        f, e = 2.0 * b * l * l * (128 + d), float(b * l * l)
        by = (q.numel() + k.numel() + vb.numel()) * 2 + b * l * d * 4 \
            + bias.numel() * 4
        bound, bound_by = bound_ms(f, e, by, BF16_FLOP_PER_S)
        print(f"  time with a bias: {name} bf16 [{b},{l},128]x[{b},{l},{d}] "
              f"+ [{b},{l},{l}] f32{plan_tag(fl, q, k, v, bias)}: kernel "
              f"{ms * 1e3:.1f} us ({bound / ms:.3f} of its bound "
              f"{bound * 1e3:.1f} us, {bound_by}: {by / 1e6:.1f} MB, "
              f"{f / 1e9:.2f} GFLOP); the same call without the bias "
              f"{bare * 1e3:.1f} us; SDPA with the bias as attn_mask (bf16) "
              f"{lib_ms * 1e3:.1f} us; plain {plain_ms * 1e3:.1f} us",
              flush=True)
        for key, val in (("ms", ms), ("library_ms", lib_ms),
                         ("bound_ms", bound), ("plain_ms", plain_ms),
                         ("ops", f), ("exps", e), ("bytes", by)):
            total[key] += val
        del q, k, v, vb, mb, bias
        torch.cuda.empty_cache()
    bound, bound_by = bound_ms(total["ops"], total["exps"], total["bytes"],
                               BF16_FLOP_PER_S)
    print(f"  the four classes with a bias, one call each: kernel "
          f"{total['ms'] * 1e3:.1f} us ({bound / total['ms']:.3f} of the "
          f"bound {bound * 1e3:.1f} us, {bound_by}), SDPA with attn_mask "
          f"{total['library_ms'] * 1e3:.1f} us, plain "
          f"{total['plain_ms'] * 1e3:.1f} us", flush=True)

    # GMFlow at 256 channels: its flash calls at the serving and the
    # training shapes (C = 256, windows D = 256: the wgmma routes, forward
    # and backward), forward and backward, as [3e] and [3f] hold the 128
    # channels' classes (two launches bit-equal, the planted faults, and
    # q and k's upper 128 columns zeroed); then against their bounds, SDPA
    # and the mma.sync routes forced
    cmp_gen = torch.Generator().manual_seed(76)
    err_fwd = err_bwd = 0.0
    for what, shapes, grid_w in (("serving", FLASH256_SHAPES, W8),
                                 ("training", FLASH256_TRAIN_SHAPES, GW8)):
        for name, (b, l, c, d, payload, swin), _ in shapes:
            q, k, v = flash_inputs(cmp_gen, b, l, l, c, d, torch.bfloat16,
                                   payload, grid_w=grid_w)
            case = (f"256-channel {what} {name} bf16 [{b},{l},{c}]x"
                    f"[{b},{l},{d}]")
            err_fwd = max(err_fwd, flash_compare(
                fl, case + plan_tag(fl, q, k, v), q, k, v, swin))
            if fl.plan(b, l, l, c, d, torch.bfloat16).route != "wgmma":
                fail(f"[3j] {case}: the forward does not take the wgmma "
                     f"route")
            g = None
            if what == "training":
                g = torch.randn(b, l, d, generator=cmp_gen).cuda()
                route = fb.plan(b, l, l, c, d, torch.bfloat16).route
                err_bwd = max(err_bwd, flash_bwd_compare(
                    fl, fb, f"{case} ({route})", q, k, v, g, swin))
            upper_columns_fault(fl, fb, q, k, v, g, swin)
            del g
            del q, k, v
            torch.cuda.empty_cache()
    # the wgmma routes at their edges at C = 256: Lq and Lk of 65, 129 and
    # 200 against the forward's 64-key tiles and 128-query (64 at D = 2)
    # blocks, dq's 32-key tiles (64 at D = 2) and 128-query blocks and
    # dk/dv's 64-query tiles and 64-key blocks (128 at D = 2), D = 256 and
    # 2, a Swin region edge inside a tile (window 10x13 shifted 5 and 6);
    # a generator of their own
    edge_gen = torch.Generator().manual_seed(77)
    for name, (b, lq, lk, d, payload, swin) in WIDE_EDGES:
        q, _, _ = flash_inputs(edge_gen, b, lq, lq, 256, d, torch.bfloat16,
                               payload)
        _, k, v = flash_inputs(edge_gen, b, lk, lk, 256, d, torch.bfloat16,
                               payload)
        g = torch.randn(b, lq, d, generator=edge_gen).cuda()
        flash_compare(fl, f"256-channel forward {name} bf16 [{b},{lq},256]x"
                      f"[{b},{lk},{d}]{plan_tag(fl, q, k, v)}", q, k, v, swin)
        route = fb.plan(b, lq, lk, 256, d, torch.bfloat16).route
        err_bwd = max(err_bwd, flash_bwd_compare(
            fl, fb, f"256-channel {name} bf16 [{b},{lq},256]x[{b},{lk},{d}] "
            f"({route})", q, k, v, g, swin))
        del q, k, v, g
    worst = dict(flash=err_fwd, flash_bwd_dq=err_bwd, flash_bwd_dkv=err_bwd)
    # the forward at every class beside the mma.sync route forced on the
    # same inputs (the route C = 256 took before; it must lose at each)
    pair, _ = flash_timing(fl, torch.Generator().manual_seed(73),
                           FLASH256_SHAPES, W8, "256-channel pair",
                           plain=True, old_route="mma_sync")
    step, _ = flash_timing(fl, torch.Generator().manual_seed(74),
                           FLASH256_TRAIN_SHAPES, GW8, "256-channel step",
                           plain=False, old_route="mma_sync")
    wide = flash_bwd_timing(fl, fb, F, torch.Generator().manual_seed(75),
                            torch.bfloat16, FLASH256_TRAIN_SHAPES,
                            old_route="mma_sync")
    # the kernels line's flash_bwd rows carry the 256-channel step's numbers
    # as c256_*, the forced mma.sync route's as c256_mma_sync_ms
    wide = {rec["name"]: {f"c256_{key}": rec[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        | {"c256_mma_sync_ms": rec["old_ms"]} for rec in wide}
    # the kernels line's flash row: the 256-channel pair's 14 forward calls
    # as c256_*, the forced mma.sync route's as c256_mma_sync_ms, and the
    # step's 14 as c256_step_*
    c256 = {f"c256_{key}": pair[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    c256 |= {f"c256_step_{key}": step[key] for key in (
        "ms", "bound_ms", "bound_by", "library_ms")}
    c256 |= {"c256_mma_sync_ms": pair["old_ms"],
             "c256_step_mma_sync_ms": step["old_ms"]}
    return dict(bias_ms=total["ms"], bias_plain_ms=total["plain_ms"],
                bias_bound_ms=bound, bias_bound_by=bound_by,
                bias_library_ms=total["library_ms"], **c256), worst, wide


# GMFlow at feature_channels = 256 ([20]-[22]; the wgmma routes) and 512
# ([23]-[25]; the mma.sync route): the phases' numbers, the route every
# flash forward of the bf16 paths takes, and the flash kernels by name in
# their profiles
WIDE_GMFLOW = {256: ((20, 21, 22), "wgmma"), 512: ((23, 24, 25), "mma_sync")}
FLASH_BWD_NAMED = [("the flash backward kernels (14 dq + 14 dk/dv)",
                    ("flash_bwd_",)),
                   ("the flash backward's dq kernels", ("flash_bwd_dq_",)),
                   ("the flash backward's dk/dv kernels", ("flash_bwd_dkv_",)),
                   ("the flash forward kernels (14)", ("flash_fwd_",))]


def gmflow_wide_parity_phase(channels: int):
    import copy

    import numpy as np
    import torch
    from opticalflowfromdepth_torch.eval.infer import gmflow_infer_fn
    from opticalflowfromdepth_torch.models.gmflow import GMFlow

    phase = WIDE_GMFLOW[channels][0][0]
    print(f"[{phase}] GMFlow at {channels} channels, 64x96, f32, 1 scale: "
          f"card vs CPU", flush=True)
    rng = np.random.default_rng(19)
    i1, i2 = smooth_pairs(rng, 1, 64, 96)
    model = GMFlow(feature_channels=channels,
                   generator=torch.Generator().manual_seed(20))
    sp, cr, pr = GMFLOW_RECIPES[1]
    cpu = gmflow_infer_fn(copy.deepcopy(model), sp, cr, pr,
                          device="cpu")(i1, i2)
    zero_launch_counts()
    gpu = gmflow_infer_fn(model, sp, cr, pr, device="cuda")(i1, i2)
    got = launch_counts()
    if got != want_launches(flash=14, instance_norm=15):
        fail(f"GMFlow-{channels} 64x96 launch counts {got}")
    d = np.abs(gpu - cpu)
    print(f"  |flow| max {np.abs(cpu).max():.3f} px; launches {got}",
          flush=True)
    # f32 both sides (TF32 off): [9]'s 1-scale limits
    check(f"{channels}-channel flow card vs CPU (px)", float(d.max()), 2e-2)
    check("  median (px)", float(np.median(d)), 1e-2)


def gmflow_wide_serving_phase(channels: int):
    import numpy as np
    import torch
    from opticalflowfromdepth_torch.eval.infer import gmflow_infer_fn
    from opticalflowfromdepth_torch.eval.padder import InputPadder
    from opticalflowfromdepth_torch.models.gmflow import GMFlow

    (_, phase, _), route = WIDE_GMFLOW[channels]
    print(f"[{phase}] GMFlow at {channels} channels serving: bf16, 1 scale, 3 "
          f"pairs of {SINTEL[0]}x{SINTEL[1]} (padding factor 16)", flush=True)
    rng = np.random.default_rng(21)
    pairs = [[rng.uniform(0, 255, (1,) + SINTEL + (3,)).astype(np.float32)
              for _ in range(2)] for _ in range(4)]
    model = GMFlow(feature_channels=channels, dtype=torch.bfloat16,
                   generator=torch.Generator().manual_seed(22))
    infer = gmflow_infer_fn(model, *GMFLOW_RECIPES[1], device="cuda")
    padder = InputPadder(pairs[0][0].shape, padding_factor=16)

    def serve(i1, i2):
        a, b = padder.pad(i1, i2)
        return padder.unpad(infer(a, b))
    t = time.perf_counter()
    serve(*pairs[0])                                   # warm-up pair
    print(f"  warm-up pair {(time.perf_counter() - t) * 1e3:.1f} ms",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    times = []
    with PlainCalls() as plain, FlashRoutes() as routes:
        for i1, i2 in pairs[1:]:
            t = time.perf_counter()
            flow = serve(i1, i2)
            times.append((time.perf_counter() - t) * 1e3)
            if flow.shape != (1,) + SINTEL + (2,) \
                    or not np.isfinite(flow).all():
                fail(f"GMFlow-{channels} serving flow {flow.shape}, finite="
                     f"{bool(np.isfinite(flow).all())}")
    plain.check(f"GMFlow-{channels} serving")
    launches = launch_counts()
    n = len(times)
    routes.check(f"GMFlow-{channels} serving", {route: 14 * n})
    print(f"  launches over {n} pairs: {launches}", flush=True)
    if launches != want_launches(flash=14 * n, instance_norm=15 * n):
        fail(f"GMFlow-{channels} serving launch counts {launches}")
    print(f"  ms per pair: {[round(x, 3) for x in times]} (mean "
          f"{sum(times) / n:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; |flow| "
          f"max {np.abs(flow).max():.3f} px", flush=True)
    profile(lambda: serve(*pairs[1]), sum(times) / n, "pair",
            named=FLASH_FWD_NAMED)
    return launches


def gmflow_wide_train_phase(channels: int):
    import math

    import numpy as np
    import torch
    from opticalflowfromdepth_torch.data.loader import to_device
    from opticalflowfromdepth_torch.train import gmflow_train as gt

    (_, _, phase), route = WIDE_GMFLOW[channels]
    b, (h, w) = GM_BATCH, GM_CROP
    print(f"[{phase}] GMFlow at {channels} channels training: 2 steps of the "
          f"reference recipe (batch {b} of {h}x{w}, bf16, 1 scale, classifier "
          f"on) on a resident batch", flush=True)
    rng = np.random.default_rng(23)
    i1, i2 = smooth_pairs(rng, b, h, w)
    batch = to_device(dict(
        image1=i1, image2=i2,
        flow=rng.normal(0, 8, (b, h, w, 2)).astype(np.float32),
        valid=np.ones((b, h, w), np.float32),
        label=np.eye(4, dtype=np.float32)[rng.integers(0, 4, b)]), "cuda")
    cfg = gt.GMFlowTrainConfig(batch_size=b, image_size=GM_CROP,
                               mixed_precision=True, add_classifier=True,
                               feature_channels=channels)
    state = gt.init_state(cfg, seed=3)
    step = gt.make_train_step(cfg, seeded_classifier(4, torch.bfloat16))
    t = time.perf_counter()
    state, _ = step(state, batch, None)                 # warm-up step
    torch.cuda.synchronize()
    print(f"  warm-up step {(time.perf_counter() - t) * 1e3:.1f} ms",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    losses, times = [], []
    with PlainCalls() as plain, FlashRoutes() as routes:
        for _ in range(2):
            t = time.perf_counter()
            state, m = step(state, batch, None)
            losses.append(float(m["total_loss"]))        # waits for the card
            times.append((time.perf_counter() - t) * 1e3)
    plain.check(f"GMFlow-{channels} training")
    routes.check(f"GMFlow-{channels} training", {route: 28})
    launches = launch_counts()
    want = want_launches(flash=28, flash_bwd_dq=28, flash_bwd_dkv=28,
                         instance_norm=30)
    print(f"  launches over 2 steps: {launches}; losses "
          f"{[round(x, 4) for x in losses]}; ms per step "
          f"{[round(x, 3) for x in times]}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    if launches != want:
        fail(f"GMFlow-{channels} training launch counts {launches}, want "
             f"{want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"GMFlow-{channels} training loss not finite: {losses}")
    # one more step under the profiler (after the counts are read): the
    # step's busy time and its flash kernels' share, on the card's clock
    profile(lambda: step(state, batch, None), sum(times) / len(times),
            "step", named=FLASH_BWD_NAMED + FLASH_FWD_NAMED)
    return launches


# --------------------------------------------------------------------------
# slice 18: the flash kernels past 256 ([3k]); GMFlow at 512 channels
# ([23], [24], [25])
# --------------------------------------------------------------------------

WIDE_C = (264, 384, 512, 1000)
WIDE_D = (2, 3, 384, 512, 600)
# GMFlow at feature_channels = 512: its flash calls at Sintel serving and
# at the training recipe, C = 512 and the windows' D = 512
FLASH512_SHAPES = wide_shapes(FLASH_SHAPES, 512)
FLASH512_TRAIN_SHAPES = wide_shapes(FLASH_TRAIN_SHAPES, 512)
WIDE_SWIN = (2, 10, 13, 5, 6)      # a region edge inside a key tile


def flash_wide_phase(gen):
    import torch
    import torch.nn.functional as F
    from opticalflowfromdepth_torch.ops import flash as fl
    from opticalflowfromdepth_torch.ops import flash_bwd as fb

    print("[3k] flash past 256: the mma.sync (bf16) and CUDA-core (f32) "
          "routes at C and D past 256, forward and backward, CUDA kernels "
          "vs plain", flush=True)
    # every C x D of WIDE_C x WIDE_D and C = 2000 (Q's rows staged a panel
    # at a time), both dtypes: forward and backward against the plain
    # versions, each twice, bit-equal; the C side's plan of each (the
    # route, a block within 227 KB of shared memory, no local memory, a
    # block an SM at least)
    width_gen = torch.Generator().manual_seed(80)
    worst = []
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        route = "mma_sync" if bf16 else "f32"
        for c, d in [(c, d) for c in WIDE_C for d in WIDE_D] + [
                (2000, 2), (2000, 600)]:
            q, _, _ = flash_inputs(width_gen, 2, 150, 150, c, d, dtype)
            _, k, v = flash_inputs(width_gen, 2, 130, 130, c, d, dtype)
            g = torch.randn(2, 150, d, generator=width_gen).cuda()
            r = flash_width_compare(fl, fb, f"C={c} D={d} {dtype}", q, k, v,
                                    g)
            worst.append(max(r))
            cp, dp = fl.padded_widths(c, d)
            plans = dict(forward=fl.kernel_plan(2, 150, 130, c, d, bf16),
                         **fb.kernel_plan(2, 150, 130, c, d, bf16))
            for key, p in plans.items():
                if p["route"] != route or not 0 < p["smem"] <= 232448 \
                        or p["local"] or p["per_sm"] < 1:
                    fail(f"[3k] C={c} D={d} {dtype} {key}: plan {p}")
            print(f"  widths {dtype} C={c} D={d} (padded {cp}x{dp}; "
                  + "; ".join(f"{key} {p['route']}, {p['chunks']} chunk(s), "
                              f"{p['smem']} B shared, {p['regs']} registers, "
                              f"{p['per_sm']} a SM"
                              for key, p in plans.items())
                  + f"): |d| / tolerance out {r[0]:.3f}, lse {r[1]:.3f}, dq "
                  f"{r[2]:.3f}, dk {r[3]:.3f}, dv {r[4]:.3f}; two launches "
                  f"bit-equal", flush=True)
            del q, k, v, g
    check("every width past 256, forward and backward, |d| / tolerance",
          max(worst), 1.0)
    # GMFlow at 512 channels: its flash calls at the serving and the
    # training shapes (C = 512, windows D = 512: the mma.sync routes),
    # forward at every class and backward at the training classes, as [3j]
    # holds the 256 channels' (two launches bit-equal, [3e]'s and [3f]'s
    # planted faults, and q's columns past 256 zeroed: the long key sweeps,
    # the D chunks on the grid and the resident Q rows at these sizes)
    cmp_gen = torch.Generator().manual_seed(87)
    err_fwd = err_bwd = 0.0
    for what, shapes, grid_w in (("serving", FLASH512_SHAPES, W8),
                                 ("training", FLASH512_TRAIN_SHAPES, GW8)):
        for name, (b, l, c, d, payload, swin), _ in shapes:
            q, k, v = flash_inputs(cmp_gen, b, l, l, c, d, torch.bfloat16,
                                   payload, grid_w=grid_w)
            case = (f"512-channel {what} {name} bf16 [{b},{l},{c}]x"
                    f"[{b},{l},{d}]")
            if fl.plan(b, l, l, c, d, torch.bfloat16).route != "mma_sync" \
                    or fb.plan(b, l, l, c, d, torch.bfloat16).route \
                    != "mma_sync":
                fail(f"[3k] {case}: not the mma.sync route")
            err_fwd = max(err_fwd, flash_compare(
                fl, case + plan_tag(fl, q, k, v), q, k, v, swin))
            g = None
            if what == "training":
                g = torch.randn(b, l, d, generator=cmp_gen).cuda()
                err_bwd = max(err_bwd, flash_bwd_compare(
                    fl, fb, f"{case} (mma_sync)", q, k, v, g, swin))
            upper_columns_fault(fl, fb, q, k, v, g, swin, keep=256,
                                both=False)
            del q, k, v, g
            torch.cuda.empty_cache()
    # the Swin mask at C = D = 512 and C = 1000, D = 600 ([3e]'s and
    # [3f]'s checks: the planted faults, two launches bit-equal); in bf16
    # q's columns past 256 zeroed (the kernels must read every panel) and
    # v's columns past 256 zeroed (every D chunk), which must fail
    swin_gen = torch.Generator().manual_seed(81)
    for dtype in (torch.bfloat16, torch.float32):
        for c, d in ((512, 512), (1000, 600)):
            q, _, _ = flash_inputs(swin_gen, 8, 130, 130, c, d, dtype)
            _, k, v = flash_inputs(swin_gen, 8, 130, 130, c, d, dtype)
            g = torch.randn(8, 130, d, generator=swin_gen).cuda()
            case = f"wide Swin {dtype} [8,130,{c}]x[8,130,{d}]"
            err_fwd = max(err_fwd, flash_compare(
                fl, case + plan_tag(fl, q, k, v), q, k, v, WIDE_SWIN))
            route = fb.plan(8, 130, 130, c, d, dtype).route
            err_bwd = max(err_bwd, flash_bwd_compare(
                fl, fb, f"{case} ({route})", q, k, v, g, WIDE_SWIN))
            if dtype == torch.bfloat16:
                upper_columns_fault(fl, fb, q, k, v, g, WIDE_SWIN, keep=256,
                                    both=False)
                vz = torch.cat([v[..., :256], torch.zeros_like(v[..., 256:])],
                               -1)
                ref = fl.flash_softmax_matmul_plain(q, k, v, swin=WIDE_SWIN)
                cut = float(((fl.flash_softmax_matmul(
                    q, k, vz, swin=WIDE_SWIN) - ref).abs()
                    / fl.bf16_tolerance(q, k, v, swin=WIDE_SWIN)).max())
                print(f"    planted fault, v's columns past 256 zeroed, "
                      f"forward: out |d| / tolerance {cut:.2f} (must exceed "
                      f"1)", flush=True)
                if not cut > 1.0:
                    fail(f"[3k] {case}: v's columns past 256 zeroed pass")
            del q, k, v, g
    # a dense bias on both routes past 256: Lk ragged, rows the bias masks
    # whole, the planted faults (its last key column dropped)
    bias_gen = torch.Generator().manual_seed(82)
    for dtype, c, d, b, lq, lk, swin in (
            (torch.bfloat16, 512, 512, 2, 333, 301, None),
            (torch.bfloat16, 512, 2, 2, 333, 301, None),
            (torch.bfloat16, 1000, 600, 2, 333, 301, None),
            (torch.bfloat16, 512, 512, 8, 130, 130, WIDE_SWIN),
            (torch.float32, 512, 512, 2, 333, 301, None),
            (torch.float32, 1000, 3, 2, 333, 301, None)):
        q, _, _ = flash_inputs(bias_gen, b, lq, lq, c, d, dtype)
        _, k, v = flash_inputs(bias_gen, b, lk, lk, c, d, dtype)
        bias = torch.randn(b, lq, lk, generator=bias_gen).cuda()
        bias[..., -1] += 8.0
        rows = [0, lq // 2, lq - 1]
        bias[b - 1, rows] = -1e30
        err_fwd = max(err_fwd, flash_bias_compare(
            fl, f"wide bias {dtype} [{b},{lq},{c}]x[{b},{lk},{d}]"
            + (f" swin {swin}" if swin else ""), q, k, v, bias, swin=swin,
            plant=True, masked_rows=(b - 1, rows)))
        del q, k, v, bias
    # the C side's plans past 256 (C 272..1024 and D 2 or 272..1024, in
    # steps of 48; both dtypes; forward with a bias and without, dq,
    # dk/dv): every block fits an SM
    largest = {}
    for bf16 in (True, False):
        for cp in range(272, 1025, 48):
            for dp in [2] + list(range(272, 1025, 48)):
                plans = [fl.kernel_plan(4, 300, 300, cp, dp, bf16, bias)
                         for bias in (False, True)]
                plans += list(fb.kernel_plan(4, 300, 300, cp, dp,
                                             bf16).values())
                for p in plans:
                    if p["per_sm"] < 1 or p["smem"] > 232448:
                        fail(f"[3k] C={cp} D={dp} bf16={bf16}: a block the "
                             f"card cannot hold: {p}")
                    key = (p["route"], bf16)
                    largest[key] = max(largest.get(key, 0), p["smem"])
    print("  the C side's plans past 256 (C 272..1024, D 2 or 272..1024, "
          "steps of 48, both dtypes): every block fits an SM; the largest a "
          "route takes, bytes: " + ", ".join(
              f"{r} {'bf16' if b else 'f32'} {n}"
              for (r, b), n in sorted(largest.items())), flush=True)
    # GMFlow at 512 channels' flash calls, timed against their bounds, the
    # plain versions and SDPA (its backend named): a serving pair's 14
    # forwards, a training step's 14 forwards, 14 dq and 14 dk/dv
    pair, _ = flash_timing(fl, torch.Generator().manual_seed(83),
                           FLASH512_SHAPES, W8, "512-channel pair",
                           plain=True)
    step, _ = flash_timing(fl, torch.Generator().manual_seed(84),
                           FLASH512_TRAIN_SHAPES, GW8, "512-channel step",
                           plain=False)
    wide = flash_bwd_timing(fl, fb, F, torch.Generator().manual_seed(85),
                            torch.bfloat16, FLASH512_TRAIN_SHAPES)
    # the kernels line's rows: the flash row carries the 512-channel pair's
    # 14 forwards as c512_* and the step's 14 as c512_step_*; the
    # backward's rows the step's 14 launches as c512_*
    c512 = {f"c512_{key}": pair[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    c512 |= {f"c512_step_{key}": step[key] for key in (
        "ms", "bound_ms", "bound_by", "library_ms")}
    wide = {rec["name"]: {f"c512_{key}": rec[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for rec in wide}
    worst = dict(flash=err_fwd, flash_bwd_dq=err_bwd, flash_bwd_dkv=err_bwd)
    return c512, worst, wide


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
    codec_built = bool(_build.build(["shardio"]))   # {} if built before
    codec_s = time.perf_counter() - t if codec_built else float("nan")
    t = time.perf_counter()
    logs = _build.build(["fused_corr", "flash", "flash_bwd", "conv3x3",
                         "instance_norm", "forward_warp"])
    print(f"[2] g++ build of the npz codec {codec_s:.2f} s; nvcc build "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1][:48]  # the mangled kernel name
            elif "registers" in line or "spill" in line:
                print(f"  {name}: {entry}: {line.strip()}", flush=True)
            elif "Performance" in line:  # names its kernel, before its entry
                print(f"  {name}: {line.strip()}", flush=True)
    gen = torch.Generator().manual_seed(0)
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    kernels = [timed("3a", fused_corr_phase, gen),
               timed("3b", instance_norm_phase, gen),
               timed("3c", fused_corr_bwd_phase, gen)]
    timed("3d", instance_norm_grad_phase, gen)
    flash = timed("3e", flash_phase, gen)
    flash_bwd = timed("3f", flash_bwd_phase, gen)
    timed("4", e2e_parity_phase)
    timed("5", main_path_phase)
    timed("6", train_parity_phase)
    with tempfile.TemporaryDirectory() as tmp:
        launches, profiling_7 = timed("7", train_path_phase, tmp)
    timed("8", learning_phase)
    for k in kernels:          # launches on slice 2's main path, training
        k["launches"] = launches[k["name"]]
    timed("9", gmflow_parity_phase)
    # flash's launches on slice 3's main path, GMFlow serving
    flash["launches"] = timed("10", gmflow_serving_phase)["flash"]
    kernels.append(flash)
    timed("11", gmflow_train_parity_phase)
    tmp_12 = tempfile.TemporaryDirectory()     # its shards, read in [19]
    launches, alone_12 = timed("12", gmflow_train_path_phase, tmp_12.name)
    timed("12 learning", gmflow_learning_phase)
    for k in flash_bwd:        # launches on slice 4's main path
        k["launches"] = launches[k["name"]]
    kernels.extend(flash_bwd)
    # run after the paths of slices 1-4, so that they meet the process as
    # before it (its f32 backward leaves PyTorch's cuBLAS workspaces for
    # the autograd thread allocated)
    conv = timed("3g", conv_phase, gen, logs.get("conv3x3", ""))
    with tempfile.TemporaryDirectory() as tmp:
        launches = timed("13", eval_phase, tmp)
    # the conv's launches on slice 5's main path, evaluation: 0, as in the
    # JAX package no model calls it (checked on every path above)
    conv["launches"] = launches[conv["name"]]
    kernels.append(conv)
    # slice 10: the synthesis engine, after every earlier path
    warp = timed("3h", forward_warp_phase, logs.get("forward_warp", ""))
    timed("14", synth_parity_phase)
    with tempfile.TemporaryDirectory() as tmp:
        launches, outs = timed("15", synth_path_phase, tmp)
        # slice 11: the training CLI on [15]'s shards
        cli_16 = timed("16", train_cli_phase, tmp, outs)
    # the warp's launches on slice 10's main path, the synthesis CLI
    warp["launches"] = launches[warp["name"]]
    kernels.append(warp)
    # slice 6 of the roadmap: the ring on the card, data parallelism over
    # NCCL, and sequence-parallel GMFlow training, after every earlier path
    timed("3i", ring_phase, torch.Generator().manual_seed(64))
    timed("17", data_parallel_phase)
    launches = timed("18", sequence_parallel_phase, alone_12)
    # the flash rows gain the launches of [18]'s path
    for k in kernels:
        if k["name"] in ("flash", "flash_bwd_dq", "flash_bwd_dkv"):
            k["launches"] += launches[k["name"]]
    # slice 8: the npz codec under the loaders, the bilateral filter and
    # profiling (no kernel of their own)
    timed("19", host_data_phase, os.path.join(tmp_12.name, "gmflow_shards"),
          cli_16, profiling_7, codec_s, card)
    tmp_12.cleanup()
    # slice 15: the flash kernels' dense bias and widths up to 256, then
    # GMFlow at 256 channels, after every earlier path
    bias, worst, wide = timed("3j", flash_bias_width_phase,
                              torch.Generator().manual_seed(70))
    flash.update(bias)
    for k in flash_bwd:
        k.update(wide[k["name"]])
    timed("20", gmflow_wide_parity_phase, 256)
    served = timed("21", gmflow_wide_serving_phase, 256)
    trained = timed("22", gmflow_wide_train_phase, 256)
    # the flash rows gain the launches of [21]'s and [22]'s paths, and the
    # largest error of [3j]'s comparisons at those paths' shapes
    for k in kernels:
        if k["name"] in ("flash", "flash_bwd_dq", "flash_bwd_dkv"):
            k["launches"] += served[k["name"]] + trained[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], worst[k["name"]])
    # slice 18: the flash kernels past 256, then GMFlow at 512 channels
    c512, worst, wide = timed("3k", flash_wide_phase,
                              torch.Generator().manual_seed(79))
    flash.update(c512)
    for k in flash_bwd:
        k.update(wide[k["name"]])
    timed("23", gmflow_wide_parity_phase, 512)
    served = timed("24", gmflow_wide_serving_phase, 512)
    trained = timed("25", gmflow_wide_train_phase, 512)
    # the flash rows gain the launches of [24]'s and [25]'s paths, and the
    # largest error of [3k]'s comparisons
    for k in kernels:
        if k["name"] in ("flash", "flash_bwd_dq", "flash_bwd_dkv"):
            k["launches"] += served[k["name"]] + trained[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], worst[k["name"]])
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(f"seconds per phase: {seconds}", flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    # the flash row also carries the f32 route's numbers (f32_*), the
    # dense bias's (bias_*) and the 256- and 512-channel pair's and step's
    # (c256_*, c512_*); the backward's rows the 256- and 512-channel
    # step's (c256_*, c512_*)
    print(json.dumps({"kernels": [
        {**{k: kern[k] for k in order},
         **{k: v for k, v in kern.items()
            if k.startswith(("f32_", "bias_", "c256_", "c512_"))}}
        for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
