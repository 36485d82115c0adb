"""The flash forward's launch plan and the tf32x3 route's arithmetic
(``ops/flash.py``), on the CPU.

:func:`plan` is host arithmetic: the route by dtype and width, the split
key sweep, the scratch shapes and the shared memory are checked here for
the shapes the port's paths pass (GMFlow's training and serving matching
grids, the sequence-parallel ring's slices, the windows). The route's
split-TF32 products cannot run here; :func:`flash_softmax_matmul_tf32`
repeats their rounding in plain PyTorch, and is held against JAX's dense
f32 oracle, unsplit and as the runs of a split sweep merged the kernel's
way. Inputs come from numpy seeds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.models.gmflow import (
    shift_window_attn_mask, split_feature)
from opticalflowfromdepth_tpu.ops.flash import flash_softmax_matmul_ref
from opticalflowfromdepth_torch.ops import flash as tf
from opticalflowfromdepth_torch.ops import flash_bwd as tb

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype,c,d,route", [
    (torch.bfloat16, 128, 128, "wgmma"),
    (torch.bfloat16, 128, 2, "wgmma"),
    (torch.bfloat16, 64, 16, "mma_sync"),
    (torch.bfloat16, 128, 16, "mma_sync"),
    # C = 256: the wgmma route where the widths pad to C = 256 and D = 256
    # or 2 (GMFlow at 256 channels), mma.sync at every other width
    (torch.bfloat16, 256, 256, "wgmma"),
    (torch.bfloat16, 256, 2, "wgmma"),
    (torch.bfloat16, 250, 1, "wgmma"),          # pads to 256 x 2
    (torch.bfloat16, 241, 250, "wgmma"),        # pads to 256 x 256
    (torch.bfloat16, 256, 128, "mma_sync"),
    (torch.bfloat16, 192, 256, "mma_sync"),
    # C = 512: the wgmma route where the widths pad to C = 512 and D = 512
    # or 2 (GMFlow at 512 channels), forward, dq and dk/dv
    (torch.bfloat16, 512, 512, "wgmma"),
    (torch.bfloat16, 512, 2, "wgmma"),
    (torch.bfloat16, 500, 1, "wgmma"),          # pads to 512 x 2
    (torch.bfloat16, 497, 510, "wgmma"),        # pads to 512 x 512
    (torch.bfloat16, 512, 256, "mma_sync"),
    (torch.bfloat16, 384, 384, "mma_sync"),
    (torch.bfloat16, 1000, 2, "mma_sync"),
    (torch.float32, 512, 512, "f32"),
    (torch.float32, 256, 256, "f32"),
    (torch.float32, 128, 128, "tf32x3"),
    (torch.float32, 128, 2, "tf32x3"),
    (torch.float32, 64, 16, "f32"),
    (torch.float32, 128, 64, "f32"),
    (torch.float32, 32, 2, "f32")])
def test_route_by_dtype_and_width(dtype, c, d, route):
    """The forward names the backward kernels' route (dq's and dk/dv's)
    for the same operands."""
    p = tf.plan(2, 300, 300, c, d, dtype)
    pb = tb.plan(2, 300, 300, c, d, dtype)
    assert p.route == route == pb.route_dkv == pb.route_dq
    wide = route == "wgmma" and p.c_pad == 512
    assert p.chunks == (2 if wide and p.d_pad == 512 else 1)
    assert route in tf.ROUTES
    if route != "tf32x3":       # only the tf32x3 route splits its sweep
        assert p.splits == 1
        assert p.scratch_out is p.scratch_ml is None


# (B, Lq, Lk, D): the runs the plan cuts the key sweep into on 132 SMs.
# B = 16 at GMFlow's training grid and its ring slices fills the card;
# B = 1 (the serving grid, its slices) and small ragged calls split.
SPLITS = [
    ((16, 3220, 3220, 2), 1),       # training matching, unsharded
    ((16, 1610, 1610, 2), 1),       # a step of the ring at n = 2
    ((16, 805, 805, 2), 1),         # n = 4
    ((128, 805, 805, 128), 1),      # the training windows, f32
    ((8, 1792, 1792, 128), 1),      # the serving windows, f32
    ((1, 7168, 7168, 2), 7),        # serving matching, unsharded
    ((1, 3584, 3584, 2), 4),        # n = 2
    ((1, 1792, 1792, 2), 7),        # n = 4
    ((1, 2000, 2000, 2), 8),
    ((2, 1001, 1001, 128), 8),
    ((1, 65, 129, 128), 5),         # ragged: 5 key tiles of 32
    ((1, 129, 65, 2), 2)]


@pytest.mark.parametrize("shape,splits", SPLITS)
def test_split_count_and_scratch(shape, splits):
    b, lq, lk, d = shape
    p = tf.plan(b, lq, lk, 128, d, torch.float32)
    assert (p.route, p.splits) == ("tf32x3", splits)
    rows, tile, _ = tf.tf32_blocks(d)
    assert (p.rows, p.tile) == (rows, tile)
    assert p.scratch_out == ((splits, b, lq, d) if splits > 1 else None)
    assert p.scratch_ml == ((splits, b, lq, 2) if splits > 1 else None)
    # the kernel's own rule (tiles_per_split in csrc/tf32x3.cuh): runs of
    # ceil(tiles / splits) whole tiles, none empty
    tiles = -(-lk // tile)
    per = -(-tiles // splits)
    assert 1 <= splits <= min(tf.MAX_SPLITS, tiles)
    assert -(-tiles // per) == splits


@pytest.mark.parametrize("b,l", [(1, 64), (1, 1000), (4, 777), (1, 9000),
                                 (3, 65), (1, 7169), (16, 1610)])
@pytest.mark.parametrize("d", [2, 128])
def test_splits_only_below_one_wave_and_never_empty(b, l, d):
    """The sweep splits only where the blocks hold less than one wave of
    the card's slots, every split leaves no run empty, and fewer SMs never
    ask for fewer runs."""
    p = tf.plan(b, l, l, 128, d, torch.float32)
    slots = tf.H100_SMS * p.blocks_per_sm
    blocks = b * -(-l // p.rows)
    tiles = -(-l // p.tile)
    if blocks >= slots:
        assert p.splits == 1
    per = -(-tiles // p.splits)
    assert -(-tiles // per) == p.splits
    small = tf.plan(b, l, l, 128, d, torch.float32, sms=66)
    assert small.splits <= p.splits


@pytest.mark.parametrize("d", [2, 128])
def test_shared_memory_fits_the_blocks_an_sm(d):
    p = tf.plan(16, 3220, 3220, 128, d, torch.float32)
    assert p.smem == tf.tf32_smem(d)
    assert p.smem <= 232448                    # a block's limit, 227 KB
    assert p.blocks_per_sm == (2 if d == 2 else 1)
    assert p.blocks_per_sm * (p.smem + tf.SMEM_RESERVED) <= tf.SMEM_SM
    # the C side's FwdCfg: 64 rows + 2 stages of 64 keys (D = 2), 128 + 2
    # x 32 with V's rows (D = 128), rows of 132 floats
    assert p.smem == (102400 if d == 2 else 135168)


# GMFlow at 256 channels' eight flash classes (``chip_smoke.py``'s
# FLASH256_SHAPES and FLASH256_TRAIN_SHAPES: Sintel serving 448x1024 at
# 1/8, the training recipe's batch 16 of 368x560): name, (B, L, D)
GMFLOW256_CLASSES = [
    ("serving windows", (8, 1792, 256)),
    ("serving windows + Swin", (8, 1792, 256)),
    ("serving matching", (1, 7168, 2)),
    ("serving propagation", (1, 7168, 2)),
    ("training windows", (128, 805, 256)),
    ("training windows + Swin", (128, 805, 256)),
    ("training matching", (16, 3220, 2)),
    ("training propagation", (16, 3220, 2))]


@pytest.mark.parametrize("name,shape", GMFLOW256_CLASSES)
def test_gmflow256_classes_take_wgmma_unsplit(name, shape):
    """Every flash call of GMFlow at 256 channels takes the wgmma route,
    unsplit, forward and backward: two warpgroups (128 queries) a block at
    D = 256, one (64) at D = 2, 64-key tiles, the blocks' shared memory
    :func:`wgmma_smem`'s."""
    b, l, d = shape
    p = tf.plan(b, l, l, 256, d, torch.bfloat16)
    assert (p.route, p.splits, p.c_pad, p.d_pad) == ("wgmma", 1, 256, d)
    assert p.scratch_out is p.scratch_ml is None
    wgs = 2 if d == 256 else 1
    assert (p.rows, p.tile) == (64 * wgs, 64)
    assert p.smem == tf.wgmma_smem(256, d, wgs)
    pb = tb.plan(b, l, l, 256, d, torch.bfloat16)
    assert pb.route_dq == pb.route_dkv == "wgmma"
    # the same with a dense bias: two warpgroups at D = 256 either way
    assert tf.plan(b, l, l, 256, d, torch.bfloat16, bias=True) == p


# GMFlow at 512 channels' classes, as GMFLOW256_CLASSES (``chip_smoke.py``'s
# FLASH512_SHAPES and FLASH512_TRAIN_SHAPES)
GMFLOW512_CLASSES = [(name, (b, l, 512 if d == 256 else d))
                     for name, (b, l, d) in GMFLOW256_CLASSES]


@pytest.mark.parametrize("name,shape", GMFLOW512_CLASSES)
def test_gmflow512_classes_take_wgmma_unsplit(name, shape):
    """GMFlow at 512 channels' twelve classes of the two wgmma kernels
    take that route, unsplit: the forward at all eight (two warpgroups of
    64 queries a block and two 256-column chunks of the output at D = 512,
    one warpgroup at D = 2; 64-key tiles; the blocks' shared memory
    :func:`wgmma_smem`'s), dq and dk/dv at the training four (and at the
    serving ones, which no path differentiates)."""
    b, l, d = shape
    p = tf.plan(b, l, l, 512, d, torch.bfloat16)
    assert (p.route, p.splits, p.c_pad, p.d_pad) == ("wgmma", 1, 512, d)
    assert p.scratch_out is p.scratch_ml is None
    wgs = 2 if d == 512 else 1
    assert (p.rows, p.tile, p.chunks) == (64 * wgs, 64, 2 if d == 512 else 1)
    assert p.smem == tf.wgmma_smem(512, d, wgs)
    pb = tb.plan(b, l, l, 512, d, torch.bfloat16)
    assert (pb.route_dq, pb.route_dkv) == ("wgmma", "wgmma")
    assert (pb.splits_dq, pb.splits_dkv) == (1, 1)
    assert tf.plan(b, l, l, 512, d, torch.bfloat16, bias=True) == p


def test_forward_and_backward_share_one_width_predicate():
    """One predicate names the wgmma widths of the forward, dq and dk/dv,
    and at every C, D in 1..256 (steps of 5, and every padded edge) and at
    the edges of 512 all three name the same bf16 route."""
    assert tb.wgmma_widths is tf.wgmma_widths
    assert not hasattr(tb, "dq_wgmma_widths")
    widths = sorted(set(range(1, 257, 5)) | {2, 16, 17, 128, 129, 240, 241,
                                              255, 256, 497, 512, 513})
    for c in widths:
        for d in widths:
            f = tf.plan(3, 200, 200, c, d, torch.bfloat16).route
            pb = tb.plan(3, 200, 200, c, d, torch.bfloat16)
            assert f == pb.route_dkv == pb.route_dq
            assert (f == "wgmma") == tf.wgmma_widths(3, 200, 200, c, d)
    assert tf.wgmma_widths(3, 200, 200, 512, 512)
    assert tf.wgmma_widths(3, 200, 200, 512, 2)
    assert tf.wgmma_widths(3, 200, 200, 256, 256)
    # rows past int32 in TMA's coordinates leave the route
    assert not tf.wgmma_widths(2 ** 16, 2 ** 15, 2 ** 15, 256, 256)
    assert not tf.wgmma_widths(2 ** 16, 2 ** 15, 2 ** 15, 512, 512)


@pytest.mark.parametrize("w,d", [(128, 128), (128, 2), (256, 256),
                                 (256, 2), (512, 512), (512, 2)])
@pytest.mark.parametrize("bias", [False, True])
def test_wgmma_blocks_fit_an_sm(w, d, bias):
    """The forward's wgmma blocks (``sm90::FwdSmem``, mirrored by
    :func:`wgmma_smem`) at every (W, D, bias) instance: within a block's
    227 KB, and as many blocks an SM as the route counts on (one at D = W,
    two at W = 256 with D = 2, four at W = 128 with D = 2, one at W = 512
    with D = 2). The byte counts, from the layout: per warpgroup Q's W /
    64 panels of 8 KB, two ring stages of K's and of V's panels (V's 64
    bf16 pairs at D = 2, 256 bytes a stage), the 40 bytes of mbarriers
    rounded with the pairs to 1 KB, 1 KB of slack; at W = D = 512 one
    stage of K's 8 panels and of V's chunk's 4, the 40 bytes of mbarriers
    rounded to 1 KB."""
    for b, l in ((8, 1792), (128, 805), (1, 7168), (16, 3220)):
        wgs = tf.wgmma_warpgroups(b, l, w, d, bias)
        smem = tf.wgmma_smem(w, d, wgs)
        assert tf.plan(b, l, l, w, d, torch.bfloat16, bias=bias).smem == smem
        assert smem <= 232448
        per_sm = {(128, 2): 4, (256, 2): 2}.get((w, d), 1)
        assert per_sm * (smem + tf.SMEM_RESERVED) <= tf.SMEM_SM
        panels = w // 64 * 8192
        if (w, d) == (512, 512):
            assert wgs == 2
            assert smem == (wgs + 1) * panels + 4 * 8192 + 1024 + 1024
            continue
        ring_v = 2 * panels if d != 2 else 0
        assert smem == (wgs + 2) * panels + ring_v + 1024 + 1024
    assert tf.wgmma_smem(256, 256, 2) == 198656
    assert tf.wgmma_smem(256, 2, 1) == 100352
    assert tf.wgmma_smem(128, 128, 3) == 116736
    assert tf.wgmma_smem(512, 512, 2) == 231424
    assert tf.wgmma_smem(512, 2, 1) == 198656


def test_split_count_and_tf32_products_are_shared_with_the_backward():
    """One copy of the split count, the tf32x3 blocks, the split-TF32
    products and the routes' codes: the backward takes the forward's."""
    assert tb.split_count is tf.split_count
    assert tb.tf32_blocks is tf.tf32_blocks
    assert tb.matmul_tf32 is tf.matmul_tf32
    assert tb.ROUTES is tf.ROUTES


def _jax_ref(q, k, v, bias=None):
    """JAX's dense f32 oracle and the LSE of its scores."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = flash_softmax_matmul_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), bias=bias)
    s = jnp.einsum("blc,bmc->blm", q, k) * scale
    if bias is not None:
        s = s + bias
    return np.asarray(out), np.asarray(jax.nn.logsumexp(s, axis=-1))


def _case(seed, b, lq, lk, d, payload):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, 128)).astype(np.float32)
    k = rng.normal(size=(b, lk, 128)).astype(np.float32)
    if payload == "grid":          # the matching grid of a map 16 wide
        t = np.arange(lk)
        v = np.tile(np.stack([t % 16, t // 16], -1)[None], (b, 1, 1))
    elif payload == "flow":        # a flow in [-60, 60] px
        v = rng.uniform(-60, 60, size=(b, lk, 2))
    else:
        v = rng.normal(size=(b, lk, d))
    return q, k, v.astype(np.float32)


def _assert_within(out, lse, want, want_lse, v):
    """The card checks' f32 tolerance: 1e-4 of max|v| for the output,
    1e-4 + 1e-6|ref| for the LSE."""
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-4 * np.abs(v).max())
    np.testing.assert_allclose(lse, want_lse, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("b,lq,lk,d,payload", [
    (2, 150, 150, 2, "grid"), (1, 200, 200, 2, "flow"),
    (1, 200, 200, 128, "normal"), (2, 65, 129, 128, "normal"),
    (1, 129, 65, 2, "flow")])
def test_tf32x3_arithmetic_matches_jax_dense_ref(b, lq, lk, d, payload):
    """The route's split-TF32 arithmetic (the CPU model) against JAX's
    dense f32 oracle, within the card checks' tolerance: the matching
    grid and flow payloads at D = 2, D = 128, ragged lengths."""
    q, k, v = _case(6, b, lq, lk, d, payload)
    want, want_lse = _jax_ref(q, k, v)
    out, lse = tf.flash_softmax_matmul_tf32(
        *(torch.from_numpy(x) for x in (q, k, v)), with_lse=True)
    _assert_within(out.numpy(), lse.numpy(), want, want_lse, v)


@pytest.mark.parametrize("d", [2, 128])
def test_tf32x3_arithmetic_with_swin_matches_jax(d):
    """With the Swin mask, as the JAX side builds it (split windows, the
    dense shifted-window mask as a bias)."""
    rng = np.random.default_rng(7)
    h, w, nk = 8, 12, 2
    wh, ww = h // nk, w // nk
    x = rng.normal(size=(2, 2, h, w, 128)).astype(np.float32)
    qs, ks = (np.array(split_feature(jnp.asarray(t), nk)).reshape(
        -1, wh * ww, 128) for t in x)
    vs = rng.normal(size=(qs.shape[0], wh * ww, d)).astype(np.float32) \
        * (30 if d == 2 else 1)
    bias = np.tile(np.asarray(shift_window_attn_mask(h, w, wh, ww, wh // 2,
                                                     ww // 2)), (2, 1, 1))
    want, want_lse = _jax_ref(qs, ks, vs, jnp.asarray(bias))
    out, lse = tf.flash_softmax_matmul_tf32(
        *(torch.from_numpy(t) for t in (qs, ks, vs)),
        swin=(nk, wh, ww, wh // 2, ww // 2), with_lse=True)
    _assert_within(out.numpy(), lse.numpy(), want, want_lse, vs)


def _split_then_merge(q, k, v, runs, tile):
    """The split sweep's arithmetic: each run of whole key tiles keeps its
    base-2 running max m, its denominator l and its unnormalised output
    (the kernel's partials); the merge takes M = max m, L = sum l 2^(m -
    M), out = sum O 2^(m - M) / L and lse = M ln 2 + log L, in run order."""
    tiles = -(-k.shape[1] // tile)
    per = -(-tiles // runs)
    scale2 = float(np.float32(1 / math.sqrt(128)) * np.float32(tf.LOG2E))
    parts = []
    for r in range(runs):
        ks = slice(r * per * tile, min((r + 1) * per * tile, k.shape[1]))
        s = tf.matmul_tf32(q, k[:, ks].transpose(1, 2)) * scale2
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        o = torch.matmul(p, v[:, ks]) if v.shape[2] == 2 \
            else tf.matmul_tf32(p, v[:, ks])
        parts.append((m, p.sum(-1, keepdim=True), o))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    den, acc = 0.0, 0.0
    for m, l, o in parts:
        wgt = torch.exp2(m - big)
        den = den + l * wgt
        acc = acc + o * wgt
    den = torch.clamp(den, min=1e-30)
    return acc / den, (big * math.log(2.0) + torch.log(den))[..., 0]


@pytest.mark.parametrize("b,l,d", [(1, 2000, 2), (2, 1001, 128),
                                   (1, 129, 2)])
def test_split_then_merge_matches_unsplit(b, l, d):
    """The plan's runs of a split sweep, merged the kernel's way, give the
    unsplit result (and JAX's) within the card checks' tolerance; leaving
    the last run out does not."""
    p = tf.plan(b, l, l, 128, d, torch.float32)
    assert p.splits > 1
    q, k, v = _case(8, b, l, l, d, "flow" if d == 2 else "normal")
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = _split_then_merge(tq, tk, tv, p.splits, p.tile)
    whole, whole_lse = tf.flash_softmax_matmul_tf32(tq, tk, tv,
                                                    with_lse=True)
    _assert_within(out.numpy(), lse.numpy(), whole.numpy(),
                   whole_lse.numpy(), v)
    want, want_lse = _jax_ref(q, k, v)
    _assert_within(out.numpy(), lse.numpy(), want, want_lse, v)
    # the planted fault of chip_smoke.py [3e]: the last run left out
    per = -(-(-(-l // p.tile)) // p.splits)           # tiles a run
    keep = (p.splits - 1) * per * p.tile
    cut, _ = _split_then_merge(tq, tk[:, :keep], tv[:, :keep], p.splits - 1,
                               p.tile)
    assert float((cut - whole).abs().max()) > 1e-4 * np.abs(v).max()


@pytest.mark.parametrize("d", [2, 128])
def test_hi_only_tf32_reading(d):
    """For information (``pytest -s`` prints it): how far hi-only TF32
    products (``terms=1``) lie from JAX's oracle, against the tolerance;
    the three-term products lie far closer."""
    q, k, v = _case(9, 2, 300, 300, d, "grid" if d == 2 else "normal")
    want, want_lse = _jax_ref(q, k, v)
    tol = 1e-4 * np.abs(v).max()
    ratios = []
    for terms in (3, 1):
        out, lse = tf.flash_softmax_matmul_tf32(
            *(torch.from_numpy(x) for x in (q, k, v)), with_lse=True,
            terms=terms)
        ratios.append((float(np.abs(out.numpy() - want).max() / tol),
                       float((np.abs(lse.numpy() - want_lse)
                              / (1e-4 + 1e-6 * np.abs(want_lse))).max())))
    print(f"D = {d}: |d| / tolerance, out and LSE: three terms "
          f"{ratios[0][0]:.4f}, {ratios[0][1]:.4f}; hi only {ratios[1][0]:.3f}"
          f", {ratios[1][1]:.3f}")
    assert max(ratios[0]) <= 0.1
    assert max(ratios[1]) > 10 * max(ratios[0])
