"""The flash backward's launch plan and the tf32x3 route's arithmetic
(``ops/flash_bwd.py``), on the CPU.

:func:`plan` is host arithmetic: the route by dtype and width, the split
sweeps, the scratch shapes and the shared memory are checked here for the
shapes the port's paths pass (GMFlow's training and serving matching
grids, the sequence-parallel ring's slices, the windows). The route's
split-TF32 products cannot run here; :func:`flash_backward_tf32` repeats
their rounding in plain PyTorch, and is held against the plain f32
backward and against the VJP of JAX's dense f32 oracle. Inputs come from
numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.ops.flash import (
    _swin_mask_dense, flash_softmax_matmul_ref)
from opticalflowfromdepth_torch.ops import flash as tf
from opticalflowfromdepth_torch.ops import flash_bwd as tb

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype,c,d,route", [
    (torch.bfloat16, 128, 128, "wgmma"),
    (torch.bfloat16, 128, 2, "wgmma"),
    (torch.bfloat16, 64, 16, "mma_sync"),
    (torch.bfloat16, 128, 16, "mma_sync"),
    # C = 256: the wgmma route where the widths pad to C = 256 and D = 256
    # or 2, mma.sync at every other width
    (torch.bfloat16, 256, 256, "wgmma"),
    (torch.bfloat16, 256, 2, "wgmma"),
    (torch.bfloat16, 250, 1, "wgmma"),          # pads to 256 x 2
    (torch.bfloat16, 241, 250, "wgmma"),        # pads to 256 x 256
    (torch.bfloat16, 256, 128, "mma_sync"),
    (torch.bfloat16, 192, 256, "mma_sync"),
    (torch.bfloat16, 240, 2, "mma_sync"),
    (torch.bfloat16, 256, 16, "mma_sync"),
    # C = 512: the wgmma route of both kernels where the widths pad to C =
    # 512 and D = 512 or 2 (GMFlow at 512 channels)
    (torch.bfloat16, 512, 512, "wgmma"),
    (torch.bfloat16, 512, 2, "wgmma"),
    (torch.bfloat16, 511, 2, "wgmma"),          # pads to 512 x 2
    (torch.bfloat16, 511, 512, "wgmma"),        # pads to 512 x 512
    (torch.bfloat16, 497, 500, "wgmma"),        # pads to 512 x 512
    (torch.bfloat16, 512, 256, "mma_sync"),
    (torch.bfloat16, 384, 384, "mma_sync"),
    (torch.float32, 512, 512, "f32"),
    (torch.float32, 256, 256, "f32"),
    (torch.float32, 256, 2, "f32"),
    (torch.float32, 128, 128, "tf32x3"),
    (torch.float32, 128, 2, "tf32x3"),
    (torch.float32, 64, 16, "f32"),
    (torch.float32, 128, 64, "f32"),
    (torch.float32, 32, 2, "f32")])
def test_route_by_dtype_and_width(dtype, c, d, route):
    """``route`` is both kernels': dq's and dk/dv's, at every width."""
    p = tb.plan(2, 300, 300, c, d, dtype)
    assert p.route_dkv == route
    assert p.route_dq == route
    assert route in tb.ROUTES
    if route != "tf32x3":       # only the tf32x3 route splits its sweeps
        assert (p.splits_dq, p.splits_dkv) == (1, 1)
        assert p.scratch_dq is p.scratch_dk is p.scratch_dv is None


@pytest.mark.parametrize("c,d", [(511, 2), (512, 2), (511, 512),
                                 (512, 512)])
def test_dq_takes_wgmma_at_512(c, d):
    """bf16 widths that pad to C = 512 with D = 512 or 2 put dq on the
    wgmma route, as dk/dv, unsplit, at the padded widths."""
    p = tb.plan(3, 200, 200, c, d, torch.bfloat16)
    assert (p.route_dq, p.route_dkv) == ("wgmma", "wgmma")
    assert (p.c_pad, p.d_pad) == (512, d)
    assert (p.splits_dq, p.splits_dkv) == (1, 1)
    assert p.scratch_dq is None


@pytest.mark.parametrize("c,d", [(512, 256), (384, 384), (384, 2),
                                 (512, 384)])
def test_other_wide_widths_stay_on_mma_sync(c, d):
    """Past 256, only C = 512 with D = 512 or 2 takes wgmma: C = 512 with
    D = 256 or 384 and C = 384 keep the mma.sync route for both kernels."""
    p = tb.plan(3, 200, 200, c, d, torch.bfloat16)
    assert (p.route_dq, p.route_dkv) == ("mma_sync", "mma_sync")


# GMFlow at 512 channels' training step (batch 16 of 368x560): its four
# classes of flash backward calls (B, L, D)
GMFLOW512_TRAIN = [("windows", (128, 805, 512)),
                   ("windows + Swin", (128, 805, 512)),
                   ("matching", (16, 3220, 2)),
                   ("propagation", (16, 3220, 2))]


@pytest.mark.parametrize("name,shape", GMFLOW512_TRAIN)
def test_gmflow512_training_classes_plan_wgmma_for_both_kernels(name, shape):
    """Every flash backward call of GMFlow-512's training step plans the
    wgmma route for dq and for dk/dv, unsplit, at its own widths."""
    b, l, d = shape
    p = tb.plan(b, l, l, 512, d, torch.bfloat16)
    assert (p.route_dq, p.route_dkv) == ("wgmma", "wgmma")
    assert (p.splits_dq, p.splits_dkv, p.c_pad, p.d_pad) == (1, 1, 512, d)
    assert p.scratch_dq is p.scratch_dk is p.scratch_dv is None


# (B, Lq, Lk, D): splits (dq, dk/dv) the plan gives on 132 SMs. B = 16 at
# GMFlow's training grid and its ring slices fills the card; B = 1 (the
# serving grid, its slices) and the ring's small ragged slices split.
SPLITS = [
    ((16, 3220, 3220, 2), (1, 1)),      # training matching, unsharded
    ((16, 1610, 1610, 2), (1, 1)),      # a step of the ring at n = 2
    ((16, 805, 805, 2), (1, 1)),        # n = 4
    ((128, 805, 805, 128), (1, 1)),     # the training windows, f32
    ((1, 7168, 7168, 2), (7, 7)),       # serving matching, unsharded
    ((1, 3584, 3584, 2), (4, 4)),       # n = 2
    ((1, 1792, 1792, 2), (7, 7)),       # n = 4
    ((1, 2000, 2000, 2), (8, 8)),
    ((2, 1001, 1001, 128), (8, 8)),
    ((1, 65, 129, 128), (5, 3)),        # ragged: 5 key tiles of 32
    ((1, 129, 65, 2), (2, 3))]


@pytest.mark.parametrize("shape,splits", SPLITS)
def test_split_count_and_scratch(shape, splits):
    b, lq, lk, d = shape
    p = tb.plan(b, lq, lk, 128, d, torch.float32)
    assert (p.route_dq, p.route_dkv, p.splits_dq, p.splits_dkv) == (
        "tf32x3", "tf32x3", *splits)
    rows, tile, _ = tb.tf32_blocks(d)
    assert (p.rows, p.tile) == (rows, tile)
    s_dq, s_dkv = splits
    assert p.scratch_dq == ((s_dq, b, lq, 128) if s_dq > 1 else None)
    assert p.scratch_dk == ((s_dkv, b, lk, 128) if s_dkv > 1 else None)
    assert p.scratch_dv == ((s_dkv, b, lk, d) if s_dkv > 1 else None)
    # the kernels' own rule (tiles_per_split in csrc/flash_bwd.cu): runs of
    # ceil(tiles / splits) whole tiles, none empty
    for n, other in ((s_dq, lk), (s_dkv, lq)):
        tiles = -(-other // tile)
        per = -(-tiles // n)
        assert 1 <= n <= min(tf.MAX_SPLITS, tiles)
        assert -(-tiles // per) == n


@pytest.mark.parametrize("b,l", [(1, 64), (1, 1000), (4, 777), (1, 9000),
                                 (3, 65), (1, 7169)])
@pytest.mark.parametrize("d", [2, 128])
def test_splits_only_below_one_wave_and_never_empty(b, l, d):
    """A sweep splits only where its blocks hold less than one wave of the
    card's slots, and every split count the plan gives leaves no run
    empty; fewer SMs never ask for fewer runs."""
    p = tb.plan(b, l, l, 128, d, torch.float32)
    slots = tb.H100_SMS * p.blocks_per_sm
    blocks = b * -(-l // p.rows)
    tiles = -(-l // p.tile)
    if blocks >= slots:
        assert p.splits_dq == p.splits_dkv == 1
    per = -(-tiles // p.splits_dq)
    assert -(-tiles // per) == p.splits_dq
    small = tb.plan(b, l, l, 128, d, torch.float32, sms=66)
    assert small.splits_dq <= p.splits_dq


@pytest.mark.parametrize("d", [2, 128])
def test_shared_memory_fits_the_blocks_an_sm(d):
    p = tb.plan(16, 3220, 3220, 128, d, torch.float32)
    assert p.smem == (tb.tf32_smem(d, False), tb.tf32_smem(d, True))
    assert max(p.smem) <= 232448              # a block's limit, 227 KB
    assert p.blocks_per_sm == (2 if d == 2 else 1)
    assert p.blocks_per_sm * (max(p.smem) + tb.SMEM_RESERVED) <= tb.SMEM_SM
    # the C side's Cfg: 64 rows + 2 stages of 64 (D = 2), 128 + 2 x 32
    assert p.smem == ((102400, 103424) if d == 2 else (202752, 203264))


def test_split_tf32_reconstructs_f32():
    """hi is x rounded to TF32 (10 mantissa bits, ties away from zero),
    within 2^-11 of |x|; hi + lo, lo as the tensor cores read it, within
    2^-21 (for |x| whose lo is a normal number, above ~2^-100)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.concatenate([
        rng.normal(size=20000) * 10.0 ** rng.integers(-6, 6, 20000),
        [1.0, -1.0, 1.5, 2 ** -20, 2 ** -90]]).astype(np.float32))
    hi, lo = tf.split_tf32(x)
    low = (hi.view(torch.int32) & 0x1FFF) | (lo.view(torch.int32) & 0x1FFF)
    assert int(low.abs().max()) == 0           # both TF32 bit patterns
    assert float(((hi - x).abs() / x.abs()).max()) <= 2 ** -11
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2 ** -21
    # ties away from zero: 1 + 2^-11 (half a TF32 step above 1) rounds up
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)], dtype=torch.float32)
    assert tf.split_tf32(tie)[0].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10)]


def _case(seed, b, l, d):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(b, l, 128)).astype(np.float32)
            for _ in range(2))
    v = (rng.normal(size=(b, l, d)) * (30 if d == 2 else 1)).astype(
        np.float32)
    g = rng.normal(size=(b, l, d)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("b,l,d,swin", [
    (2, 150, 2, None), (1, 200, 128, None),
    (8, 24, 128, (2, 4, 6, 2, 3)), (8, 24, 2, (2, 4, 6, 2, 3))])
def test_tf32x3_arithmetic_within_the_f32_tolerance(b, l, d, swin):
    """The route's split-TF32 products (the CPU model) within the card
    checks' 1e-4 of each gradient's max of the plain f32 backward, well
    inside it; hi-only TF32 products (terms=1) are not."""
    q, k, v, g = (torch.from_numpy(x) for x in _case(4, b, l, d))
    out, lse = tf.flash_softmax_matmul_plain(q, k, v, swin=swin,
                                             with_lse=True)
    ref = tb.flash_backward_plain(q, k, v, out, lse, g, swin=swin)
    three = tb.flash_backward_tf32(q, k, v, out, lse, g, swin=swin)
    one = tb.flash_backward_tf32(q, k, v, out, lse, g, swin=swin, terms=1)
    tols = [1e-4 * float(r.abs().max()) for r in ref]
    r3 = [float((x - r).abs().max()) / t for x, r, t in zip(three, ref, tols)]
    r1 = [float((x - r).abs().max()) / t for x, r, t in zip(one, ref, tols)]
    assert max(r3) <= 0.1, r3
    assert max(r1) > 1.0, r1


@pytest.mark.parametrize("d", [2, 128])
def test_tf32x3_arithmetic_matches_jax_dense_vjp(d):
    """The CPU model of the route against the VJP of JAX's dense f32
    oracle, residuals from the port's f32 forward: the card checks'
    1e-4 of each gradient's max."""
    b, l, swin = 8, 24, (2, 4, 6, 2, 3)
    q, k, v, g = _case(5, b, l, d)
    bias = _swin_mask_dense(l, swin, b)
    _, vjp = jax.vjp(lambda a, b_, c_: flash_softmax_matmul_ref(
        a, b_, c_, bias=bias), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = tf.flash_softmax_matmul(tq, tk, tv, swin=swin, with_lse=True)
    got = tb.flash_backward_tf32(tq, tk, tv, out, lse, tg, swin=swin)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(x.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_flash_bwd_variants_change_only_the_recompute():
    """``tools/flash_bwd_variants.py``'s sources: ``as_is`` is the kernel's
    source; ``half_s`` differs from it in the dk/dv kernel's S^T and dP^T
    products alone, each taken over half of C and D; another name
    raises."""
    import difflib

    from opticalflowfromdepth_torch import _build
    from opticalflowfromdepth_torch.tools import flash_bwd_variants as fv

    src = (_build.CSRC / "flash_bwd.cu").read_text()
    assert fv.variant_source(src, "as_is") == src
    half = fv.variant_source(src, "half_s")
    changed = [line for line in difflib.unified_diff(
        src.splitlines(), half.splitlines(), lineterm="", n=0)
        if line[:1] in "+-" and line[:3] not in ("+++", "---")]
    assert changed == ["-" + line.rstrip("\n") for line in fv.PRODUCTS] + [
        "+" + line.rstrip("\n").replace("product_c<W, ", "product_c<W / 2, ")
        for line in fv.PRODUCTS]
    with pytest.raises(ValueError):
        fv.variant_source(src, "half")


@pytest.mark.parametrize("name", ["dq_half_s", "dq_no_dq", "dq_no_exp"])
def test_flash_bwd_dq_variants_change_only_their_lines(name):
    """``tools/flash_bwd_variants.py``'s C = 512 variants of the dq kernel:
    each differs from the kernel's source in its own lines alone (each
    found as often as it says), and the tool names them at ``--width
    512`` after ``as_is``."""
    import difflib

    from opticalflowfromdepth_torch import _build
    from opticalflowfromdepth_torch.tools import flash_bwd_variants as fv

    src = (_build.CSRC / "flash_bwd.cu").read_text()
    assert fv.VARIANTS[512] == ("as_is", "dq_half_s", "dq_no_dq",
                                "dq_no_exp")
    got = fv.variant_source(src, name)
    removed = [line[1:] for line in difflib.unified_diff(
        src.splitlines(), got.splitlines(), lineterm="", n=0)
        if line[:1] == "-" and line[:3] != "---"]
    added = [line[1:] for line in difflib.unified_diff(
        src.splitlines(), got.splitlines(), lineterm="", n=0)
        if line[:1] == "+" and line[:3] != "+++"]
    # each changed line is a line of the source with one piece of a
    # variant's lines put for another
    pieces = []
    for old, new, count in fv.DQ_VARIANTS[name]:
        assert src.count(old) == count
        pieces += [(a, b) for a, b in zip(old.split("\n"), new.split("\n"))
                   if a != b] * count
    assert len(removed) == len(added) == len(pieces)
    for line, new_line in zip(removed, added):
        assert any(a in line and line.replace(a, b) == new_line
                   for a, b in pieces), (line, new_line)
