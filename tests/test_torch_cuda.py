"""The port's Hopper kernels against their plain versions, on the card,
forward and backward (the 3x3 conv's Function also against autograd
through ``F.conv2d``; the forward warp bit for bit), one training step of
each model card against CPU, the synthesis card against CPU, and the
bilateral filter and the profiling helpers on the card.

Marked ``cuda``: they skip on a host without a CUDA device. On the card
they run without the JAX test setup:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import ctypes

import numpy as np
import pytest
import torch

from opticalflowfromdepth_torch.models.gmflow import GMFlow
from opticalflowfromdepth_torch.models.raft import RAFT
from opticalflowfromdepth_torch.ops import conv2d as cv
from opticalflowfromdepth_torch.ops import flash as fl
from opticalflowfromdepth_torch.ops import flash_bwd as fb
from opticalflowfromdepth_torch.ops import forward_warp as fw
from opticalflowfromdepth_torch.ops import fused_corr as fc
from opticalflowfromdepth_torch.ops import instance_norm as inorm
from opticalflowfromdepth_torch.synth import pipeline as sp

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("levels,radius,h,w", [(4, 4, 12, 16), (2, 3, 7, 9)])
def test_fused_corr_kernel_matches_plain(card, dtype, atol, levels, radius,
                                         h, w):
    g = torch.Generator().manual_seed(0)
    b, c = 2, 64
    f1 = torch.randn(b, h * w, c, generator=g).to(card, dtype)
    f2 = torch.randn(b, h, w, c, generator=g).to(card)
    coords = (torch.rand(b, h * w, 2, generator=g) * 30 - 8).to(card)
    f2cat = fc.corr_levels_cat(f2, levels, dtype)
    before = fc.fused_corr_lookup_cat.launches
    got = fc.fused_corr_lookup_cat(f1, f2cat, coords, h, w, levels, radius)
    torch.cuda.synchronize()
    assert fc.fused_corr_lookup_cat.launches == before + 1
    ref = fc.fused_corr_lookup_cat_plain(f1, f2cat, coords, h, w, levels,
                                         radius)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol,
                               rtol=atol)


def _valid_rows(h, w, levels):
    rows = []
    for (hl, wl, hp, off) in fc.cat_meta(h, w, levels):
        for x in range(wl):
            rows.extend(off + x * hp + y for y in range(hl))
    return rows


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("levels,radius,h,w", [(4, 4, 12, 16), (2, 3, 7, 9)])
def test_fused_corr_bwd_kernel_matches_plain(card, dtype, atol, levels,
                                             radius, h, w):
    """Through autograd: the backward kernel against the plain backward.
    f32: the kernel sums in its own fixed order, the plain version with a
    matmul, 1e-4; bf16: both round the f32 sums to bf16 once."""
    g = torch.Generator().manual_seed(4)
    b, c = 2, 64
    f1 = torch.randn(b, h * w, c, generator=g).to(card, dtype)
    f2 = torch.randn(b, h, w, c, generator=g).to(card)
    coords = (torch.rand(b, h * w, 2, generator=g) * 30 - 8).to(card)
    f2cat = fc.corr_levels_cat(f2, levels, dtype)
    k2 = (2 * radius + 1) ** 2
    gout = torch.randn(b, h * w, levels * k2, generator=g).to(card, dtype)
    f1.requires_grad_()
    f2cat.requires_grad_()
    before = fc.fused_corr_lookup_cat.bwd_launches
    out = fc.fused_corr_lookup_cat(f1, f2cat, coords, h, w, levels, radius)
    out.backward(gout)
    torch.cuda.synchronize()
    assert fc.fused_corr_lookup_cat.bwd_launches == before + 1
    ref1, ref2 = fc.fused_corr_lookup_cat_bwd_plain(
        gout, f1.detach(), f2cat.detach(), coords, h, w, levels, radius)
    assert f1.grad.dtype == f2cat.grad.dtype == dtype
    np.testing.assert_allclose(f1.grad.float().cpu().numpy(),
                               ref1.float().cpu().numpy(), atol=atol,
                               rtol=atol)
    np.testing.assert_allclose(f2cat.grad.float().cpu().numpy(),
                               ref2.float().cpu().numpy(), atol=atol,
                               rtol=atol)
    pad = sorted(set(range(f2cat.shape[1])) - set(_valid_rows(h, w, levels)))
    assert torch.count_nonzero(f2cat.grad[:, pad]) == 0


def test_fused_corr_bwd_kernel_far_out_of_range_is_zero(card):
    f1 = torch.randn(1, 48, 32, device=card, requires_grad=True)
    f2cat = fc.corr_levels_cat(torch.randn(1, 6, 8, 32, device=card), 4,
                               torch.float32).requires_grad_()
    coords = torch.full((1, 48, 2), 1e4, device=card)
    fc.fused_corr_lookup_cat(f1, f2cat, coords, 6, 8).sum().backward()
    assert torch.count_nonzero(f1.grad) == 0
    assert torch.count_nonzero(f2cat.grad) == 0


@pytest.mark.parametrize("dtype,c,h,w", [
    (torch.bfloat16, 256, 46, 62),     # tensor cores, RAFT-basic's width
    (torch.bfloat16, 128, 13, 5),      # tensor cores, N = 65
    (torch.bfloat16, 64, 7, 9),        # CUDA cores, N = 63, level 3 pooled
    (torch.float32, 256, 12, 16)])     # CUDA cores
def test_fused_corr_bwd_kernel_bit_reproducible(card, dtype, c, h, w):
    """No atomics: two launches on the same inputs give the same bits, on
    both routes; within the tolerance of chip_smoke.py [3c] of the plain
    version, which repeats the route's arithmetic."""
    g_ = torch.Generator().manual_seed(13)
    b = 2
    f1 = torch.randn(b, h * w, c, generator=g_).to(card, dtype)
    f2cat = fc.corr_levels_cat(torch.randn(b, h, w, c, generator=g_).to(
        card), 4, dtype)
    coords = (torch.rand(b, h * w, 2, generator=g_) * (w + 16) - 8).to(card)
    gout = torch.randn(b, h * w, 4 * 81, generator=g_).to(card, dtype)
    first = fc.fused_corr_lookup_cat_bwd(gout, f1, f2cat, coords, h, w)
    second = fc.fused_corr_lookup_cat_bwd(gout, f1, f2cat, coords, h, w)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    ref = fc.fused_corr_lookup_cat_bwd_plain(gout, f1, f2cat, coords, h, w)
    rtol, atol = (0.0, 1e-4) if dtype == torch.float32 else (2 ** -7, 1e-3)
    for x, r in zip(first, ref):
        assert x.dtype == dtype
        d = (x.float() - r.float()).abs()
        assert float((d / (atol + rtol * r.float().abs())).max()) <= 1.0



@pytest.mark.parametrize("dtype,c,radius,levels,h,w", [
    (torch.float32, 4, 4, 4, 12, 16),
    (torch.bfloat16, 36, 4, 4, 12, 16),       # C % 8 != 0: scalar loads
    (torch.float32, 520, 4, 4, 7, 9),         # f1 past its registers
    (torch.bfloat16, 1024, 4, 4, 7, 9),
    (torch.bfloat16, 256, 0, 4, 12, 16),      # tensor cores at radius 0
    (torch.bfloat16, 256, 5, 4, 12, 16),      # past the tensor cores' taps
    (torch.float32, 64, 6, 4, 12, 16),
    (torch.bfloat16, 40, 9, 3, 20, 24),       # two tap blocks a side
    (torch.bfloat16, 256, 4, 9, 12, 16),      # tensor cores, 7 levels empty
    (torch.float32, 128, 4, 12, 12, 16)])
def test_fused_corr_kernels_take_every_operand(card, dtype, c, radius,
                                               levels, h, w):
    """Every C, radius and level count on the route ``route`` names, forward
    and backward within chip_smoke.py [3a]'s and [3c]'s tolerances of the
    plain versions, one launch each, two launches bit-equal; the levels
    pooled to nothing give 0."""
    g = torch.Generator().manual_seed(c + radius + levels)
    b = 2
    f1 = torch.randn(b, h * w, c, generator=g).to(card, dtype)
    f2cat = fc.corr_levels_cat(torch.randn(b, h, w, c, generator=g).to(card),
                               levels, dtype)
    coords = (torch.rand(b, h * w, 2, generator=g) * (w + 16) - 8).to(card)
    k2 = (2 * radius + 1) ** 2
    gout = torch.randn(b, h * w, levels * k2, generator=g).to(card, dtype)
    live = fc.live_levels(fc.cat_meta(h, w, levels))
    assert fc.route(dtype, c, radius, live) == (
        "tensor_cores" if c == 256 and radius <= 4 else "cuda_cores")
    before = (fc.fused_corr_lookup_cat.launches,
              fc.fused_corr_lookup_cat.bwd_launches)
    got = fc.fused_corr_lookup_cat(f1, f2cat, coords, h, w, levels, radius)
    grads = fc.fused_corr_lookup_cat_bwd(gout, f1, f2cat, coords, h, w,
                                         levels, radius)
    assert (fc.fused_corr_lookup_cat.launches,
            fc.fused_corr_lookup_cat.bwd_launches) == (before[0] + 1,
                                                       before[1] + 1)
    again = fc.fused_corr_lookup_cat(f1, f2cat, coords, h, w, levels, radius)
    grads2 = fc.fused_corr_lookup_cat_bwd(gout, f1, f2cat, coords, h, w,
                                          levels, radius)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert all(torch.equal(x, y) for x, y in zip(grads, grads2))
    assert torch.count_nonzero(got[..., live * k2:]) == 0
    ref = fc.fused_corr_lookup_cat_plain(f1, f2cat, coords, h, w, levels,
                                         radius)
    ref_b = fc.fused_corr_lookup_cat_bwd_plain(gout, f1, f2cat, coords, h, w,
                                               levels, radius)
    f32 = dtype == torch.float32
    for x, r, (rtol, atol) in ((got, ref, (0.0, 1e-4) if f32 else (2e-2,
                                                                   2e-2)),
                               *((x, r, (0.0, 1e-4) if f32 else (2 ** -7,
                                                                 1e-3))
                                 for x, r in zip(grads, ref_b))):
        assert x.dtype == dtype and x.shape == r.shape
        d = (x.float() - r.float()).abs()
        assert float((d / (atol + rtol * r.float().abs())).max()) <= 1.0


def test_fused_corr_kernels_take_zero_rows_and_unaligned_views(card):
    """An f2cat of zero rows (every level pooled away) gives zero lookups
    and a zero df1; features that start off a 16-byte boundary are
    copied to one, not refused."""
    f1 = torch.randn(1, 10, 8, device=card)
    f2cat = fc.corr_levels_cat(torch.randn(1, 0, 5, 8, device=card), 3,
                               torch.float32)
    coords = torch.rand(1, 10, 2, device=card) * 4
    out = fc.fused_corr_lookup_cat(f1, f2cat, coords, 0, 5, 3, 2)
    df1, df2 = fc.fused_corr_lookup_cat_bwd(torch.randn_like(out), f1, f2cat,
                                            coords, 0, 5, 3, 2)
    torch.cuda.synchronize()
    assert out.shape == (1, 10, 75) and torch.count_nonzero(out) == 0
    assert torch.count_nonzero(df1) == 0 and df2.shape == (1, 0, 8)
    wide = torch.randn(2, 63, 257, device=card, dtype=torch.bfloat16)
    f1 = wide[:, :, 1:]                     # 2 bytes past the boundary
    assert f1.data_ptr() % 16
    f2cat = fc.corr_levels_cat(torch.randn(2, 7, 9, 256, device=card), 4,
                               torch.bfloat16)
    coords = torch.rand(2, 63, 2, device=card) * 9
    got = fc.fused_corr_lookup_cat(f1, f2cat, coords, 7, 9)
    ref = fc.fused_corr_lookup_cat_plain(f1, f2cat, coords, 7, 9)
    d = (got.float() - ref.float()).abs()
    assert float((d / (2e-2 + 2e-2 * ref.float().abs())).max()) <= 1.0

def _smooth_coords(g, b, h, w):
    """The grid plus a coarse 3x4 field of +- 20 px upsampled bilinearly,
    the columns right of 0.55 w moved 10 px further (chip_smoke.py)."""
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    base = torch.stack([xx, yy], -1).float()[None].repeat(b, 1, 1, 1)
    coarse = (torch.rand(b, 2, 3, 4, generator=g) * 2 - 1) * 20
    flow = torch.nn.functional.interpolate(coarse, size=(h, w),
                                           mode="bilinear",
                                           align_corners=True)
    flow[:, 0, :, int(0.55 * w):] += 10.0
    return (base + flow.permute(0, 2, 3, 1)).reshape(b, h * w, 2)


@pytest.mark.parametrize("c,b,h,w,spread", [
    (256, 2, 23, 31, None),     # smooth flow, ragged tiles at both edges
    (256, 2, 5, 6, 3.0),        # level 3 pooled to nothing
    (128, 1, 9, 80, 40.0),      # boxes overflow: the per-query path
    (256, 1, 9, 80, 1e4)])      # every window out of range
def test_fused_corr_tile_route_matches_plain(card, c, b, h, w, spread):
    """The tensor-core route of the forward (bf16, C = 128 or 256) within
    chip_smoke.py [3a]'s bf16 tolerance of the plain version; the kernel's
    count of the per-query path's pairs equals tile_plan's; two launches
    give the same bits."""
    g = torch.Generator().manual_seed(21)
    f1 = torch.randn(b, h * w, c, generator=g).to(card, torch.bfloat16)
    f2cat = fc.corr_levels_cat(torch.randn(b, h, w, c, generator=g).to(card),
                               4, torch.bfloat16)
    if spread is None:
        coords = _smooth_coords(g, b, h, w)
    else:
        yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w),
                                indexing="ij")
        coords = torch.stack([xx, yy], -1).float().reshape(1, h * w, 2) + (
            torch.rand(b, h * w, 2, generator=g) * 2 - 1) * spread
    coords = coords.to(card)
    got, n_slow = fc.fused_corr_lookup_cat_slow_count(f1, f2cat, coords, h,
                                                      w)
    again = fc.fused_corr_lookup_cat(f1, f2cat, coords, h, w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    planned = sum(int(p["slow"].sum()) for p in
                  fc.tile_plan(coords, h, w) if p)
    assert n_slow == planned and (planned > 0) == (spread == 40.0)
    ref = fc.fused_corr_lookup_cat_plain(f1, f2cat, coords, h, w)
    d = (got.float() - ref.float()).abs()
    assert float((d / (2e-2 + 2e-2 * ref.float().abs())).max()) <= 1.0
    if spread == 1e4:
        assert torch.count_nonzero(got) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [
    (3, 5, 1, 37),              # short odd rows, several a block
    (1, 2, 211, 307),           # a cluster of 8, the last slice ragged
    (2, 96, 110, 256),          # a cluster of 1 (bf16) or 2 (f32)
    (1, 3, 1024, 1024)])        # rows streamed through shared memory twice
def test_instance_norm_kernel_plan_classes(card, dtype, shape):
    """Every plan class within chip_smoke.py [3b]'s tolerances (f16: one
    step of its 10-bit mantissa); two launches give the same bits."""
    g = torch.Generator().manual_seed(2)
    x = (torch.randn(*shape, generator=g) * 3 + 0.5).to(card, dtype)
    first = inorm.instance_norm(x, 1e-5, True)
    second = inorm.instance_norm(x, 1e-5, True)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(first, second))
    y, m, r = first
    yr, mr, rr = inorm.instance_norm_plain(x, 1e-5, True)
    rtol, atol = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2 ** -7, 1e-3),
                  torch.float16: (2 ** -10, 1e-3)}[dtype]
    d = (y.float() - yr.float()).abs()
    assert float((d / (atol + rtol * yr.float().abs())).max()) <= 1.0
    np.testing.assert_allclose(m.cpu().numpy(), mr.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(r.cpu().numpy(), rr.cpu().numpy(), rtol=1e-5)


def test_instance_norm_kernel_takes_unaligned_data(card):
    buf = torch.empty(2 * 64 * 55 * 128 + 8, dtype=torch.bfloat16,
                      device=card)
    x = buf[1:1 + 2 * 64 * 55 * 128].view(2, 64, 55, 128)
    x.copy_(torch.randn(x.shape, generator=torch.Generator().manual_seed(3)))
    assert x.data_ptr() % 16
    y, m, r = inorm.instance_norm(x, 1e-5, False)
    yr, _, _ = inorm.instance_norm_plain(x, 1e-5, False)
    d = (y.float() - yr.float()).abs()
    assert float((d / (1e-3 + 2 ** -7 * yr.float().abs())).max()) <= 1.0


@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_grad_on_card_matches_cpu(card, relu):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 24, 37, 53, generator=g) * 3 + 1
    gy = torch.randn(x.shape, generator=g)
    grads = []
    for dev in ("cpu", card):
        xd = x.detach().to(dev).requires_grad_()
        inorm.instance_norm(xd, 1e-5, relu)[0].backward(gy.to(dev))
        grads.append(xd.grad.cpu().numpy())
    np.testing.assert_allclose(grads[1], grads[0], atol=1e-5, rtol=1e-4)


def _bwd_inputs(card, shape, dtype, relu, seed=11, x=None):
    """g (correlated with the normalised x, so that the ``yhat * mean(g'
    yhat)`` term matters) and the forward kernel's y, mean and rstd on the
    card; x drawn unless given."""
    gen = torch.Generator().manual_seed(seed)
    if x is None:
        x = (torch.randn(*shape, generator=gen) * 3 + 0.5).to(card, dtype)
    y, m, r = inorm.instance_norm(x, 1e-5, relu)
    g = (torch.randn(*shape, generator=gen).to(card)
         + 0.5 * (x.float() - m) * r).to(dtype)
    return g, x, m, r, (y if relu else None)


def _bwd_within(dx, g, x, m, r, y, ref=None):
    """Whether the kernel's ``dx`` is the closed form's on the same
    operands (or ``ref``, another f32 dx of them): its f32 value within
    1e-5 of the terms' size (their sums taken in another order), then, in
    bf16 and f16, at most one step of the dtype apart after the cast, on at
    most 1% of the values (every other value the reference's cast)."""
    if ref is None:
        ref = inorm.instance_norm_bwd(g.float(), x.float(), m, r,
                                      None if y is None else y.float())
    gp = g.float() if y is None else torch.where(y > 0, g.float(), 0.0)
    yhat = (x.float() - m) * r
    mag = r * (gp.abs() + gp.abs().mean((2, 3), keepdim=True)
               + yhat.abs() * (gp * yhat).abs().mean((2, 3), keepdim=True))
    tol = 1e-5 * mag
    d = (dx.float() - ref).abs()
    if dx.dtype == torch.float32:
        return bool((d <= tol).all())
    bits = {torch.bfloat16: 7, torch.float16: 10}[dx.dtype]
    step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(
        min=2 ** -14))) - bits)
    moved = float((dx != ref.to(dx.dtype)).float().mean())
    return bool((d <= tol + step).all()) and moved <= 0.01


# the backward's plan classes (bf16; f32 and f16 cut the same shapes by
# their own item sizes), then GMFlow's and RAFT training's norms
BWD_SHAPES = [
    (3, 5, 1, 37),              # short odd rows, several a block
    (4, 96, 46, 70),            # short rows, 3 a block
    (2, 96, 92, 140),           # a row a block (2 operands), clusters of 2
    (1, 2, 211, 307),           # clusters of 8, the last slice ragged
    (1, 3, 1024, 1024),         # streamed twice
    (32, 64, 184, 280), (32, 96, 92, 140), (32, 128, 46, 70),
    (16, 64, 184, 248), (16, 96, 92, 124), (16, 128, 46, 62)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_instance_norm_bwd_kernel_matches_closed_form(card, shape, relu,
                                                      dtype):
    g, x, m, r, y = _bwd_inputs(card, shape, dtype, relu)
    launches = inorm.instance_norm.bwd_launches
    dx = inorm._instance_norm_bwd_cuda(g, x, m, r, y)
    torch.cuda.synchronize()
    assert inorm.instance_norm.bwd_launches == launches + 1
    assert dx.dtype == dtype and dx.shape == x.shape
    assert _bwd_within(dx, g, x, m, r, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_instance_norm_bwd_kernel_matches_its_partition_of_the_sums(
        card, shape, relu, dtype):
    """The kernel against :func:`bwd_split_sum_plain` under the kernel's
    own plan (its item size and 2 or 3 operands): the same partition of
    the two row sums, so that only the order within a block differs."""
    g, x, m, r, y = _bwd_inputs(card, shape, dtype, relu)
    b, c, h, w = shape
    p = inorm.plan(b * c, h * w, x.element_size(), 3 if relu else 2)
    ref = inorm.bwd_split_sum_plain(g.float(), x.float(), m, r,
                                    None if y is None else y.float(), p)
    dx = inorm._instance_norm_bwd_cuda(g, x, m, r, y)
    assert _bwd_within(dx, g, x, m, r, y, ref)


@pytest.mark.parametrize("shape", [(2, 96, 46, 70), (1, 2, 211, 307),
                                   (32, 64, 184, 280)])
def test_instance_norm_bwd_kernel_bit_reproducible(card, shape):
    g, x, m, r, y = _bwd_inputs(card, shape, torch.bfloat16, True)
    first = inorm._instance_norm_bwd_cuda(g, x, m, r, y)
    second = inorm._instance_norm_bwd_cuda(g, x, m, r, y)
    assert torch.equal(first, second)


def test_instance_norm_bwd_kernel_takes_unaligned_and_strided_operands(
        card):
    """x off the 16-byte grid and a g that is not contiguous: each copied
    once (counted), then the kernel."""
    shape = (2, 64, 55, 128)
    n = int(np.prod(shape))
    buf = torch.empty(n + 8, dtype=torch.bfloat16, device=card)
    x = buf[1:1 + n].view(shape)
    x.copy_(torch.randn(shape, generator=torch.Generator().manual_seed(3)))
    assert x.data_ptr() % 16
    g, _, m, r, y = _bwd_inputs(card, shape, torch.bfloat16, True, x=x)
    g = g.transpose(2, 3).contiguous().transpose(2, 3)
    assert not g.is_contiguous()
    copies = inorm.instance_norm.bwd_copies
    dx = inorm._instance_norm_bwd_cuda(g, x, m, r, y)
    assert inorm.instance_norm.bwd_copies == copies + 2
    assert dx.is_contiguous() and _bwd_within(dx, g, x, m, r, y)


def test_instance_norm_bwd_kernel_refuses_what_it_does_not_take(card):
    g, x, m, r, y = _bwd_inputs(card, (2, 8, 12, 10), torch.bfloat16, True)
    with pytest.raises(ValueError):
        inorm._instance_norm_bwd_cuda(g.float(), x, m, r, y)
    with pytest.raises(ValueError):
        inorm._instance_norm_bwd_cuda(g, x, m.to(torch.bfloat16), r, y)
    with pytest.raises(ValueError):
        inorm._instance_norm_bwd_cuda(g.cpu(), x, m, r, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_bwd_planted_faults_are_caught(card, dtype):
    """The tolerance catches the ReLU gate dropped (the kernel run without
    y) and the ``yhat * mean(g' yhat)`` term dropped (added back to the
    kernel's dx)."""
    g, x, m, r, y = _bwd_inputs(card, (16, 96, 92, 124), dtype, True)
    dx = inorm._instance_norm_bwd_cuda(g, x, m, r, y)
    assert _bwd_within(dx, g, x, m, r, y)
    ungated = inorm._instance_norm_bwd_cuda(g, x, m, r, None)
    assert not _bwd_within(ungated, g, x, m, r, y)
    gp = torch.where(y > 0, g.float(), 0.0)
    yhat = (x.float() - m) * r
    dropped = dx.float() + r * yhat * (gp * yhat).mean((2, 3), keepdim=True)
    assert not _bwd_within(dropped.to(dtype), g, x, m, r, y)


def test_instance_norm_bwd_kernel_launches_15_a_gmflow_step(card):
    """GMFlow's mixed-precision training step launches the backward kernel
    once a norm, 15 times, and copies no operand."""
    from opticalflowfromdepth_torch.data.loader import to_device
    from opticalflowfromdepth_torch.train import gmflow_train as gt

    cfg = gt.GMFlowTrainConfig(batch_size=2, image_size=(64, 96),
                               num_steps=100)
    state = gt.init_state(cfg, seed=8, device="cuda")
    step = gt.make_train_step(cfg, device="cuda")
    rng = np.random.default_rng(7)
    batch = dict(
        image1=rng.uniform(0, 255, (2, 64, 96, 3)).astype(np.float32),
        image2=rng.uniform(0, 255, (2, 64, 96, 3)).astype(np.float32),
        flow=rng.normal(0, 3, (2, 64, 96, 2)).astype(np.float32),
        valid=np.ones((2, 64, 96), np.float32),
        label=np.eye(4, dtype=np.float32)[[0, 2]])
    launches = inorm.instance_norm.bwd_launches
    copies = inorm.instance_norm.bwd_copies
    step(state, to_device(batch, "cuda"))
    torch.cuda.synchronize()
    assert inorm.instance_norm.bwd_launches == launches + 15
    assert inorm.instance_norm.bwd_copies == copies


@pytest.mark.parametrize("head_seed", range(8))
def test_train_step_on_card_matches_cpu(card, head_seed):
    """RAFT-basic, one f32 step of the training recipe (classifier on), on
    the card (kernels) and on the CPU (plain versions), same weights: the
    metrics, the raw gradients (captured before the optimizer's clip) and
    the parameters after the update. The classifier, its linear head
    included, is drawn from ``head_seed`` (eight heads)."""
    import copy

    from opticalflowfromdepth_torch.data.loader import to_device
    from opticalflowfromdepth_torch.models.classifier import Classifier
    from opticalflowfromdepth_torch.models.layers import init_weights_
    from opticalflowfromdepth_torch.train import raft_train as rt

    cfg = rt.RAFTTrainConfig(iters=2, batch_size=2, image_size=(64, 96),
                             mixed_precision=False, add_classifier=True,
                             num_steps=100)
    gen = torch.Generator().manual_seed(head_seed)
    cls = Classifier()
    init_weights_(cls, gen)
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
    for k, v in out["cpu"][0].items():
        np.testing.assert_allclose(out["cuda"][0][k], v, rtol=1e-4,
                                   err_msg=k)
    # the step amplifies f32 rounding (the context encoder's BatchNorm over
    # 2 samples): two CPU runs differ by 4.4e-5 of the global norm and by
    # 4.8e-4 of fnet's. Every raw gradient within 2e-4 of the global norm;
    # fnet's reach it only through the lookup's backward kernel and
    # instance norm's backward: within 1e-2 of their (non-zero) norm
    g_cpu, g_card = out["cpu"][1], out["cuda"][1]
    norm = torch.sqrt(sum((g ** 2).sum() for g in g_cpu.values()))
    for k, g in g_cpu.items():
        assert (g_card[k] - g).abs().max() < 2e-4 * norm, k
    fnet = [k for k in g_cpu if k.startswith("fnet.")]
    f_norm = torch.sqrt(sum((g_cpu[k] ** 2).sum() for k in fnet))
    err = torch.sqrt(sum(((g_card[k] - g_cpu[k]) ** 2).sum() for k in fnet))
    assert f_norm > 0 and err < 1e-2 * f_norm
    # one Adam step moves each parameter by about the learning rate
    for k, v in out["cpu"][2].items():
        np.testing.assert_allclose(out["cuda"][2][k].float().numpy(),
                                   v.float().numpy(), atol=2e-4, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_kernel_matches_plain(card, dtype, relu):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(2, 24, 37, 53, generator=g) * 3 + 1).to(card, dtype)
    y, m, r = inorm.instance_norm(x, 1e-5, relu)
    yr, mr, rr = inorm.instance_norm_plain(x, 1e-5, relu)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yr.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(m.cpu().numpy(), mr.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(r.cpu().numpy(), rr.cpu().numpy(), rtol=1e-5)


def test_raft_small_on_card_matches_cpu(card):
    model = RAFT(small=True, corr_impl="fused",
                 generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    i1, i2 = (torch.rand(1, 3, 64, 96, generator=g) * 255 for _ in range(2))
    with torch.inference_mode():
        lr, up = model(i1, i2, iters=4, test_mode=True)
        model.to(card)
        lr_c, up_c = model(i1.to(card), i2.to(card), iters=4, test_mode=True)
    np.testing.assert_allclose(up_c.cpu().numpy(), up.numpy(), atol=1e-3)


# bf16 at C = 128 with D = 128 or 2 takes the forward's wgmma route
# (64-key tiles, 64 queries a warpgroup, three warpgroups a block once
# such blocks fill every SM twice), other widths the mma.sync route; f32
# at C = 128 with D = 128 or 2 the tf32x3 route (64 queries and 64-key
# tiles a block at D = 2, 128 and 32 at D = 128; the key sweep split at
# small batches), other widths the f32 CUDA-core route
FLASH_FWD_CASES = [
    (8, 24, 24, 128, 128, (2, 4, 6, 2, 3)),      # [2B] windows, shifted
    (2, 100, 63, 64, 16, None),                  # ragged (mma.sync)
    (1, 300, 300, 128, 2, None),                 # matching payload
    (2, 130, 70, 32, 48, None),                  # ragged, narrow (mma.sync)
    (1, 65, 129, 128, 128, None),                # a tile + 1 row
    (2, 127, 63, 128, 128, None),                # a tile - 1 row
    (1, 129, 65, 128, 2, None),
    (2, 63, 127, 128, 2, None),
    (8, 130, 130, 128, 128, (2, 10, 13, 5, 6)),  # region edge inside tiles
    (264, 100, 100, 128, 128, None),             # 3 warpgroups, 1 idle
    (1, 2000, 2000, 128, 2, None),               # B = 1: split (f32)
    (2, 1001, 1001, 128, 128, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,c,d,swin", FLASH_FWD_CASES)
def test_flash_kernel_matches_plain(card, dtype, b, lq, lk, c, d, swin):
    """The CUDA kernel against the plain version with the kernel's key
    blocks, out and LSE. f32: sums in another order, 1e-4 of max|v|.
    bf16: ``bf16_tolerance`` row by row (a P whose f32 value differs in the
    last bits may round to the neighbouring bf16 value: two bf16 steps of
    the row's largest ``pi_i |v_i|``), which the output scaled by 0.98
    does not meet."""
    g = torch.Generator().manual_seed(8)
    q = torch.randn(b, lq, c, generator=g).to(card, dtype)
    k = torch.randn(b, lk, c, generator=g).to(card, dtype)
    v = (torch.randn(b, lk, d, generator=g) * (30 if d == 2 else 1)).to(card)
    before = fl.flash_softmax_matmul.launches
    out, lse = fl.flash_softmax_matmul(q, k, v, swin=swin, with_lse=True)
    torch.cuda.synchronize()
    assert fl.flash_softmax_matmul.launches == before + 1
    ref, ref_lse = fl.flash_softmax_matmul_plain(q, k, v, swin=swin,
                                                 with_lse=True)
    assert out.dtype == torch.float32 and out.shape == (b, lq, d)
    tol = 1e-4 * float(v.abs().max()) if dtype == torch.float32 \
        else fl.bf16_tolerance(q, k, v, swin=swin)
    assert float(((out - ref).abs() / tol).max()) <= 1.0
    assert float(((out * 0.98 - ref).abs() / tol).max()) > 1.0
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,lq,lk,c,d,swin", [
    (8, 130, 130, 128, 128, (2, 10, 13, 5, 6)),   # wgmma / tf32x3 route
    (2, 129, 65, 128, 2, None),                   # the same, D = 2
    (1, 2000, 2000, 128, 2, None),                # split sweep (f32)
    (2, 100, 63, 64, 16, None),                   # mma.sync / f32 route
    (8, 130, 130, 256, 256, (2, 10, 13, 5, 6)),   # bf16 C = 256: wgmma
    (2, 129, 65, 256, 2, None),
    (8, 130, 130, 512, 512, (2, 10, 13, 5, 6)),   # bf16 C = 512: wgmma
    (2, 129, 65, 512, 2, None),                   # (f32: CUDA cores)
    (2, 129, 65, 1000, 600, None)])               # mma.sync / f32
def test_flash_kernel_bit_reproducible(card, dtype, b, lq, lk, c, d, swin):
    """Two launches on the same inputs give the same bits, out and LSE,
    split sweeps included (no atomics: the runs merged in a fixed
    order)."""
    g_ = torch.Generator().manual_seed(14)
    q, k = (torch.randn(b, n, c, generator=g_).to(card, dtype)
            for n in (lq, lk))
    v = torch.randn(b, lk, d, generator=g_).to(card, dtype)
    first = fl.flash_softmax_matmul(q, k, v, swin=swin, with_lse=True)
    second = fl.flash_softmax_matmul(q, k, v, swin=swin, with_lse=True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert all(bool(torch.isfinite(x).all()) for x in first)


@pytest.mark.parametrize("b,l,d,splits", [(1, 2000, 2, 8),
                                          (2, 1001, 128, 8),
                                          (1, 7168, 2, 7)])
def test_flash_tf32x3_split_sweep(card, monkeypatch, b, l, d, splits):
    """f32 at small batches and C = 128 takes the tf32x3 route with a split
    key sweep (the plan's, checked here); within 1e-4 of max|v| of the
    plain version (the LSE within 1e-4 + 1e-6|ref|), and a merge that
    leaves the last run out exceeds that tolerance."""
    g_ = torch.Generator().manual_seed(15)
    q, k = (torch.randn(b, l, 128, generator=g_).to(card) for _ in range(2))
    v = torch.randn(b, l, d, generator=g_).to(card) * (30 if d == 2 else 1)
    plan = fl.plan(b, l, l, 128, d, torch.float32)
    assert (plan.route, plan.splits) == ("tf32x3", splits)
    assert plan.scratch_out == (splits, b, l, d)
    ref, ref_lse = fl.flash_softmax_matmul_plain(q, k, v, with_lse=True)
    tol = 1e-4 * float(v.abs().max())
    out, lse = fl.flash_softmax_matmul(q, k, v, with_lse=True)
    fn, merge = fl._kernel_fns()
    monkeypatch.setattr(fl, "_kernel_fns", lambda: (
        fn, lambda po, pm, o, ls, n, dd, s, st: merge(po, pm, o, ls, n, dd,
                                                      s - 1, st)))
    bad = fl.flash_softmax_matmul(q, k, v)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= tol
    assert float(((lse - ref_lse).abs()
                  / (1e-4 + 1e-6 * ref_lse.abs())).max()) <= 1.0
    assert float((bad - ref).abs().max()) > tol


def test_flash_plan_matches_kernel_plan(card):
    """The C side takes the host's plan (``plan``: the route, the wgmma
    route's warpgroups, the tf32x3 route's runs of the key sweep) and
    reports what it launches on it, with a bias and without: the route and
    the runs are the plan's; on the tf32x3 and wgmma routes the rows a
    block, keys a tile, D chunks, blocks (row blocks x chunks x runs),
    shared memory (static included) and blocks an SM (tf32x3) are too;
    every route's blocks fit an SM. The backward's kernels take their
    plan's routes (tf32x3: its rows and each kernel's shared memory) and
    fit an SM; dq's wgmma blocks at C = 512 are 64 queries that both
    warpgroups share, one an SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, lq, lk, c, d in ((16, 3220, 3220, 128, 2), (1, 7168, 7168, 128, 2),
                            (1, 3584, 3584, 128, 2), (1, 1792, 1792, 128, 2),
                            (128, 805, 805, 128, 128),
                            (2, 1001, 1001, 128, 128), (1, 65, 129, 128, 128),
                            (2, 100, 63, 64, 16), (8, 1792, 1792, 256, 256),
                            (128, 805, 805, 256, 256),
                            (1, 7168, 7168, 256, 2), (16, 3220, 3220, 256, 2),
                            (8, 1792, 1792, 512, 512),
                            (128, 805, 805, 512, 512),
                            (16, 3220, 3220, 512, 2),
                            (1, 7168, 7168, 512, 2),
                            (2, 150, 130, 2000, 600)):
        for dtype in (torch.float32, torch.bfloat16):
            for bias in (False, True):
                p = fl.plan(b, lq, lk, c, d, dtype, sms, bias)
                k = fl.kernel_plan(b, lq, lk, c, d, dtype == torch.bfloat16,
                                   bias)
                assert (k["route"], k["splits"]) == (p.route, p.splits)
                assert 0 < k["smem"] <= 232448 and k["per_sm"] >= 1
                if p.route in ("tf32x3", "wgmma"):
                    assert (k["rows"], k["tile"], k["chunks"], k["smem"]) \
                        == (p.rows, p.tile, p.chunks, p.smem), \
                        (b, lq, c, d, bias)
                    assert k["blocks"] == \
                        b * -(-lq // p.rows) * p.chunks * p.splits
                if p.route == "tf32x3":
                    assert k["per_sm"] == p.blocks_per_sm
            pb = fb.plan(b, lq, lk, c, d, dtype, sms)
            kb = fb.kernel_plan(b, lq, lk, c, d, dtype == torch.bfloat16)
            assert (kb["dq"]["route"], kb["dkv"]["route"]) == \
                (pb.route_dq, pb.route_dkv), (b, lq, c, d, dtype)
            for i, key in enumerate(("dq", "dkv")):
                assert 0 < kb[key]["smem"] <= 232448 and kb[key]["per_sm"] >= 1
                assert kb[key]["local"] == 0 or kb[key]["route"] != "wgmma"
                if pb.route_dq == "tf32x3":
                    assert (kb[key]["rows"], kb[key]["smem"]) == \
                        (pb.rows, pb.smem[i])
                    assert kb[key]["per_sm"] >= pb.blocks_per_sm
            if pb.route_dq == "wgmma" and c == 512:
                assert (kb["dq"]["rows"], kb["dq"]["chunks"],
                        kb["dq"]["per_sm"]) == (64, 1, 1), (b, lq, d)
                assert kb["dq"]["blocks"] == b * -(-lq // 64)


def test_flash_kernel_refuses_a_plan_it_does_not_serve(card):
    """A plan no instantiation serves is refused, not launched: warpgroup
    counts the wgmma forward has no instance for (two at D = 2, three with
    a bias or at C = 256, none, four), warpgroups off the wgmma route, a
    route that does not take the dtype or the widths, a split sweep off
    the tf32x3 route. Each returns cudaErrorInvalidValue (1) from the
    launch, whose output keeps its NaNs, and from the reporter; the
    backward's reporter refuses a route that does not take its widths."""
    fn, _ = fl._kernel_fns()
    routes = fl.ROUTES
    b, l = 2, 130
    for c, d, bias, bf16, route, wgs, splits in (
            (128, 2, False, True, "wgmma", 2, 1),
            (128, 128, True, True, "wgmma", 3, 1),
            (256, 256, False, True, "wgmma", 3, 1),
            (128, 128, False, True, "wgmma", 0, 1),
            (128, 128, False, True, "wgmma", 4, 1),
            (128, 128, False, True, "wgmma", 2, 2),
            (128, 128, False, True, "mma_sync", 2, 1),
            (128, 128, False, False, "wgmma", 2, 1),
            (64, 64, False, False, "tf32x3", 0, 1),
            (128, 128, False, False, "f32", 0, 2)):
        dtype = torch.bfloat16 if bf16 else torch.float32
        q = torch.randn(b, l, c, device=card).to(dtype)
        v = torch.randn(b, l, d, device=card).to(dtype)
        bs = torch.zeros(b, l, l, device=card) if bias else None
        out = torch.full((b, l, d), float("nan"), device=card)
        lse = torch.full((b, l), float("nan"), device=card)
        err = fn(q.data_ptr(), q.data_ptr(), v.data_ptr(),
                 0 if bs is None else bs.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, l, l, c, d, 1.0, 0, 0, 0, 0, 0, int(bf16),
                 routes[route], wgs, splits,
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        case = (c, d, bias, bf16, route, wgs, splits)
        assert err == 1, case
        assert bool(out.isnan().all()) and bool(lse.isnan().all()), case
        got = (ctypes.c_int * 13)()
        assert fl._plan_fn()(b, l, l, c, d, int(bf16), int(bias),
                             routes[route], wgs, splits, got) == 1, case
    got = (ctypes.c_int * 10)()
    for c, d, bf16, route in ((64, 64, True, "wgmma"),
                              (64, 64, False, "tf32x3"),
                              (128, 128, False, "mma_sync")):
        assert fb._plan_fn()(b, l, l, c, d, int(bf16), 0, routes[route],
                             got) == 1, (c, d, route)


# bf16 at C = 256 with D = 256 or 2 (GMFlow at 256 channels) takes the
# forward's wgmma route too: two warpgroups of 64 queries a block at D =
# 256, one at D = 2, 64-key tiles; lengths of a tile + 1, two tiles + 1
# and past three, a Swin region edge inside a key tile
FLASH256_FWD_CASES = [
    (1, 65, 129, 256, None),
    (2, 129, 65, 256, None),
    (1, 200, 129, 256, None),
    (2, 65, 200, 2, None),
    (1, 129, 65, 2, None),
    (2, 200, 200, 2, None),
    (8, 130, 130, 256, (2, 10, 13, 5, 6)),
    (8, 130, 130, 2, (2, 10, 13, 5, 6))]


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("b,lq,lk,d,swin", FLASH256_FWD_CASES)
def test_flash_wgmma_c256_matches_plain(card, b, lq, lk, d, swin, with_bias):
    """The wgmma route at C = 256 (the route its plan and the C side name)
    against the plain version, out within ``bf16_tolerance`` row by row
    (which the output scaled by 0.98 does not meet) and the LSE within
    1e-4 + 1e-5 |ref|; with a dense bias (its last key column weighed
    +8, rows it masks whole) and without; against the mma.sync route
    forced on the same inputs, within the same tolerance; two launches
    bit-equal."""
    g_ = torch.Generator().manual_seed(b * lq + lk + d)
    q = torch.randn(b, lq, 256, generator=g_).to(card, torch.bfloat16)
    k = torch.randn(b, lk, 256, generator=g_).to(card, torch.bfloat16)
    v = (torch.randn(b, lk, d, generator=g_) * (30 if d == 2 else 1)).to(card)
    bias = None
    if with_bias:
        bias = torch.randn(b, lq, lk, generator=g_).to(card)
        bias[..., -1] += 8.0
        bias[b - 1, :3] = -1e30
    assert fl.plan(b, lq, lk, 256, d, torch.bfloat16).route == "wgmma"
    assert fl.kernel_plan(b, lq, lk, 256, d, True, with_bias)["route"] == \
        "wgmma"
    before = fl.flash_softmax_matmul.launches
    out, lse = fl.flash_softmax_matmul(q, k, v, bias=bias, swin=swin,
                                       with_lse=True)
    again = fl.flash_softmax_matmul(q, k, v, bias=bias, swin=swin,
                                    with_lse=True)
    (old, old_lse), launch, plan = fl.launcher(q, k, v, swin=swin,
                                               with_lse=True,
                                               route="mma_sync", bias=bias)
    launch()
    torch.cuda.synchronize()
    assert plan.route == "mma_sync"
    assert fl.flash_softmax_matmul.launches == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = fl.flash_softmax_matmul_plain(q, k, v, swin=swin,
                                                 with_lse=True, bias=bias)
    tol = fl.bf16_tolerance(q, k, v, swin=swin, bias=bias)
    assert out.shape == (b, lq, d) and out.dtype == torch.float32
    for got, got_lse in ((out, lse), (old, old_lse)):
        assert float(((got - ref).abs() / tol).max()) <= 1.0
        np.testing.assert_allclose(got_lse.cpu().numpy(),
                                   ref_lse.cpu().numpy(), atol=1e-4,
                                   rtol=1e-5)
    assert float(((out * 0.98 - ref).abs() / tol).max()) > 1.0
    if with_bias:
        mean = v[b - 1].to(torch.bfloat16).float().mean(0)
        assert float((out[b - 1, :3] - mean).abs().max()) <= 1e-4 * float(
            v.abs().max()) + 1e-6


def test_flash_wgmma_c256_kernel_plan(card):
    """The C side's plan of the wgmma route at C = 256, with a bias and
    without: no local memory (no spills, no stack), a block within 227 KB
    of shared memory, the blocks an SM the route counts on (one at D =
    256, two at D = 2), 256 threads at D = 256 and 128 at D = 2."""
    for d, per_sm, threads in ((256, 1, 256), (2, 2, 128)):
        for bias in (False, True):
            p = fl.kernel_plan(16, 3220, 3220, 256, d, True, bias)
            assert p["route"] == "wgmma" and p["local"] == 0, (d, bias, p)
            assert p["smem"] == fl.wgmma_smem(256, d, threads // 128)
            assert p["smem"] <= 232448 and p["per_sm"] >= per_sm, (d, p)
            assert p["threads"] == threads and p["regs"] <= 255


def test_flash_forced_cuda_core_route_matches_plain(card):
    """The CUDA-core route that f32 at C = 128 took before the tf32x3 one,
    forced through ``launcher(route="f32")``, still within 1e-4 of max|v|
    of the plain version; the planned route gives the tf32x3 plan."""
    g_ = torch.Generator().manual_seed(16)
    for d in (2, 128):
        q, k = (torch.randn(2, 300, 128, generator=g_).to(card)
                for _ in range(2))
        v = torch.randn(2, 300, d, generator=g_).to(card)
        ref, ref_lse = fl.flash_softmax_matmul_plain(q, k, v, with_lse=True)
        for forced in (None, "f32"):
            (out, lse), launch, plan = fl.launcher(q, k, v, with_lse=True,
                                                   route=forced)
            assert plan.route == (forced or "tf32x3")
            launch()
            torch.cuda.synchronize()
            assert float((out - ref).abs().max()) <= \
                1e-4 * float(v.abs().max())
            np.testing.assert_allclose(lse.cpu().numpy(),
                                       ref_lse.cpu().numpy(), atol=1e-4,
                                       rtol=1e-6)


def test_flash_kernel_refuses_what_it_does_not_take(card):
    """What the kernels still refuse: mixed dtypes, tensors on two devices,
    B > 65535, C or D past ``MAX_WIDTH`` (65,535 chunks of 128 columns on
    the grid's z axis), a bias of another shape than [B, Lq, Lk] (JAX's
    never broadcasts). C = 24 / 256 and D = 256, refused before widths
    were padded, and C, D past 256, refused before the kernels staged C
    in panels, run now: test_flash_kernel_takes_every_width."""
    q = torch.randn(2, 32, 64, device=card)
    with pytest.raises(ValueError, match="bf16 or both f32"):
        fl.flash_softmax_matmul(q, q.bfloat16(), torch.randn(2, 32, 2,
                                                             device=card))
    with pytest.raises(ValueError, match="one CUDA device"):
        fl.flash_softmax_matmul(q, q, torch.randn(2, 32, 2))
    with pytest.raises(ValueError, match="one CUDA device"):
        fl.flash_softmax_matmul(q, q, q[..., :2],
                                bias=torch.zeros(2, 32, 32))
    big = torch.randn(65536, 1, 16, device=card)
    with pytest.raises(ValueError, match="65535"):
        fl.flash_softmax_matmul(big, big, big[..., :2])
    for c, d in ((fl.MAX_WIDTH + 1, 2), (64, fl.MAX_WIDTH + 1)):
        qc = torch.randn(1, 1, c, device=card)
        with pytest.raises(ValueError, match="65535 chunks"):
            fl.flash_softmax_matmul(qc, qc, torch.randn(1, 1, d,
                                                        device=card))
        with pytest.raises(ValueError, match="65535 chunks"):
            fb.flash_backward(qc, qc, torch.randn(1, 1, d, device=card),
                              torch.zeros(1, 1, d, device=card),
                              torch.zeros(1, 1, device=card),
                              torch.zeros(1, 1, d, device=card))
    for shape in ((1, 32, 32), (2, 32, 31), (32, 32)):
        with pytest.raises(ValueError, match="bias"):
            fl.flash_softmax_matmul(q, q, q[..., :2],
                                    bias=torch.zeros(shape, device=card))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_plans_at_every_width(card, dtype):
    """Every padded width the wrappers hand the kernels up to 256 (C =
    16..256 in 16s, D = 2 or 16..256 in 16s: every C, D in 1..256), and
    past it to 1024 in steps of 48, C, D or both: the C side's reports
    of the host's plans of the forward (with a bias and without) and of
    the backward's dq and dk/dv name the wrappers' route (each its own
    ``plan``'s; one predicate for all three, wgmma at C = 128, 256 and
    512 with D = C or 2), fit a block within 227 KB of shared memory with
    at least one block an SM (the forward's wgmma and tf32x3 blocks the
    plan's shared memory), and on the mma.sync and CUDA-core routes take
    D (forward) or the wider of C and D (dk/dv; dq: C) in 128-column
    chunks; asking for a plan leaves later launches able to run."""
    bf16 = dtype == torch.bfloat16
    widths = list(range(16, 257, 16)) + list(range(272, 1025, 48))
    assert 512 in widths
    for cp in widths:
        for dp in [2] + widths:
            pb = fb.plan(4, 300, 300, cp, dp, dtype)
            for bias in (False, True):
                p = fl.plan(4, 300, 300, cp, dp, dtype, bias=bias)
                k = fl.kernel_plan(4, 300, 300, cp, dp, bf16, bias)
                assert k["route"] == p.route, (cp, dp, bias)
                assert 0 < k["smem"] <= 232448 and k["per_sm"] >= 1
                assert k["smem"] == p.smem or p.route in ("mma_sync", "f32")
                assert k["chunks"] == (-(-dp // 128) if p.route in (
                    "mma_sync", "f32") and dp != 2 else p.chunks)
            kb = fb.kernel_plan(4, 300, 300, cp, dp, bf16)
            cc = -(-cp // 128)
            for key, route_b, chunks in (
                    ("dq", pb.route_dq, cc),
                    ("dkv", pb.route_dkv,
                     cc if dp == 2 else max(cc, -(-dp // 128)))):
                assert kb[key]["route"] == route_b, (cp, dp, key)
                assert 0 < kb[key]["smem"] <= 232448, (cp, dp, key)
                assert kb[key]["per_sm"] >= 1
                # the wgmma route's dk/dv at C = D = 512: two 256-column
                # chunks of dK and dV (dq: one block takes all of dQ's
                # columns)
                wide = 2 if key == "dkv" and (cp, dp) == (512, 512) else 1
                assert kb[key]["chunks"] == (chunks if route_b in (
                    "mma_sync", "f32") else wide)
    # a plan lowers no kernel's shared-memory limit: after the narrowest
    # width's plans, calls at a wider width (more shared memory, still
    # under the default 48 KB) launch
    fl.kernel_plan(2, 100, 100, 16, 2, bf16)
    fb.kernel_plan(2, 100, 100, 16, 2, bf16)
    q = torch.randn(2, 100, 64, device=card).to(dtype)
    v = torch.randn(2, 100, 16, device=card).to(dtype)
    out, lse = fl.flash_softmax_matmul(q, q, v, with_lse=True)
    grads = fb.flash_backward(q, q, v, out, lse, torch.randn_like(out))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in (out, *grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,d", [(24, 2), (24, 256), (256, 2), (256, 256),
                                 (100, 130), (264, 3), (512, 512), (512, 2),
                                 (1000, 600), (64, 600)])
def test_flash_kernel_takes_every_width(card, dtype, c, d):
    """C and D at any width, padded to the kernels' tiles and sliced back:
    forward and backward kernels against the plain versions (forward: f32
    1e-4 of max|v|, bf16 ``bf16_tolerance``; backward: f32 1e-4 of each
    gradient's max, bf16 ``bwd_bf16_tolerance``), with a dense bias too."""
    g_ = torch.Generator().manual_seed(c + d)
    q = torch.randn(2, 150, c, generator=g_).to(card, dtype)
    k = torch.randn(2, 130, c, generator=g_).to(card, dtype)
    v = torch.randn(2, 130, d, generator=g_).to(card, dtype)
    g = torch.randn(2, 150, d, generator=g_).to(card)
    bias = torch.randn(2, 150, 130, generator=g_).to(card)
    for b_ in (None, bias):
        out, lse = fl.flash_softmax_matmul(q, k, v, bias=b_, with_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = fl.flash_softmax_matmul_plain(q, k, v, with_lse=True,
                                                     bias=b_)
        assert out.shape == (2, 150, d)
        tol = 1e-4 * float(v.float().abs().max()) \
            if dtype == torch.float32 else \
            fl.bf16_tolerance(q, k, v, bias=b_)
        assert float(((out - ref).abs() / tol).max()) <= 1.0
        assert float((lse - ref_lse).abs().max()) <= 1e-4
    out, lse = fl.flash_softmax_matmul(q, k, v, with_lse=True)
    got = fb.flash_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    want = fb.flash_backward_plain(q, k, v, out, lse, g)
    tols = [1e-4 * float(w.abs().max()) for w in want] \
        if dtype == torch.float32 else \
        fb.bwd_bf16_tolerance(q, k, v, out, lse, g)
    for x, w, t in zip(got, want, tols):
        assert x.shape == w.shape
        assert float(((x - w).abs() / t).max()) <= 1.0


@pytest.mark.parametrize("dtype,c,d,b", [
    (torch.bfloat16, 128, 128, 8),      # wgmma
    (torch.bfloat16, 128, 2, 1),
    (torch.bfloat16, 64, 16, 2),        # mma.sync
    (torch.float32, 128, 2, 1),         # tf32x3, key sweep split
    (torch.float32, 128, 128, 8),       # tf32x3
    (torch.float32, 64, 16, 2)])        # CUDA cores
def test_flash_kernel_bias_matches_plain(card, dtype, c, d, b):
    """A dense bias on every forward route, Lk ragged (odd: the scalar bias
    loads), rows the bias masks whole (-1e30: the mean of v, as JAX's dense
    oracle), two launches bit-equal."""
    g_ = torch.Generator().manual_seed(b * c + d)
    lq, lk = 333, 301
    q = torch.randn(b, lq, c, generator=g_).to(card, dtype)
    k = torch.randn(b, lk, c, generator=g_).to(card, dtype)
    v = torch.randn(b, lk, d, generator=g_).to(card, dtype)
    bias = torch.randn(b, lq, lk, generator=g_).to(card)
    bias[0, :3] = -1e30
    out = fl.flash_softmax_matmul(q, k, v, bias=bias)
    again = fl.flash_softmax_matmul(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = fl.flash_softmax_matmul_plain(q, k, v, bias=bias)
    tol = 1e-4 * float(v.float().abs().max()) if dtype == torch.float32 \
        else fl.bf16_tolerance(q, k, v, bias=bias)
    assert float(((out - ref).abs() / tol).max()) <= 1.0
    mean = v[0].float().mean(0)
    assert float((out[0, :3] - mean).abs().max()) <= 1e-4 * float(
        v.float().abs().max()) + 1e-6


@pytest.mark.parametrize("num_scales", [1, 2])
def test_gmflow_on_card_matches_cpu(card, num_scales):
    """f32, 64x96, the same weights: the kernels on the card against the
    plain versions on the CPU (the port's CPU tests hold those to the JAX
    model). 1 scale: 2e-2 px, as test_torch_gmflow.py. Refine, whose local
    matching amplifies f32 rounding: the limits of ``chip_smoke.py`` [9],
    0.6 px max, 0.2 px at the 99th percentile, 1e-2 px median. The CPU
    model's own response to input noise of 1e-4 gray levels is printed
    beside the readings (run with ``-s``)."""
    recipe = {1: ((2,), (-1,), (-1,)), 2: ((2, 8), (-1, 4), (-1, 1))}
    model = GMFlow(num_scales=num_scales,
                   upsample_factor=8 if num_scales == 1 else 4,
                   generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    low = torch.rand(2, 3, 8, 12, generator=g) * 255
    i1, i2 = torch.nn.functional.interpolate(
        low, size=(64, 96), mode="bilinear", align_corners=False).chunk(2)
    with torch.inference_mode():
        cpu = model(i1, i2, *recipe[num_scales], training=False)
        nudged = model(i1 + 1e-4 * torch.randn(i1.shape, generator=g), i2,
                       *recipe[num_scales], training=False)
        model.to(card)
        before = fl.flash_softmax_matmul.launches
        gpu = model(i1.to(card), i2.to(card), *recipe[num_scales],
                    training=False)
        assert fl.flash_softmax_matmul.launches - before == \
            (14 if num_scales == 1 else 26)
    d = (gpu["flow_preds"][-1].cpu() - cpu["flow_preds"][-1]).abs()
    own = (nudged["flow_preds"][-1] - cpu["flow_preds"][-1]).abs()
    p99 = float(torch.quantile(d.flatten(), 0.99))
    print(f"GMFlow {num_scales} scale(s) card vs CPU: max {float(d.max()):.4e}"
          f", 99th percentile {p99:.4e}, median {float(d.median()):.4e} px; "
          f"the CPU under the nudge: max {float(own.max()):.4e}, median "
          f"{float(own.median()):.4e} px")
    assert float(d.median()) <= 1e-2
    assert float(d.max()) <= (2e-2 if num_scales == 1 else 0.6)
    assert num_scales == 1 or p99 <= 0.2


# bf16 at C = 128 with D = 128 or 2 takes the wgmma route (64-row tiles,
# 128 rows a block), and so does C = 256 with D = 256 or 2 (dq: 32-key
# tiles at D = 256; dk/dv: 64 keys a block shared by both warpgroups at D
# = 256), other widths the mma.sync route; f32 at C = 128 with D = 128 or
# 2 the tf32x3 route (64-row tiles at D = 2, 32 at D = 128; 64 and 128
# rows a block), other widths the f32 CUDA-core route
FLASH_BWD_CASES = [
    (8, 24, 24, 128, 128, (2, 4, 6, 2, 3)),      # [2B] windows, shifted
    (2, 100, 63, 64, 16, None),                  # ragged (mma.sync, f32)
    (2, 300, 300, 128, 2, None),                 # matching payload
    (2, 130, 70, 32, 48, None),                  # ragged, narrow (mma.sync)
    (1, 65, 129, 128, 128, None),                # a tile + 1 row
    (2, 127, 63, 128, 128, None),                # a tile - 1 row
    (1, 129, 65, 128, 2, None),
    (2, 63, 127, 128, 2, None),
    (8, 130, 130, 128, 128, (2, 10, 13, 5, 6)),  # region edge inside tiles
    (8, 130, 130, 128, 2, (2, 10, 13, 5, 6)),
    (1, 2000, 2000, 128, 2, None),               # B = 1: split sweeps
    (2, 1001, 1001, 128, 128, None),
    (8, 130, 130, 256, 256, (2, 10, 13, 5, 6)),  # C = 256: windows, Swin
    (1, 65, 129, 256, 256, None),                # ragged keys, D = 256
    (2, 129, 65, 256, 256, None),
    (1, 65, 129, 256, 2, None),                  # ragged keys, D = 2
    (2, 129, 65, 256, 2, None),
    (2, 300, 300, 256, 2, None),
    (8, 130, 130, 512, 512, (2, 10, 13, 5, 6)),  # C = 512: windows, Swin
    (1, 65, 129, 512, 512, None),                # ragged keys, D = 512
    (2, 129, 65, 512, 2, None)]                  # ragged keys, D = 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,c,d,swin", FLASH_BWD_CASES)
def test_flash_bwd_kernels_match_plain(card, dtype, b, lq, lk, c, d, swin):
    """Through the autograd Function: the two backward kernels against the
    plain backward on the forward kernel's residuals. f32: sums in another
    order, 1e-4 of each gradient's max. bf16: ``bwd_bf16_tolerance`` row by
    row (dq) and key by key (dk, dv), which dq scaled by 0.98 fails."""
    g_ = torch.Generator().manual_seed(9)
    q = torch.randn(b, lq, c, generator=g_).to(card, dtype).requires_grad_()
    k = torch.randn(b, lk, c, generator=g_).to(card, dtype).requires_grad_()
    v = (torch.randn(b, lk, d, generator=g_) * (30 if d == 2 else 1)).to(
        card).requires_grad_()
    gout = torch.randn(b, lq, d, generator=g_).to(card)
    before = (fb.flash_backward.launches_dq, fb.flash_backward.launches_dkv)
    fl.flash_softmax_matmul(q, k, v, swin=swin).backward(gout)
    torch.cuda.synchronize()
    assert (fb.flash_backward.launches_dq, fb.flash_backward.launches_dkv) \
        == (before[0] + 1, before[1] + 1)
    assert q.grad.dtype == k.grad.dtype == dtype and v.grad.dtype == \
        torch.float32
    out, lse = fl.flash_softmax_matmul(q.detach(), k.detach(), v.detach(),
                                       swin=swin, with_lse=True)
    args = (q.detach(), k.detach(), v.detach(), out, lse, gout, None, swin)
    ref = fb.flash_backward_plain(*args)
    tols = fb.bwd_bf16_tolerance(*args) if dtype == torch.bfloat16 else [
        1e-4 * float(r.abs().max()) for r in ref]
    got = (q.grad.float(), k.grad.float(), v.grad)
    for x, r, tol in zip(got, ref, tols):
        # bf16: the Function returns dq and dk rounded to bf16 once more
        step = 2 ** -8 * r.abs() if dtype == torch.bfloat16 else 0.0
        assert float(((x - r).abs() / (tol + step)).max()) <= 1.0
    assert float(((ref[0] * 0.98 - ref[0]).abs() / tols[0]).max()) > 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,c,d,swin", [
    (8, 130, 130, 128, 128, (2, 10, 13, 5, 6)),   # wgmma / tf32x3 route
    (2, 129, 65, 128, 2, None),                   # the same, D = 2
    (1, 2000, 2000, 128, 2, None),                # split sweeps (f32)
    (2, 100, 63, 64, 16, None),                   # mma.sync / f32 route
    (8, 130, 130, 256, 256, (2, 10, 13, 5, 6)),   # bf16 C = 256: wgmma
    (2, 129, 65, 256, 2, None),
    (2, 300, 300, 256, 2, None),
    (8, 130, 130, 512, 512, (2, 10, 13, 5, 6)),   # bf16 C = 512: wgmma
    (2, 129, 65, 512, 2, None),
    (2, 200, 333, 512, 512, None),                # dq's ring of units
    (1, 300, 200, 512, 2, None)])                 # dq's halves of the keys
def test_flash_bwd_kernels_bit_reproducible(card, dtype, b, lq, lk, c, d,
                                            swin):
    """No atomics: two launches on the same inputs give the same bits,
    split sweeps included (their partials summed in a fixed order)."""
    g_ = torch.Generator().manual_seed(11)
    q, k = (torch.randn(b, n, c, generator=g_).to(card, dtype)
            for n in (lq, lk))
    v = torch.randn(b, lk, d, generator=g_).to(card, dtype)
    gout = torch.randn(b, lq, d, generator=g_).to(card)
    out, lse = fl.flash_softmax_matmul(q, k, v, swin=swin, with_lse=True)
    first = fb.flash_backward(q, k, v, out, lse, gout, swin=swin)
    second = fb.flash_backward(q, k, v, out, lse, gout, swin=swin)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert all(bool(torch.isfinite(x).all()) for x in first)


@pytest.mark.parametrize("b,l,d,splits", [(1, 2000, 2, 8),
                                          (2, 1001, 128, 8)])
def test_flash_bwd_tf32x3_split_sweep(card, monkeypatch, b, l, d, splits):
    """f32 at B = 1 or 2 and C = 128 takes the tf32x3 route with split
    sweeps (the plan's, checked here); within 1e-4 of each gradient's max
    against the plain backward, and leaving the last partial out of each
    reduction exceeds that tolerance."""
    g_ = torch.Generator().manual_seed(12)
    q, k = (torch.randn(b, l, 128, generator=g_).to(card) for _ in range(2))
    v = torch.randn(b, l, d, generator=g_).to(card) * (30 if d == 2 else 1)
    gout = torch.randn(b, l, d, generator=g_).to(card)
    plan = fb.plan(b, l, l, 128, d, torch.float32)
    assert (plan.route_dq, plan.route_dkv, plan.splits_dq,
            plan.splits_dkv) == ("tf32x3", "tf32x3", splits, splits)
    assert plan.scratch_dq == (splits, b, l, 128)
    out, lse = fl.flash_softmax_matmul(q, k, v, with_lse=True)
    ref = fb.flash_backward_plain(q, k, v, out, lse, gout)
    tols = [1e-4 * float(r.abs().max()) for r in ref]
    got = fb.flash_backward(q, k, v, out, lse, gout)
    fn_dq, fn_dkv, fn_reduce = fb._kernel_fns()
    monkeypatch.setattr(fb, "_kernel_fns", lambda: (
        fn_dq, fn_dkv,
        lambda p, o, n, s, m, st: fn_reduce(p, o, n, s - 1, m, st)))
    bad = fb.flash_backward(q, k, v, out, lse, gout)
    monkeypatch.undo()
    torch.cuda.synchronize()
    for x, y, r, tol in zip(got, bad, ref, tols):
        assert float((x - r).abs().max()) <= tol
        assert float((y - r).abs().max()) > tol


def test_flash_bwd_plan_routes_on_card(card):
    """The wrapper launches the route plan names: tf32x3 for f32 at C =
    128 and D = 128 or 2, the CUDA-core route for other f32 widths, wgmma
    for bf16 at C = 256 or 512 and D = C or 2, dq's and dk/dv's alike;
    forcing the other route on the same inputs (f32; mma.sync for bf16)
    gives gradients within the same tolerance (both against the plain
    backward). The launches hold their operands: blocks of delta's size
    filled with NaN between building and running them change nothing.
    The C = 256 and 512 kernels keep no local memory and fit a block's
    227 KB."""
    g_ = torch.Generator().manual_seed(13)
    for c, d, route in ((128, 2, "tf32x3"), (128, 128, "tf32x3"),
                        (64, 16, "f32")):
        q, k = (torch.randn(2, 130, c, generator=g_).to(card)
                for _ in range(2))
        v = torch.randn(2, 130, d, generator=g_).to(card)
        gout = torch.randn(2, 130, d, generator=g_).to(card)
        out, lse = fl.flash_softmax_matmul(q, k, v, with_lse=True)
        ref = fb.flash_backward_plain(q, k, v, out, lse, gout)
        for forced in (None, "f32"):
            grads, launch_dq, launch_dkv, plan = fb.launchers(
                q, k, v, out, lse, gout, route=forced)
            assert plan.route_dq == plan.route_dkv == (forced or route)
            junk = [torch.full_like(lse, float("nan")) for _ in range(4)]
            launch_dq()
            launch_dkv()
            torch.cuda.synchronize()
            del junk
            for x, r in zip(grads, ref):
                assert float((x - r).abs().max()) <= \
                    1e-4 * float(r.abs().max())
    for c, d in ((256, 256), (256, 2), (512, 512), (512, 2)):
        q, k = (torch.randn(2, 130, c, generator=g_).to(card, torch.bfloat16)
                for _ in range(2))
        v = torch.randn(2, 130, d, generator=g_).to(card, torch.bfloat16)
        gout = torch.randn(2, 130, d, generator=g_).to(card)
        out, lse = fl.flash_softmax_matmul(q, k, v, with_lse=True)
        ref = fb.flash_backward_plain(q, k, v, out, lse, gout)
        tols = fb.bwd_bf16_tolerance(q, k, v, out, lse, gout)
        for forced in (None, "mma_sync"):
            grads, launch_dq, launch_dkv, plan = fb.launchers(
                q, k, v, out, lse, gout, route=forced)
            assert plan.route_dq == plan.route_dkv == (forced or "wgmma")
            launch_dq()
            launch_dkv()
            torch.cuda.synchronize()
            for x, r, tol in zip(grads, ref, tols):
                assert float(((x - r).abs() / tol).max()) <= 1.0
        for key, p in fb.kernel_plan(2, 130, 130, c, d, True).items():
            assert p["route"] == "wgmma" and p["local"] == 0 \
                and p["smem"] <= 232448 and p["per_sm"] >= 1, (key, p)


def test_flash_function_f32_grads_on_card_match_dense(card):
    g_ = torch.Generator().manual_seed(10)
    x = [torch.randn(8, 24, 32, generator=g_).to(card) for _ in range(4)]
    swin = (2, 4, 6, 2, 3)
    ours = [t.clone().requires_grad_() for t in x[:3]]
    dense = [t.clone().requires_grad_() for t in x[:3]]
    fl.flash_softmax_matmul(*ours, swin=swin).backward(x[3])
    s = torch.matmul(dense[0], dense[1].transpose(1, 2)) * 32 ** -0.5
    (torch.softmax(s + fl.swin_mask_dense(24, swin, 8, card), -1)
     @ dense[2]).backward(x[3])
    for a, r in zip(ours, dense):
        assert float((a.grad - r.grad).abs().max()) <= \
            2e-5 * float(r.grad.abs().max())


def test_gmflow_train_step_on_card_matches_cpu(card):
    """GMFlow, one f32 step (1 scale, classifier on, 64x96 smooth images),
    card against CPU, the limits of ``chip_smoke.py`` [11]: metrics 1e-4
    relative (two pixels for the rates), raw gradients 2e-4 of the global
    norm (the backbone's first conv 1e-3: the port's CPU step alone at 1
    and 4 threads differs there by 9.5e-5 of it), parameters 2e-4."""
    import copy

    import torch.nn.functional as F

    from opticalflowfromdepth_torch.data.loader import to_device
    from opticalflowfromdepth_torch.models.classifier import Classifier
    from opticalflowfromdepth_torch.models.layers import init_weights_
    from opticalflowfromdepth_torch.train import gmflow_train as gt

    cfg = gt.GMFlowTrainConfig(batch_size=2, image_size=(64, 96),
                               mixed_precision=False, add_classifier=True,
                               num_steps=100)
    cls = Classifier()
    init_weights_(cls, torch.Generator().manual_seed(6))
    rng = np.random.default_rng(7)
    low = torch.from_numpy(rng.uniform(0, 255, (4, 3, 8, 12)).astype(
        np.float32))
    img = F.interpolate(low, size=(64, 96), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    batch = dict(image1=np.ascontiguousarray(img[:2]),
                 image2=np.ascontiguousarray(img[2:]),
                 flow=rng.normal(0, 3, (2, 64, 96, 2)).astype(np.float32),
                 valid=np.ones((2, 64, 96), np.float32),
                 label=np.eye(4, dtype=np.float32)[[0, 2]])
    out = {}
    for dev in ("cpu", "cuda"):
        state = gt.init_state(cfg, seed=8, device=dev)
        grads = {}
        adam_step = state.optimizer.step

        def step_keeping_grads(state=state, grads=grads, adam_step=adam_step):
            grads.update({n: p.grad.to("cpu", copy=True) for n, p
                          in state.model.named_parameters()})
            return adam_step()
        state.optimizer.step = step_keeping_grads
        step = gt.make_train_step(cfg, copy.deepcopy(cls), device=dev)
        state, m = step(state, to_device(batch, dev))
        out[dev] = ({k: float(v) for k, v in m.items()}, grads,
                    {k: v.cpu() for k, v in state.model.state_dict().items()})
    for k, v in out["cpu"][0].items():
        atol = 2 / 12288 if "px_" in k else 0.0
        np.testing.assert_allclose(out["cuda"][0][k], v, rtol=1e-4,
                                   atol=atol, err_msg=k)
    g_cpu, g_card = out["cpu"][1], out["cuda"][1]
    norm = torch.sqrt(sum((g ** 2).sum() for g in g_cpu.values()))
    for k, g in g_cpu.items():
        rel = 1e-3 if k == "backbone.conv1.weight" else 2e-4
        assert (g_card[k] - g).abs().max() < rel * norm, k
    for k, v in out["cpu"][2].items():
        np.testing.assert_allclose(out["cuda"][2][k].float().numpy(),
                                   v.float().numpy(), atol=2e-4, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,co,offset", [
    (1, 33, 17, 8, 8, 0),       # the JAX tests' ragged case
    (2, 20, 40, 3, 2, 0),       # C, CO % 8 != 0: loads element by element
    (1, 48, 32, 72, 70, 0),     # two C chunks, two CO tiles, ragged
    (2, 24, 40, 64, 64, 0),
    (2, 18, 20, 16, 24, 1)])    # x, w past a 16-byte boundary: element loads
def test_conv3x3_kernel_matches_plain(card, dtype, b, h, w, c, co, offset):
    """Within ``ops/conv2d.py:tolerance`` (another summation order of the
    same exact products; in bf16 one step of the output), which the (2, 2)
    tap left out fails."""
    g_ = torch.Generator().manual_seed(11)
    x = torch.randn(b * h * w * c + offset, generator=g_).to(card, dtype)
    wt = (torch.randn(9 * c * co + offset, generator=g_)
          / (3 * c ** 0.5)).to(card, dtype)
    x, wt = x[offset:].view(b, h, w, c), wt[offset:].view(3, 3, c, co)
    assert bool(x.data_ptr() % 16 and wt.data_ptr() % 16) == bool(offset)
    before = cv.conv3x3_s1.launches
    got = cv.conv3x3_s1(x, wt)
    torch.cuda.synchronize()
    assert cv.conv3x3_s1.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, w, co)
    ref = cv.conv3x3_s1_plain(x, wt).float()
    tol = cv.tolerance(x, wt)
    assert float(((got.float() - ref).abs() / tol).max()) <= 1.0
    w_cut = wt.clone()
    w_cut[2, 2] = 0
    assert float(((cv.conv3x3_s1(x, w_cut).float() - ref).abs() / tol)
                 .max()) > 1.0


@pytest.mark.parametrize("b,h,w,c,co", [
    (1, 20, 37, 64, 64),     # W not a multiple of the 16-pixel tile
    (2, 1, 40, 16, 32),      # H = 1: all band rows but one are padding
    (1, 24, 24, 8, 16),      # C = 8: one k16 step, the box past C zero
    (1, 20, 36, 96, 96),     # C = 96: a partial second channel box
    (1, 16, 40, 256, 126),   # C = 256: the weights streamed in slabs
    (1, 20, 30, 64, 2),      # CO = 2: y element by element
    (1, 18, 33, 64, 126),    # CO = 126: two CO tiles, the last ragged
    (3, 17, 19, 32, 40),     # B > 1, ragged both ways
    (8, 64, 96, 64, 128)])   # 384 items: 3 a block, CO tiles change
def test_conv3x3_wgmma_route_matches_plain(card, b, h, w, c, co):
    """bf16 on the wgmma route within ``ops/conv2d.py:tolerance``; two
    launches give the same bits; the centre tap left out (at H = 1 the
    (2, 2) tap reads only padding), and the padding at each image's
    top-left corner read as the corner pixel (TMA's zero fill missed),
    fail it."""
    g_ = torch.Generator().manual_seed(13)
    x = torch.randn(b, h, w, c, generator=g_).to(card, torch.bfloat16)
    wt = (torch.randn(3, 3, c, co, generator=g_)
          / (3 * c ** 0.5)).to(card, torch.bfloat16)
    assert cv.plan(b, h, w, c, co, torch.bfloat16).route == "wgmma"
    got = cv.conv3x3_s1(x, wt)
    again = cv.conv3x3_s1(x, wt)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    ref = cv.conv3x3_s1_plain(x, wt).float()
    tol = cv.tolerance(x, wt)
    assert float(((got.float() - ref).abs() / tol).max()) <= 1.0
    w_cut = wt.clone()
    w_cut[1, 1] = 0
    corner = got.float()
    corner[:, 0, 0] += x[:, 0, 0].float() @ wt[0, 0].float()
    for fault in (cv.conv3x3_s1(x, w_cut).float(),
                  corner.to(torch.bfloat16).float()):
        assert float(((fault - ref).abs() / tol).max()) > 1.0


def test_conv3x3_mma_sync_route_matches_plain(card):
    """The mma.sync kernel, forced on inputs the wgmma route takes (as
    chip_smoke.py times it), within the same tolerance."""
    g_ = torch.Generator().manual_seed(14)
    x = torch.randn(2, 24, 40, 64, generator=g_).to(card, torch.bfloat16)
    wt = (torch.randn(3, 3, 64, 64, generator=g_) / 24).to(card,
                                                          torch.bfloat16)
    got = cv._conv_cuda(x, wt, route="mma_sync")
    ref = cv.conv3x3_s1_plain(x, wt).float()
    assert float(((got.float() - ref).abs() / cv.tolerance(x, wt)).max()) \
        <= 1.0


def test_conv3x3_function_matches_conv2d_autograd(card):
    """f32 (TF32 off): the Function's dx (the kernel) and dw (nine f32
    products) against autograd through ``F.conv2d`` within 1e-3 of each
    gradient's max (cuDNN's f32 weight gradient read 2.0e-4 of it from the
    plain version's at [32,184,280,64]->64, chip_smoke.py [3g]) and against
    autograd through the plain version within 1e-5."""
    import torch.nn.functional as F
    g_ = torch.Generator().manual_seed(12)
    x = torch.randn(2, 24, 40, 16, generator=g_).to(card)
    wt = (torch.randn(3, 3, 16, 24, generator=g_) / 12).to(card)
    gout = torch.randn(2, 24, 40, 24, generator=g_).to(card)
    ours = [x.clone().requires_grad_(), wt.clone().requires_grad_()]
    cv.conv3x3_s1(*ours).backward(gout)
    for fn, limit in ((lambda a, b_: F.conv2d(
            a.permute(0, 3, 1, 2), b_.permute(3, 2, 0, 1),
            padding=1).permute(0, 2, 3, 1), 1e-3),
                      (cv.conv3x3_s1_plain, 1e-5)):
        ref = [x.clone().requires_grad_(), wt.clone().requires_grad_()]
        fn(*ref).backward(gout)
        for a, r in zip(ours, ref):
            assert float((a.grad - r.grad).abs().max()) <= \
                limit * float(r.grad.abs().max())


def test_conv3x3_kernel_refuses_what_it_does_not_take(card):
    x = torch.randn(1, 8, 8, 16, device=card)
    wt = torch.randn(3, 3, 16, 8, device=card)
    with pytest.raises(ValueError, match="both bf16 or both f32"):
        cv.conv3x3_s1(x, wt.to(torch.bfloat16))
    with pytest.raises(ValueError, match="both bf16 or both f32"):
        cv.conv3x3_s1(x.half(), wt.half())
    with pytest.raises(ValueError, match="contiguous"):
        cv.conv3x3_s1(x.transpose(1, 2), wt)
    with pytest.raises(ValueError, match="CPU or both on one CUDA"):
        cv.conv3x3_s1(x, wt.cpu())


# --------------------------------------------------------------------------
# the forward warp and the synthesis
# --------------------------------------------------------------------------

WARP_CASES = ("zero", "translation", "iid", "rotation off the image",
              "four targets", "constant depth", "collisions")


def _warp_inputs(b, c, h, w, case, seed=0):
    """CPU obj [B, C, H, W], flow [B, 2, H, W], depth [B, 1, H, W] for the
    edge cases of ``chip_smoke.py`` [3h]."""
    r = np.random.default_rng(seed)
    obj = r.normal(size=(b, c, h, w)).astype(np.float32)
    depth = r.uniform(1, 100, (b, 1, h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    flow = r.uniform(-20, 20, (b, 2, h, w)).astype(np.float32)
    if case == "zero":
        flow[:] = 0
    elif case == "translation":
        flow[:, 0], flow[:, 1] = 7.0, -3.0
    elif case == "rotation off the image":
        cx, cy, t = 1.9 * w, -0.7 * h, np.radians(25.0)
        flow[:, 0] = (xx - cx) * np.cos(t) - (yy - cy) * np.sin(t) + cx - xx
        flow[:, 1] = (xx - cx) * np.sin(t) + (yy - cy) * np.cos(t) + cy - yy
    elif case == "four targets":
        flow[:, 0] = (xx % 2) * (w // 2) - xx
        flow[:, 1] = (yy % 2) * (h // 2) - yy
    elif case == "constant depth":
        depth[:] = 42.0
        flow = np.round(flow)
    elif case == "collisions":
        depth[r.uniform(size=depth.shape) < 0.4] = 1000.0
        depth[r.uniform(size=depth.shape) < 0.1] = -0.0
    elif case == "signed zeros":        # -0.0 wins over +0.0
        depth = np.where(r.uniform(size=depth.shape) < 0.5, -0.0,
                         0.0).astype(np.float32)
        flow = np.round(flow / 5)
    return tuple(torch.from_numpy(a) for a in (obj, flow, depth))


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.parametrize("case", WARP_CASES)
@pytest.mark.parametrize("b,c,h,w", [(1, 7, 33, 17), (3, 6, 64, 96),
                                     (15, 2, 24, 32)])
def test_forward_warp_kernel_matches_plain(card, case, b, c, h, w):
    """Bit for bit: out, valid and collision against the plain version on
    the card and on the CPU."""
    args = _warp_inputs(b, c, h, w, case)
    before = fw.forward_warp.launches
    got = fw.forward_warp(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert fw.forward_warp.launches == before + 1
    ref = fw.forward_warp_plain(*(a.to(card) for a in args))
    cpu = fw.forward_warp_plain(*args)
    for g, r, c_ in zip(got, ref, cpu):
        assert _same_bits(g, r) and _same_bits(g.cpu(), c_)


@pytest.mark.parametrize("case", WARP_CASES + ("signed zeros",))
@pytest.mark.parametrize("b,c,h,w", [(1, 7, 384, 512), (15, 6, 384, 512),
                                     (1, 4, 33, 17), (15, 2, 33, 17)])
def test_forward_warp_kernel_matches_plain_at_the_synthesis_sizes(
        card, case, b, c, h, w):
    """Bit for bit at the synthesis path's batches and size (B = 1 and
    15, 384x512) and at a ragged 33x17 whose images straddle warps: border
    clamping, 4 targets, equal depths, depths >= 1000, -0.0 against
    +0.0."""
    args = tuple(a.to(card) for a in _warp_inputs(b, c, h, w, case, seed=1))
    got = fw.forward_warp(*args)
    ref = fw.forward_warp_plain(*args)
    for g, r in zip(got, ref):
        assert _same_bits(g, r)


def test_forward_warp_kernel_back_to_back_launches_are_each_exact(card):
    """Launches on other inputs right after one another (no sync between):
    each resets its own z-buffer, so each is the plain version's."""
    cases = ("rotation off the image", "iid", "four targets", "collisions")
    args = [tuple(a.to(card) for a in _warp_inputs(15, 6, 96, 128, case))
            for case in cases]
    got = [fw.forward_warp(*a) for a in args]
    for g, a in zip(got, args):
        assert all(_same_bits(x, y) for x, y in
                   zip(g, fw.forward_warp_plain(*a)))


@pytest.mark.parametrize("case", ["four targets", "rotation off the image",
                                  "constant depth"])
def test_forward_warp_kernel_planted_fault_is_caught(card, case):
    """Each group of lanes on one target keeping its largest key (the
    grouping's planted fault) changes the result where sources pile up."""
    args = tuple(a.to(card) for a in _warp_inputs(1, 6, 384, 512, case))
    bad = fw._forward_warp_cuda(*args, plant_fault=True)
    assert not _same_bits(bad[0], fw.forward_warp_plain(*args)[0])


@pytest.mark.parametrize("case", ["iid", "rotation off the image"])
def test_forward_warp_kernel_exact_on_offset_views(card, case):
    """Flow and depth one float past an aligned address (contiguous views
    into larger buffers) give the same bits as aligned copies."""
    obj, flow, depth = (a.to(card) for a in _warp_inputs(2, 6, 48, 64, case))
    views = []
    for t in (flow, depth):
        buf = torch.empty(t.numel() + 1, device=card)
        views.append(buf[1:].view(t.shape))
        views[-1].copy_(t)
    assert all(v.is_contiguous() and v.data_ptr() % 8 for v in views)
    got = fw.forward_warp(obj, *views)
    assert all(_same_bits(x, y) for x, y in
               zip(got, fw.forward_warp_plain(obj, flow, depth)))


def test_forward_warp_kernel_bit_reproducible_and_catches_a_reversed_tie(card):
    """Two launches give the same bits; the kernel on inputs whose sources
    are in reverse raster order (their targets kept) is the kernel with
    its tie-break reversed, and that must differ from the plain version
    at constant depth."""
    obj, flow, depth = (a.to(card) for a in _warp_inputs(
        15, 6, 48, 64, "constant depth"))
    first = fw.forward_warp(obj, flow, depth)
    assert all(_same_bits(x, y) for x, y in
               zip(first, fw.forward_warp(obj, flow, depth)))
    b, c, h, w = obj.shape
    p0 = torch.stack(torch.meshgrid(
        torch.arange(w, device=card, dtype=torch.float32),
        torch.arange(h, device=card, dtype=torch.float32), indexing="xy"))
    tgt = torch.stack([torch.clamp(p0[0] + flow[:, 0], 0, w - 1).floor(),
                       torch.clamp(p0[1] + flow[:, 1], 0, h - 1).floor()], 1)

    def rev(t):
        return t.reshape(*t.shape[:2], h * w).flip(-1).reshape(t.shape)
    faulty = fw.forward_warp(rev(obj), (rev(tgt) + 0.5 - p0).contiguous(),
                             rev(depth))
    assert _same_bits(faulty[1], first[1])
    assert not _same_bits(faulty[0], first[0])


def test_forward_warp_kernel_refuses_what_it_does_not_take(card):
    obj, flow, depth = (a.to(card) for a in _warp_inputs(1, 3, 8, 8, "iid"))
    with pytest.raises(ValueError, match="f32"):
        fw.forward_warp(obj.half(), flow, depth)
    with pytest.raises(ValueError, match="forward_warp: obj"):
        fw.forward_warp(obj, flow[:, :1], depth)
    with pytest.raises(ValueError, match="one device"):
        fw.forward_warp(obj, flow, depth.cpu())


def test_synthesis_on_card_matches_cpu(card):
    """``synthesize_sample_packed`` at 48x64, same image, depth and draws:
    20 warp launches; at most 0.5% of the pixels beyond 1 gray level or
    one f16 step (the warp truncates its targets)."""
    h, w = 48, 64
    r = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.clip(np.stack([np.sin(xx / 7 + c) * np.cos(yy / 5) * 90 + 120
                            for c in range(3)])
                  + r.uniform(0, 20, (3, h, w)), 0, 255).astype(np.float32)
    dep = (1.0 / (255.0 - np.clip(120 + 60 * np.sin(xx / 13)
                                  * np.cos(yy / 9), 0, 240)))[None]
    img, dep = torch.from_numpy(img), torch.from_numpy(dep.astype(np.float32))
    draws = sp.draw_sample(torch.Generator().manual_seed(3), h, w)
    cpu = sp.synthesize_sample_packed(img, dep, draws)
    before = fw.forward_warp.launches
    gpu = sp.synthesize_sample_packed(img.to(card), dep.to(card), draws)
    torch.cuda.synchronize()
    assert fw.forward_warp.launches - before == sp.warps_per_image() == 20
    for k, ref in cpu.items():
        got = gpu[k].cpu()
        assert got.dtype == ref.dtype and got.shape == ref.shape
        g, r_ = got.float().numpy(), ref.float().numpy()
        tol = 1.0 if ref.dtype == torch.uint8 else 1e-3 + 1e-3 * np.abs(r_)
        bad = ~(np.abs(g - r_) <= tol)
        share = float(bad.reshape(-1, h * w).any(0).mean()) \
            if bad.ndim > 1 else float(bad.mean())
        print(f"{k}: {100 * share:.3f}% of pixels beyond the tolerance")
        assert share <= 0.005, k


@pytest.mark.parametrize("filter_sizes", [(5, 5), (7,)])
def test_bilateral_filter_on_card_equals_cpu(card, filter_sizes):
    """``sparse_bilateral_filtering`` at 96x128 with steps, spikes and
    holes: the card's output equal to the CPU's at every pixel (the
    cumulative sums are added tap by tap in f32 on both)."""
    from opticalflowfromdepth_torch.ops.bilateral import (
        sparse_bilateral_filtering)
    r = np.random.default_rng(1)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    d = 10 + 3 * np.sin(xx / 7) * np.cos(yy / 5)
    d[:, 64:] += 40
    d *= np.where(r.random(d.shape) < 0.05, 3.0, 1.0)
    d[r.random(d.shape) < 0.03] = 0.0
    depth = torch.from_numpy(d.astype(np.float32))
    want = sparse_bilateral_filtering(depth, filter_sizes)
    got = sparse_bilateral_filtering(depth.to(card), filter_sizes).cpu()
    assert (want != depth).sum() > 1000
    assert torch.equal(got, want)


def test_step_timer_fences_on_card_tensors(card):
    """``tick`` on a CUDA tensor waits for the card: a step of queued
    matmuls is timed whole, not as its enqueue."""
    from opticalflowfromdepth_torch.utils.profiling import StepTimer
    x = torch.randn(4096, 4096, device=card)
    t = StepTimer(warmup=1)
    t.start()
    for _ in range(3):
        y = x
        for _ in range(8):
            y = y @ x
        t.tick(y)
    s = t.summary()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(8):
        y = y @ x
    end.record()
    torch.cuda.synchronize()
    assert s["steps_timed"] == 2 and s["mean_ms"] >= 0.8 * start.elapsed_time(
        end)


def test_trace_records_card_kernels(card, tmp_path):
    import json
    import os
    from opticalflowfromdepth_torch.utils.profiling import annotate, trace
    x = torch.randn(512, 512, device=card)
    with trace(str(tmp_path)):
        with annotate("card_matmul"):
            (x @ x).sum().item()
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    assert any(e.get("name") == "card_matmul" for e in events)


# ---------------------------------------------------------------------------
# the transformer's epilogues (ops/token_epilogue.py)
# ---------------------------------------------------------------------------

def _epilogue_counts():
    from opticalflowfromdepth_torch.ops import token_epilogue as te
    return (te.token_norm.launches, te.token_norm.plain, te.gelu.launches,
            te.gelu.plain)


def _bf16_step(t):
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.ldexp(torch.ones_like(a), torch.frexp(a).exponent - 8)


def test_gelu_kernel_bit_equal_over_every_bf16_pattern_and_random_f32(card):
    """The GELU kernel rounds where the op-by-op form rounds: every bf16
    bit pattern (NaN and inf as the plain version gives them; a ragged
    tail too) and random f32, bit for bit, on the card's own op-by-op
    kernels and on the model's ``_gelu``; the bf16 erfc table is
    ``torch.erfc`` of every pattern."""
    from opticalflowfromdepth_torch.models.gmflow import _gelu
    from opticalflowfromdepth_torch.ops import token_epilogue as te
    every = torch.arange(-32768, 32768, dtype=torch.int32,
                         device=card).to(torch.int16).view(torch.bfloat16)
    g = torch.Generator(device=card).manual_seed(5)
    f32 = torch.cat([6 * torch.randn(1 << 20, device=card, generator=g),
                     torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                                   float("nan"), 1e-40, -1e-40, 9.5, -9.5],
                                  device=card)])
    by_bits = torch.cat([every[32768:], every[:32768]])    # bits 0, 1, ...
    assert torch.equal(te.erfc_table(every.device),
                       torch.erfc(by_bits).view(torch.int16))
    with torch.inference_mode():
        for x, view in ((every, torch.int16), (every[:-5], torch.int16),
                        (f32, torch.int32)):
            before = _epilogue_counts()
            got = te.gelu(x)
            assert _epilogue_counts()[2] == before[2] + 1
            assert torch.equal(got.view(view), te.gelu_plain(x).view(view))
            assert torch.equal(got.view(view), _gelu(x).view(view))
            assert torch.equal(got.view(view), te.gelu(x).view(view))


def _norm_allowed(x, weight, bias, norm, want):
    """What the norm kernel may differ by from the op-by-op form: one bf16
    step of the norm, or where the norm is near 0 (``weight * xhat`` and
    ``bias`` cancelling) the f32 rounding of those terms, 2^-16 of their
    size, which can be many steps of so small a value; with a residual,
    plus one step of the sum (the add rounds that difference again)."""
    n32 = torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), weight,
                                         bias, 1e-5)
    terms = (n32 - bias).abs() + bias.abs()
    allowed = _bf16_step(norm) + 2.0 ** -16 * terms
    return allowed if want is norm else allowed + _bf16_step(want)


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("rows", [1, 7, 4097, 458752])
@pytest.mark.parametrize("c", [128, 256, 512])
def test_token_norm_kernel_within_one_bf16_step(card, c, rows,
                                                with_residual):
    """bf16 rows against the op-by-op form on the card: the kernel's
    two-pass f32 statistics and PyTorch's Welford sums round apart, so the
    norm may land one bf16 step off (or, near 0, the terms' f32 rounding
    off: ``_norm_allowed``), and the residual add, the plain version's
    own, carries that; run with ``-s`` for the share of values that
    differ (at most 1%) and of those more than a step of their own off."""
    from opticalflowfromdepth_torch.ops import token_epilogue as te
    g = torch.Generator(device=card).manual_seed(c + rows)
    weight = 1 + 0.1 * torch.randn(c, device=card, generator=g)
    bias = 0.1 * torch.randn(c, device=card, generator=g)
    x = (3 * torch.randn(rows, c, device=card, generator=g) + 0.5).to(
        torch.bfloat16)
    res = torch.randn(rows, c, device=card, generator=g).to(
        torch.bfloat16) if with_residual else None
    with torch.inference_mode():
        before = _epilogue_counts()
        got = te.token_norm(x, weight, bias, 1e-5, res)
        assert _epilogue_counts()[:2] == (before[0] + 1, before[1])
        norm = te.token_norm_plain(x, weight, bias, 1e-5)
        want = norm if res is None else res + norm
        again = te.token_norm(x, weight, bias, 1e-5, res)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    d = (got.float() - want.float()).abs()
    allowed = _norm_allowed(x, weight, bias, norm, want)
    differ = float((got != want).float().mean())
    past = float((d > _bf16_step(want)).float().mean())
    print(f"token_norm C={c} rows={rows} residual={with_residual}: "
          f"{differ:.3e} of the values differ, {past:.3e} by more than a "
          f"step of their own; at most {float((d / allowed).max()):.3f} of "
          f"what is allowed")
    assert bool((d <= allowed).all()) and differ <= 1e-2


@pytest.mark.parametrize("c", [8, 24, 128, 264, 512])
def test_token_norm_kernel_f32(card, c):
    """f32 rows (the f32 model's path): the two summation orders agree to
    f32 rounding."""
    from opticalflowfromdepth_torch.ops import token_epilogue as te
    g = torch.Generator(device=card).manual_seed(c)
    weight = 1 + 0.1 * torch.randn(c, device=card, generator=g)
    bias = 0.1 * torch.randn(c, device=card, generator=g)
    x = 3 * torch.randn(1001, c, device=card, generator=g) + 0.5
    res = torch.randn(1001, c, device=card, generator=g)
    with torch.inference_mode():
        before = _epilogue_counts()
        got = te.token_norm(x, weight, bias, 1e-5, res)
        assert _epilogue_counts()[:2] == (before[0] + 1, before[1])
        want = te.token_norm_plain(x, weight, bias, 1e-5, res)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_epilogues_refuse_what_the_kernels_do_not_take(card):
    """C not a multiple of 8 or over 512, f16, a residual of another
    dtype, non-contiguous or misaligned operands, a graph that autograd
    records: the op raises and launches nothing (no plain path on the
    card). A cross layer with its FFN on the card launches its 2 norms
    and its GELU where autograd records nothing, and none where it
    records (its op-by-op forms then carry the gradient)."""
    from opticalflowfromdepth_torch.models import gmflow as T
    from opticalflowfromdepth_torch.ops import token_epilogue as te
    g = torch.Generator(device=card).manual_seed(9)

    def rows(n, c, dtype=torch.bfloat16):
        return torch.randn(n, c, device=card, generator=g).to(dtype)

    def params(c):
        return (1 + 0.1 * torch.randn(c, device=card, generator=g),
                0.1 * torch.randn(c, device=card, generator=g))

    buf = rows(1, 64 * 129).view(-1)
    misaligned = buf[1:1 + 64 * 128].view(64, 128)
    assert misaligned.data_ptr() % 16
    wide = rows(64, 256)
    norm_cases = [(rows(64, 100), None), (rows(64, 520), None),
                  (rows(64, 128, torch.float16), None),
                  (rows(64, 128), rows(64, 128, torch.float32)),
                  (wide[:, :128], None), (misaligned, None),
                  (rows(64, 128), misaligned)]
    with torch.inference_mode():
        for x, res in norm_cases:
            weight, bias = params(x.shape[-1])
            before = _epilogue_counts()
            with pytest.raises(ValueError, match="does not take"):
                te.token_norm(x, weight, bias, 1e-5, res)
            assert _epilogue_counts() == before
        for x in (rows(64, 128, torch.float16), wide[:, :128], misaligned):
            before = _epilogue_counts()
            with pytest.raises(ValueError, match="kernel takes"):
                te.gelu(x)
            assert _epilogue_counts() == before
    weight, bias = params(128)
    weight.requires_grad_()
    before = _epilogue_counts()
    with pytest.raises(ValueError, match="records a graph"):
        te.token_norm(rows(64, 128), weight, bias, 1e-5)
    with pytest.raises(ValueError, match="records a graph"):
        te.gelu(rows(64, 128).requires_grad_())
    assert _epilogue_counts() == before

    torch.manual_seed(0)
    layer = T.TransformerLayer(128, False, 4, with_shift=True,
                               dtype=torch.bfloat16).to(card)
    src, tgt = rows(2 * 96, 128).view(2, 96, 128), rows(2 * 96, 128).view(
        2, 96, 128)
    for ctx, launches in ((torch.inference_mode(), (2, 0, 1, 0)),
                          (torch.enable_grad(), (0, 0, 0, 0))):
        before = _epilogue_counts()
        with ctx:
            y = layer(src, tgt, 8, 12, 2)
        assert tuple(a - b for a, b in zip(_epilogue_counts(), before)) \
            == launches
        assert y.requires_grad == (launches[0] == 0)
    y.float().sum().backward()
    assert layer.norm2.weight.grad is not None
