"""3x3 stride-1 SAME convolution in NHWC, with its backward (port of
``opticalflowfromdepth_tpu/ops/conv2d.py``).

:func:`conv3x3_s1` keeps the JAX contract: x ``[B, H, W, C]``, w ``[3, 3,
C, CO]`` (HWIO), zero padding of one pixel, products accumulated in f32,
the output in x's dtype. It is a ``torch.autograd.Function``: on CUDA
tensors the forward launches the hand-written kernel in
``csrc/conv3x3.cu`` on the route :func:`plan` picks from the shapes,
the dtype and the pointers' alignment; on CPU tensors it runs
:func:`conv3x3_s1_plain`, the TPU kernel's arithmetic (nine shifted
``[B*H*W, C] x [C, CO]`` products in f32 over the zero-padded input).
Nothing falls back: a CUDA input that the kernel does not take raises.

The backward is the JAX package's ``_bwd``, which it computes in XLA, not
Pallas: ``g`` cast to x's dtype; ``dx`` the same convolution of ``g``
with the kernel flipped in space and transposed in channels (through the
kernel on the card); ``dw`` nine tap products in f32, cast to w's dtype.

As in the JAX package, no model calls it: it is the op and its VJP.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from ..utils.device import sm_count
from ..utils.profiling import spanned

KERNEL_TILE_H = 16   # output rows per tile of every route (a band)

# The wgmma route's shared memory (csrc/conv3x3.cu, namespace conv_sm90):
# 1 KB of alignment slack, a ring of two haloed bands (18 x 18 pixels x 64
# channels, 41,472 bytes, each stage rounded up to 1 KB), the weights of
# one CO tile of 64 channels in slabs of 8 KB (one tap x 64 input
# channels: every slab where they fit, else a ring of 12 streamed
# through), the two warpgroups' output tiles (144 positions x 128 bytes
# each), the rings' barriers; at most 227 KB a block on the H100.
SMEM_CAP = 232448
BAND_STAGE_BYTES = 41984
RING_STAGES = 2
SLAB_RING = 12
WGMMA_M = 64                        # output channels a CO tile
H100_SMS = 132


class ConvPlan(NamedTuple):
    """How the kernel runs one call: ``route`` (``"wgmma"``, ``"mma_sync"``
    or ``"f32"``), the output ``tile`` (rows, columns), ``n`` output
    channels a CO tile and ``n_cot`` CO tiles, whether the weights stay
    ``resident`` in shared memory for a block's life (else they stream
    through a ring of slabs), the band ring's ``stages``, the shared
    memory ``smem`` a block takes, and the ``grid`` (blocks along x,
    y)."""
    route: str
    tile: Tuple[int, int]
    n: int
    n_cot: int
    resident: bool
    stages: int
    smem: int
    grid: Tuple[int, int]


def wgmma_smem(c: int, resident: bool) -> int:
    """Shared memory of a wgmma-route block at C = c, with every slab of
    the weights resident or a ring of ``SLAB_RING``."""
    slabs = 9 * -(-c // 64) if resident else SLAB_RING
    barriers = 2 * (RING_STAGES + (0 if resident else SLAB_RING)) * 8
    return 1024 + RING_STAGES * BAND_STAGE_BYTES + slabs * 64 * 128 \
        + 2 * 144 * 64 * 2 + barriers


def plan(b: int, h: int, w: int, c: int, co: int, dtype: torch.dtype,
         x_aligned: bool = True, w_aligned: bool = True,
         sms: int = H100_SMS) -> ConvPlan:
    """The kernel's route and parameters for x ``[b, h, w, c]`` and w ``[3,
    3, c, co]`` of ``dtype``; pure host arithmetic.

    bf16 with C % 8 == 0 and both pointers 16-byte aligned takes the wgmma
    route: persistent blocks (one an SM, ``sms`` of them at most) over
    (CO tile of 64, image, 16 x 16 tile) items; the CO tile's weights stay
    resident where all of C fits beside the ring (C <= 64), else they
    stream through a ring of slabs. The other bf16 inputs take the
    mma.sync route (64 output channels a block), f32 the f32 route
    (32)."""
    tiles = -(-h // KERNEL_TILE_H) * -(-w // KERNEL_TILE_H)
    tile = (KERNEL_TILE_H, KERNEL_TILE_H)
    if dtype == torch.bfloat16 and c % 8 == 0 and x_aligned and w_aligned:
        n_cot = -(-co // WGMMA_M)
        resident = wgmma_smem(c, True) <= SMEM_CAP
        return ConvPlan("wgmma", tile, WGMMA_M, n_cot, resident,
                        RING_STAGES, wgmma_smem(c, resident),
                        (min(n_cot * b * tiles, sms), 1))
    if dtype == torch.bfloat16:
        n_cot = -(-co // 64)
        return ConvPlan("mma_sync", tile, 64, n_cot, False, 1,
                        (18 * 18 * 40 + 9 * 32 * 72) * 2,
                        (tiles * n_cot, b))
    n_cot = -(-co // 32)
    return ConvPlan("f32", tile, 32, n_cot, False, 1,
                    (18 * 18 * 17 + 9 * 16 * 32) * 4, (tiles * n_cot, b))


def conv3x3_s1_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: nine shifted ``[B*H*W, C] x [C, CO]``
    products in f32 over the zero-padded input, in the order of the TPU
    kernel's taps, cast to x's dtype."""
    b, h, wd, c = x.shape
    co = w.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            part = xp[:, dy:dy + h, dx:dx + wd].reshape(-1, c) @ wf[dy, dx]
            acc = part if acc is None else acc + part
    return acc.reshape(b, h, wd, co).to(x.dtype)


def tolerance(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-element limit of ``|y - conv3x3_s1_plain(x, w)|`` for a ``y``
    that sums the same products in another order, f32 ``[B, H, W, CO]``.

    The products are exact in f32 (bf16 x bf16 is), so only the order of
    the sums differs: 2^-16 of ``sum |x.w|`` over the 9C terms (the tensor
    cores' f32 accumulation truncates toward zero at each mma step, up to
    ~2^-23 of the running sum, over up to 144 steps of 16 at C = 256). In
    bf16, plus one bf16 step of the output (2^-7 of it): the two f32 sums
    may round to neighbouring bf16 values."""
    tol = 2 ** -16 * conv3x3_s1_plain(x.float().abs(), w.float().abs()) \
        + 1e-12
    if x.dtype == torch.bfloat16:
        tol = tol + 2 ** -7 * conv3x3_s1_plain(x, w).float().abs()
    return tol


def conv3x3_s1_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The kernel's gradient, ``dw[ky, kx] = xpad[:, ky:ky+H, kx:kx+W]^T .
    g`` over all pixels, nine tap products in f32 -> ``[3, 3, C, CO]``
    f32."""
    b, h, wd, c = x.shape
    gf = g.float().reshape(-1, g.shape[-1])
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    taps = [xp[:, ky:ky + h, kx:kx + wd].reshape(-1, c).t() @ gf
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps).reshape(3, 3, c, -1)


ROUTES = {"f32": 0, "mma_sync": 1, "wgmma": 2}   # the C function's codes


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("conv3x3").ofd_conv3x3_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _conv_cuda(x: torch.Tensor, w: torch.Tensor,
               route: str = None) -> torch.Tensor:
    """The kernel on the route :func:`plan` picks; ``route="mma_sync"``
    forces that route on bf16 inputs (to time it beside the wgmma
    route)."""
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(f"conv3x3_s1 kernel takes x and w both bf16 or both "
                         f"f32, got {x.dtype}/{w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3_s1 kernel takes contiguous x and w")
    if any(t.device.type != "cuda" or t.device != x.device for t in (x, w)):
        raise ValueError(f"conv3x3_s1: x and w must both lie on the CPU or "
                         f"both on one CUDA device, got {x.device}/{w.device}")
    b, h, wd, c = x.shape
    co = w.shape[-1]
    if b > 65535:
        raise ValueError(f"conv3x3_s1 kernel takes B <= 65535, got B={b}")
    p = plan(b, h, wd, c, co, x.dtype, x.data_ptr() % 16 == 0,
             w.data_ptr() % 16 == 0, sm_count(x.device.index))
    if route is not None:
        if route != "mma_sync" or x.dtype != torch.bfloat16:
            raise ValueError(f"conv3x3_s1: route {route!r} is not forced "
                             f"on {x.dtype}")
        p = p._replace(route=route)
    if p.route == "wgmma" and co % 8:
        # the wgmma route copies w's rows in 16-byte pieces (TMA, cp.async):
        # output channels padded with zeros to a multiple of 8
        w = F.pad(w, (0, -co % 8))
    y = torch.empty(b, h, wd, co, dtype=x.dtype, device=x.device)
    err = _kernel_fn()(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, c,
                       co, w.shape[-1], ROUTES[p.route], int(p.resident),
                       p.grid[0],
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err}")
    conv3x3_s1.launches += 1
    return y


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3x3_s1_plain(x, w)
    return _conv_cuda(x, w)


class _Conv3x3(torch.autograd.Function):
    """The convolution with the JAX package's VJP (`conv2d.py:_bwd`)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    @spanned("ofd.op.conv3x3")
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_rot = w.flip(0, 1).transpose(2, 3).contiguous()
            dx = _forward(g, w_rot)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_s1_dw(x, g).to(w.dtype)
        return dx, dw


@spanned("ofd.op.conv3x3")
def conv3x3_s1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME convolution: x ``[B, H, W, C]``, w ``[3, 3, C,
    CO]`` -> ``[B, H, W, CO]`` in x's dtype, accumulated in f32;
    differentiable in x and w.

    CPU tensors take :func:`conv3x3_s1_plain`; CUDA tensors launch the
    kernel (``conv3x3_s1.launches`` counts those launches, the backward's
    ``dx`` included), which takes contiguous x and w, both bf16 or both
    f32, any B <= 65535, H, W, C >= 1 and CO >= 1."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[3] or min(x.shape) < 1 \
            or w.shape[3] < 1:
        raise ValueError(f"conv3x3_s1: x [B, H, W, C] and w [3, 3, C, CO], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    return _Conv3x3.apply(x, w)


conv3x3_s1.launches = 0
