"""InstanceNorm2d(affine=False), optionally fused with ReLU, with its
backward (port of ``opticalflowfromdepth_tpu/ops/instance_norm.py``).

:func:`instance_norm` is a ``torch.autograd.Function``. On a CUDA tensor
its forward launches the kernel in ``csrc/instance_norm.cu``; on a CPU
tensor it runs the plain PyTorch version. Both follow the TPU kernel
``_in_kernel``: f32 sum and sum of squares, variance clamped at 0,
normalize in f32, then cast to the input dtype. They also return the f32
per-(sample, channel) mean and rstd, which the backward uses.

The backward is the closed form of the JAX package's ``_in_bwd``
(:func:`instance_norm_bwd`, which CPU tensors take). The JAX package
computes it in XLA, outside any Pallas kernel; on CUDA tensors it is a
kernel of its own in the same source, which replaces no TPU kernel.

The forward kernel replaces ``ops/instance_norm.py:_in_kernel``. Both
kernels are bound by bytes and read each operand from device memory once:
every block holds its part of the rows in shared memory between the row
sums and the write, and long rows are split across a thread block cluster
whose blocks add their partial sums through distributed shared memory.
:func:`plan` picks, per shape and number of operands (x in the forward;
g, x and, after a ReLU, y in the backward), the cluster size, each
block's slice and how many short rows a block takes;
:func:`split_sum_plain` and :func:`bwd_split_sum_plain` repeat its
partition of the sums.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from .. import _build
from ..utils.profiling import spanned


def instance_norm_plain(x: torch.Tensor, eps: float = 1e-5,
                        relu: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: NCHW x -> (y in x.dtype, mean, rstd), the
    statistics ``[B, C, 1, 1]`` f32."""
    xf = x.float()
    inv_n = 1.0 / (x.shape[2] * x.shape[3])
    mean = xf.sum(dim=(2, 3), keepdim=True) * inv_n
    var = torch.clamp((xf * xf).sum(dim=(2, 3), keepdim=True) * inv_n
                      - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), mean, rstd


SLICE_BYTES = 64 * 1024    # what a block aims to hold on chip
SMEM_CAP = 64 * 1024       # the most a block holds on chip at once
MIN_BLOCKS = 132           # a block a SM on the H100's 132
MAX_ROWS = 8               # whole rows a block at most
CLUSTERS = (1, 2, 4, 8)    # portable thread block cluster sizes


def plan(rows: int, n: int, itemsize: int, operands: int = 1) -> dict:
    """How a kernel cuts ``rows`` rows of ``n`` values of ``itemsize``
    bytes in each of ``operands`` tensors (the forward reads 1, the
    backward 2 or 3): ``cluster`` blocks a row of ``slice`` values each
    (the last block takes the rest), or with a cluster of 1
    ``rows_per_block`` whole rows a block; ``piece``: the values of each
    operand a block holds in shared memory at once, its whole part where
    all the operands' fit under ``SMEM_CAP`` (``resident``: each read
    once), else streamed twice; ``blocks``."""
    value_bytes = itemsize * operands
    row_bytes = n * value_bytes
    if 2 * row_bytes <= SLICE_BYTES:                  # short rows
        cluster, slice_ = 1, n
        k = max(1, min(MAX_ROWS, SLICE_BYTES // max(row_bytes, 1),
                       rows // MIN_BLOCKS))
        part = k * n
    else:
        cluster = next((c for c in CLUSTERS
                        if _ceil(n, c) * value_bytes <= SLICE_BYTES),
                       CLUSTERS[-1])
        while cluster < CLUSTERS[-1] and rows * cluster < MIN_BLOCKS:
            cluster *= 2
        slice_ = _ceil(_ceil(n, cluster), 8) * 8
        while cluster > 1 and (cluster - 1) * slice_ >= n:
            cluster //= 2
            slice_ = _ceil(_ceil(n, cluster), 8) * 8
        if cluster == 1:
            slice_ = n
        k, part = 1, slice_
    piece = max(1, min(part, SMEM_CAP // value_bytes))
    blocks = _ceil(rows, k) if cluster == 1 else rows * cluster
    return dict(cluster=cluster, slice=slice_, rows_per_block=k,
                piece=piece, resident=piece >= part, blocks=blocks)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def split_sum_plain(x: torch.Tensor, p: dict, eps: float = 1e-5,
                    relu: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version with the kernel's partition of the sums: each
    block's f32 partial sums over its part of the row (its pieces in
    order), added in the cluster's rank order; then the same statistics
    and normalisation. Within a block the kernel sums in another order
    (per thread, then a tree), so the two agree to f32 rounding."""
    b, c, h, w = x.shape
    n = h * w
    xf = x.float().reshape(b * c, n)
    sums = torch.zeros(b * c)
    sqs = torch.zeros(b * c)
    step = n if p["cluster"] == 1 else p["slice"]
    for start in range(0, n, step):          # the blocks, in rank order
        part_s = torch.zeros(b * c)
        part_q = torch.zeros(b * c)
        for ps in range(start, min(n, start + step), p["piece"]):
            v = xf[:, ps:min(n, start + step, ps + p["piece"])]
            part_s = part_s + v.sum(1)
            part_q = part_q + (v * v).sum(1)
        sums = sums + part_s
        sqs = sqs + part_q
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32)
    mean = sums * inv_n
    var = torch.clamp(sqs * inv_n - mean * mean, min=0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    y = (xf - mean[:, None]) * rstd[:, None]
    if relu:
        y = torch.relu(y)
    return (y.to(x.dtype).reshape(x.shape), mean.reshape(b, c, 1, 1),
            rstd.reshape(b, c, 1, 1))


def bwd_split_sum_plain(g: torch.Tensor, x: torch.Tensor,
                        mean: torch.Tensor, rstd: torch.Tensor, y_relu,
                        p: dict) -> torch.Tensor:
    """The backward's plain version with the kernel's partition of the
    sums (``p``: :func:`plan` with 2 operands, or 3 with ``y_relu``): each
    block's f32 partial sums of g' and g' yhat over its part of the row
    (its pieces in order), added in the cluster's rank order, times 1 / n;
    then dx as :func:`instance_norm_bwd` forms it."""
    b, c, h, w = x.shape
    n = h * w
    gf = g.float().reshape(b * c, n)
    if y_relu is not None:
        gf = torch.where(y_relu.reshape(b * c, n) > 0, gf,
                         torch.zeros((), device=gf.device))
    yhat = (x.float().reshape(b * c, n) - mean.reshape(-1, 1)) \
        * rstd.reshape(-1, 1)
    sums = torch.zeros(b * c, device=gf.device)
    sgys = torch.zeros(b * c, device=gf.device)
    step = n if p["cluster"] == 1 else p["slice"]
    for start in range(0, n, step):          # the blocks, in rank order
        part_s = torch.zeros(b * c, device=gf.device)
        part_q = torch.zeros(b * c, device=gf.device)
        for ps in range(start, min(n, start + step), p["piece"]):
            sl = slice(ps, min(n, start + step, ps + p["piece"]))
            part_s = part_s + gf[:, sl].sum(1)
            part_q = part_q + (gf[:, sl] * yhat[:, sl]).sum(1)
        sums = sums + part_s
        sgys = sgys + part_q
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32, device=gf.device)
    dx = rstd.reshape(-1, 1) * (gf - (sums * inv_n)[:, None]
                                - yhat * (sgys * inv_n)[:, None])
    return dx.to(x.dtype).reshape(x.shape)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=None)
def _plan_args(rows: int, n: int, itemsize: int, operands: int = 1
               ) -> Tuple[int, ...]:
    """A kernel's plan arguments for a shape (cached: the models call the
    same few shapes over and over)."""
    p = plan(rows, n, itemsize, operands)
    return p["cluster"], p["slice"], p["rows_per_block"], p["piece"]


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("instance_norm").ofd_instance_norm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel_fn():
    fn = _build.load("instance_norm").ofd_instance_norm_bwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_float]
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _instance_norm_cuda(x: torch.Tensor, eps: float, relu: bool):
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm: tensor on {x.device}; the kernel "
                         "takes CUDA tensors (CPU tensors take the plain "
                         "version)")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"instance_norm takes NCHW f32/bf16/f16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, c, h, w = x.shape
    n = h * w
    xc = x.contiguous()
    if xc.data_ptr() % 16:       # the kernel's 16-byte loads and stores
        xc = xc.clone()
    y = torch.empty_like(xc)
    mean = torch.empty(b, c, 1, 1, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if b * c and n:
        with torch.cuda.device(x.device):
            err = _kernel_fn()(
                xc.data_ptr(), y.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), b * c, n, _DTYPES[x.dtype],
                *_plan_args(b * c, n, x.element_size()), 1.0 / n,
                float(eps), int(relu),
                torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"instance_norm kernel launch failed: CUDA "
                               f"error {err}")
        instance_norm.launches += 1
    return y, mean, rstd


def instance_norm_bwd(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                      rstd: torch.Tensor, y_relu=None) -> torch.Tensor:
    """Closed-form backward (``_in_bwd``), plain PyTorch: with the ReLU
    gate applied to ``g`` first (``y_relu`` is the forward's output when it
    had a ReLU), ``dx = rstd * (g - mean(g) - yhat * mean(g * yhat))`` in
    f32, where ``yhat`` is the normalized ``x`` before the ReLU; cast to
    x's dtype."""
    g = g.float()
    if y_relu is not None:
        g = torch.where(y_relu > 0, g, torch.zeros((), device=g.device))
    yhat = (x.float() - mean) * rstd
    g_mean = g.mean(dim=(2, 3), keepdim=True)
    gy_mean = (g * yhat).mean(dim=(2, 3), keepdim=True)
    return (rstd * (g - g_mean - yhat * gy_mean)).to(x.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels take it, contiguous at a 16-byte address; a
    copy where it is not (counted in ``instance_norm.bwd_copies``)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    instance_norm.bwd_copies += 1
    return t.clone(memory_format=torch.contiguous_format)


def _instance_norm_bwd_cuda(g, x, mean, rstd, y_relu):
    """The backward kernel on CUDA tensors: the same function as
    :func:`instance_norm_bwd`; raises on what the kernel does not take."""
    ops = (g, x) if y_relu is None else (g, x, y_relu)
    if any(t.device != x.device for t in ops + (mean, rstd)) \
            or x.device.type != "cuda":
        raise ValueError("instance_norm backward: the kernel takes CUDA "
                         "tensors on one device (CPU tensors take the "
                         "plain version)")
    if x.dim() != 4 or x.dtype not in _DTYPES \
            or any(t.shape != x.shape or t.dtype != x.dtype for t in ops):
        raise ValueError(f"instance_norm backward takes NCHW f32/bf16/f16 "
                         f"g, x (and y) of one shape and dtype, got "
                         f"{[(tuple(t.shape), t.dtype) for t in ops]}")
    b, c, h, w = x.shape
    stats = (b, c, 1, 1)
    if any(t.shape != stats or t.dtype != torch.float32
           or not t.is_contiguous() for t in (mean, rstd)):
        raise ValueError(f"instance_norm backward takes the forward's f32 "
                         f"mean and rstd of shape {stats}")
    n = h * w
    ops = tuple(_aligned(t) for t in ops)
    dx = torch.empty_like(ops[1], memory_format=torch.contiguous_format)
    if b * c and n:
        gc, xc = ops[:2]
        yc = ops[2] if len(ops) == 3 else None
        with torch.cuda.device(x.device):
            err = _bwd_kernel_fn()(
                gc.data_ptr(), xc.data_ptr(),
                None if yc is None else yc.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), dx.data_ptr(), b * c, n, _DTYPES[x.dtype],
                *_plan_args(b * c, n, x.element_size(), len(ops)), 1.0 / n,
                int(yc is not None),
                torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"instance_norm backward kernel launch "
                               f"failed: CUDA error {err}")
        instance_norm.bwd_launches += 1
    return dx


@spanned("ofd.op.instance_norm")
def _backward(g, x, mean, rstd, y_relu):
    if x.device.type == "cpu":
        return instance_norm_bwd(g, x, mean, rstd, y_relu)
    return _instance_norm_bwd_cuda(g, x, mean, rstd, y_relu)


class _InstanceNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, eps, relu):
        if x.device.type == "cpu":
            y, mean, rstd = instance_norm_plain(x, eps, relu)
        else:
            y, mean, rstd = _instance_norm_cuda(x, eps, relu)
        ctx.save_for_backward(x, mean, rstd, y if relu else None)
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    @once_differentiable        # the kernel's dx carries no graph
    def backward(ctx, g, _g_mean, _g_rstd):
        x, mean, rstd, y = ctx.saved_tensors
        return _backward(g, x, mean, rstd, y), None, None


@spanned("ofd.op.instance_norm")
def instance_norm(x: torch.Tensor, eps: float = 1e-5, relu: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """InstanceNorm2d(affine=False) over (H, W) of NCHW ``x``, optional
    fused ReLU -> ``(y, mean, rstd)``; differentiable in ``x`` through
    ``y``. CPU tensors take the plain versions; CUDA tensors launch the
    kernels (``instance_norm.launches`` counts the forward's launches,
    ``.bwd_launches`` the backward's, ``.bwd_copies`` the operands the
    backward had to copy first)."""
    return _InstanceNorm.apply(x, eps, relu)


instance_norm.launches = 0
instance_norm.bwd_launches = 0
instance_norm.bwd_copies = 0
