"""InstanceNorm2d(affine=False), optionally fused with ReLU, with its
backward (port of ``opticalflowfromdepth_tpu/ops/instance_norm.py``).

:func:`instance_norm` is a ``torch.autograd.Function``. On a CUDA tensor
its forward launches the Triton kernel below; on a CPU tensor it runs the
plain PyTorch version. Both follow the TPU kernel ``_in_kernel``: f32 sum
and sum of squares, variance clamped at 0, normalize in f32, then cast to
the input dtype. They also return the f32 per-(sample, channel) mean and
rstd, which the backward uses.

The backward is the closed form of the JAX package's ``_in_bwd``, in
plain PyTorch on both devices: the JAX package computes it in XLA,
outside any Pallas kernel, so there is no TPU kernel to port for it.

The Triton kernel replaces ``ops/instance_norm.py:_in_kernel``. It is
bound by bytes: it reads the map twice (statistics, then normalize) and
writes it once. One program owns one (sample, channel) row of H*W
contiguous NCHW values; a loop inside the program takes the place of the
TPU's sequential (phase, tile) grid.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch


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


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def _in_fwd_kernel(x_ptr, y_ptr, mean_ptr, rstd_ptr, n, inv_n, eps,
                       RELU: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        base = row.to(tl.int64) * n
        offs = tl.arange(0, BLOCK)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(0, n, BLOCK):
            m = start + offs < n
            v = tl.load(x_ptr + base + start + offs, mask=m,
                        other=0.0).to(tl.float32)
            acc += v
            acc2 += v * v
        mean = tl.sum(acc, axis=0) * inv_n
        var = tl.maximum(tl.sum(acc2, axis=0) * inv_n - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        for start in range(0, n, BLOCK):
            m = start + offs < n
            v = tl.load(x_ptr + base + start + offs, mask=m,
                        other=0.0).to(tl.float32)
            y = (v - mean) * rstd
            if RELU:
                y = tl.maximum(y, 0.0)
            tl.store(y_ptr + base + start + offs,
                     y.to(y_ptr.dtype.element_ty), mask=m)
        tl.store(mean_ptr + row, mean)
        tl.store(rstd_ptr + row, rstd)

    return _in_fwd_kernel, triton.next_power_of_2


def _instance_norm_triton(x: torch.Tensor, eps: float, relu: bool):
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm: tensor on {x.device}; the kernel "
                         "takes CUDA tensors (CPU tensors take the plain "
                         "version)")
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16,
                                       torch.float16):
        raise ValueError(f"instance_norm takes NCHW f32/bf16/f16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    kernel, next_pow2 = _triton_kernel()
    b, c, h, w = x.shape
    n = h * w
    xc = x.contiguous()
    y = torch.empty_like(xc)
    mean = torch.empty(b, c, 1, 1, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if b * c and n:
        block = min(4096, max(128, next_pow2(n)))
        with torch.cuda.device(x.device):
            kernel[(b * c,)](xc, y, mean, rstd, n, 1.0 / n, float(eps),
                             RELU=bool(relu), BLOCK=block, num_warps=8)
        instance_norm.launches += 1
    return y, mean, rstd


def instance_norm_bwd(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                      rstd: torch.Tensor, y_relu=None) -> torch.Tensor:
    """Closed-form backward (``_in_bwd``): with the ReLU gate applied to
    ``g`` first (``y_relu`` is the forward's output when it had a ReLU),
    ``dx = rstd * (g - mean(g) - yhat * mean(g * yhat))`` in f32, where
    ``yhat`` is the normalized ``x`` before the ReLU; cast to x's dtype."""
    g = g.float()
    if y_relu is not None:
        g = torch.where(y_relu > 0, g, torch.zeros((), device=g.device))
    yhat = (x.float() - mean) * rstd
    g_mean = g.mean(dim=(2, 3), keepdim=True)
    gy_mean = (g * yhat).mean(dim=(2, 3), keepdim=True)
    return (rstd * (g - g_mean - yhat * gy_mean)).to(x.dtype)


class _InstanceNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, eps, relu):
        if x.device.type == "cpu":
            y, mean, rstd = instance_norm_plain(x, eps, relu)
        else:
            y, mean, rstd = _instance_norm_triton(x, eps, relu)
        ctx.save_for_backward(x, mean, rstd, y if relu else None)
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, g, _g_mean, _g_rstd):
        x, mean, rstd, y = ctx.saved_tensors
        return instance_norm_bwd(g, x, mean, rstd, y), None, None


def instance_norm(x: torch.Tensor, eps: float = 1e-5, relu: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """InstanceNorm2d(affine=False) over (H, W) of NCHW ``x``, optional
    fused ReLU -> ``(y, mean, rstd)``; differentiable in ``x`` through
    ``y``. CPU tensors take the plain version; CUDA tensors launch the
    Triton kernel (``instance_norm.launches`` counts those launches)."""
    return _InstanceNorm.apply(x, eps, relu)


instance_norm.launches = 0
