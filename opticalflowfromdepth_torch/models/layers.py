"""Convolutions, norms and the residual encoders shared by RAFT and the
classifier (port of ``opticalflowfromdepth_tpu/models/layers.py``).

NCHW ``nn.Module``s whose ``state_dict`` keys are those of the reference's
torch models (``adjusted_RAFT/core/extractor.py``), so its released
``.pth`` files load with ``strict=True``. Parameters stay f32; ``dtype``
is the compute dtype and each layer casts at the call, as the flax
modules do. ``train`` is passed down explicitly, as in the flax modules:
it makes BatchNorm use (and update) batch statistics and turns on the
encoder's dropout, whose mask comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops.instance_norm import instance_norm
from ..parallel.mesh import all_reduce_sum


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with SAME-style padding (scaled by ``dilation``) that
    runs in ``dtype``; ``bias=False`` for the GMFlow backbone's convs."""

    def __init__(self, cin: int, cout: int, kernel=3, stride: int = 1,
                 dtype=torch.float32, bias: bool = True, dilation: int = 1):
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        super().__init__(cin, cout, (kh, kw), stride=stride,
                         padding=((kh - 1) // 2 * dilation,
                                  (kw - 1) // 2 * dilation),
                         dilation=dilation, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, self.dilation)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=False, eps=1e-5), no parameters; backed by
    ``ops.instance_norm`` (the CUDA kernel on the card)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, train: bool = False,
                relu: bool = False) -> torch.Tensor:
        return instance_norm(x, self.eps, relu)[0]


class NoNorm(nn.Module):
    """norm_fn 'none'."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return x


class BatchNorm(nn.BatchNorm2d):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` with a compute dtype:
    statistics and normalization in f32, the result cast back to the input
    dtype. With ``train`` it normalizes with the biased batch statistics
    (``E[x^2] - E[x]^2``, clamped at 0) and updates the running ones as
    ``0.9 * old + 0.1 * batch``, the variance with the *biased* batch
    variance (``nn.BatchNorm2d`` would use the unbiased one).

    ``group`` (a process group, None by default): the batch statistics
    are those of the whole batch over the group's ranks (each rank's mean
    and mean square averaged by a differentiable all-reduce; the ranks'
    batches are equal), as the JAX model computes them on its global
    batch."""

    group = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            msq = (xf * xf).mean(dim=(0, 2, 3))
            if self.group is not None:
                both = all_reduce_sum(torch.stack([mean, msq]), self.group)
                mean, msq = both / dist.get_world_size(self.group)
            var = torch.clamp(msq - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


def make_norm(norm_fn: str, planes: int) -> nn.Module:
    """'batch' | 'instance' | 'none' norm layer for ``planes`` channels."""
    if norm_fn == "batch":
        return BatchNorm(planes)
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "none":
        return NoNorm()
    raise ValueError(f"unsupported norm_fn {norm_fn!r}")


def _norm_relu(norm: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
    """norm -> relu, fused into the instance-norm kernel when possible."""
    if isinstance(norm, InstanceNorm):
        return norm(x, relu=True)
    return torch.relu(norm(x, train))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` in training: keep each value with
    probability ``1 - rate`` and scale it by ``1 / (1 - rate)``. The mask
    is drawn from ``generator`` on its own device."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    return torch.where(u.to(x.device) < keep, x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class ResidualBlock(nn.Module):
    """Two 3x3 convs + skip (`extractor.py:6-56`). With stride != 1 the
    skip is ``downsample = Sequential(1x1 conv, norm3)``; ``norm3`` is also
    registered directly, as in the reference, so both keys exist."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride, dtype=dtype)
        self.conv2 = Conv(planes, planes, 3, dtype=dtype)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        self.downsample: Optional[nn.Sequential] = None
        if stride != 1:
            self.norm3 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                Conv(in_planes, planes, 1, stride, dtype=dtype), self.norm3)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = _norm_relu(self.norm1, self.conv1(x), train)
        y = _norm_relu(self.norm2, self.conv2(y), train)
        if self.downsample is not None:
            x = self.norm3(self.downsample[0](x), train)
        return torch.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (`extractor.py:60-116`); ``norm4`` is
    the skip's norm, registered twice like ResidualBlock's ``norm3``."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1, dtype=torch.float32):
        super().__init__()
        p4 = planes // 4
        self.conv1 = Conv(in_planes, p4, 1, dtype=dtype)
        self.conv2 = Conv(p4, p4, 3, stride, dtype=dtype)
        self.conv3 = Conv(p4, planes, 1, dtype=dtype)
        self.norm1 = make_norm(norm_fn, p4)
        self.norm2 = make_norm(norm_fn, p4)
        self.norm3 = make_norm(norm_fn, planes)
        self.downsample: Optional[nn.Sequential] = None
        if stride != 1:
            self.norm4 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                Conv(in_planes, planes, 1, stride, dtype=dtype), self.norm4)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = _norm_relu(self.norm1, self.conv1(x), train)
        y = _norm_relu(self.norm2, self.conv2(y), train)
        y = _norm_relu(self.norm3, self.conv3(y), train)
        if self.downsample is not None:
            x = self.norm4(self.downsample[0](x), train)
        return torch.relu(x + y)


class _Encoder(nn.Module):
    """Stem conv + norm, three stages of two blocks, 1x1 output conv, and
    dropout on the output in training when ``dropout > 0``. ``in_dim`` is
    3 for images and 2 for the classifier's flow input."""

    def __init__(self, block, dims, output_dim: int, norm_fn: str, dtype,
                 dropout: float = 0.0, in_dim: int = 3):
        super().__init__()
        self.dropout = dropout
        self.conv1 = Conv(in_dim, dims[0], 7, 2, dtype=dtype)
        self.norm1 = make_norm(norm_fn, dims[0])
        cin = dims[0]
        for i, (dim, stride) in enumerate(zip(dims, (1, 2, 2))):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                block(cin, dim, norm_fn, stride, dtype=dtype),
                block(dim, dim, norm_fn, 1, dtype=dtype)))
            cin = dim
        self.conv2 = Conv(cin, output_dim, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _norm_relu(self.norm1, self.conv1(x), train)
        for layer in (self.layer1, self.layer2, self.layer3):
            for blk in layer:
                x = blk(x, train)
        x = self.conv2(x)
        if train and self.dropout > 0:
            x = dropout(x, self.dropout, generator)
        return x


class BasicEncoder(_Encoder):
    """Six residual blocks to 1/8 resolution (`extractor.py:118-192`)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dtype=torch.float32, dropout: float = 0.0, in_dim: int = 3):
        super().__init__(ResidualBlock, (64, 96, 128), output_dim, norm_fn,
                         dtype, dropout, in_dim)


class SmallEncoder(_Encoder):
    """Bottleneck variant (`extractor.py:195-267`)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dtype=torch.float32, dropout: float = 0.0, in_dim: int = 3):
        super().__init__(BottleneckBlock, (32, 64, 96), output_dim, norm_fn,
                         dtype, dropout, in_dim)


def init_weights_(module: nn.Module, generator: torch.Generator,
                  he_normal: bool = True) -> None:
    """Random init from ``generator``, as the reference initializes:
    encoders (``he_normal``) get He-normal fan-out conv kernels
    (`extractor.py:150-157`) and zero biases; other convs (the update
    block) torch's default U(+-1/sqrt(fan_in)) for kernel and bias, and so
    does every ``nn.Linear`` (the classifier's head). BatchNorm gets scale
    1, shift 0, running mean 0 and variance 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.Conv2d):
                kh, kw = m.kernel_size
                if he_normal:
                    std = math.sqrt(2.0 / (m.out_channels * kh * kw))
                    m.weight.normal_(0.0, std, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                    continue
                bound = 1.0 / math.sqrt(m.in_channels * kh * kw)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
