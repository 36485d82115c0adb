"""GMFlow (port of ``opticalflowfromdepth_tpu/models/gmflow.py``).

The reference's ``adjusted_gmflow/gmflow/`` as ``nn.Module``s with its
``state_dict`` names: a CNN backbone to 1/8 (or 1/8 and 1/4 through a
weight-shared trident conv), a 6-block transformer of self and cross
attention over Swin windows (shifted every other block), global or local
matching, flow propagation by feature attention, and the convex
upsampler. Images are NCHW ``[B, 3, H, W]`` in [0, 255] and flows NCHW
``[B, 2, H, W]``; inside, features and flows are NHWC / ``[B, L, C]``
tokens, as in the JAX package.

Every softmax over a window, a whole image (matching) or its flow
(propagation) goes through ``ops.flash.flash_softmax_matmul``: the CUDA
kernel on the card, its plain version on the CPU. The operands are in the
model's ``dtype``: in bf16 they are those of the JAX TPU path (bf16 q/k/v
for attention; bf16 features with the f32 grid, rounded by the kernel,
for matching; bf16 q/k with the f32 flow, rounded by the kernel, for
propagation); in f32 they stay f32, as on the JAX dense path. Parameters
stay f32; each layer casts at the call. A transformer layer's layer norms
(with their residual adds) and its GELU go through
``ops/token_epilogue.py`` in one pass each where autograd records nothing;
where it records (training), the layer runs that module's plain versions
(:func:`_layer_norm` plus the add, :func:`_gelu`) op by op.

Token order: at ``attn_num_splits`` k > 1 the transformer keeps its
tokens in the order of the windows the next block attends over (the
plain window partition, or that of the image rolled by half a window in
the shifted blocks): every op of a layer but the attention is per token,
so the order changes only where the shift does, by one gather of the
pair (:func:`reorder_tokens`; 7 a forward at 6 blocks), and each block's
q, k and v are views of its windows. At k = 1 the order is raster.

Sequence parallelism (the JAX modules' ``mesh`` / ``model_axis``): with
a ``group`` of more than one rank (a process group or a
``parallel.sequence.LocalRing``), global matching, full attention and
global flow propagation run as the ring of ``parallel.sequence`` with
their operands in f32 (the JAX casts; so the flash kernels' f32 routes,
whatever the model's dtype), and the Swin windows split over the group
where ``window_shards`` allows. Every rank returns the whole result.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.geometry import pixel_grid
from ..ops.flash import flash_softmax_matmul
from ..ops.instance_norm import instance_norm
from ..ops.sampling import flow_warp, resize_bilinear_align_corners
from ..ops.token_epilogue import (gelu, gelu_plain, records_graph,
                                  token_norm, token_norm_plain)
from ..parallel.sequence import (group_size, ring_softmax_matmul,
                                 sharded_global_matching,
                                 sharded_window_attention, window_shards)
from ..utils.profiling import annotate, spanned
from .layers import Conv, InstanceNorm, init_weights_
from .raft import convex_upsample


def _linear(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm with a compute dtype: statistics and normalization in
    f32, the result in the input's dtype (:func:`token_norm_plain`)."""
    return token_norm_plain(x, norm.weight, norm.bias, norm.eps)


_gelu = gelu_plain


def _norm(norm: nn.LayerNorm, x: torch.Tensor,
          residual: Optional[torch.Tensor], records: bool) -> torch.Tensor:
    """``residual + _layer_norm(norm, x)`` (the norm alone without a
    residual): op by op where autograd records a graph (the kernel has no
    backward), else in one pass through :func:`token_norm`."""
    if records:
        return token_norm_plain(x, norm.weight, norm.bias, norm.eps,
                                residual)
    return token_norm(x, norm.weight, norm.bias, norm.eps, residual)


# ---------------------------------------------------------------------------
# backbone
# ---------------------------------------------------------------------------

class _ResBlock(nn.Module):
    """Residual block of bias-free convs and instance norms, ReLU fused into
    the first two norms (`backbone.py:6-36`)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride, dtype, bias=False)
        self.conv2 = Conv(planes, planes, 3, 1, dtype, bias=False)
        self.downsample: Optional[nn.Sequential] = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                Conv(in_planes, planes, 1, stride, dtype), InstanceNorm())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = instance_norm(self.conv1(x), 1e-5, True)[0]
        y = instance_norm(self.conv2(y), 1e-5, True)[0]
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class _TridentConv(nn.Module):
    """One 3x3 kernel (no bias) applied at several strides
    (`trident_conv.py:64-72`)."""

    def __init__(self, channels: int, strides: Sequence[int], dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.strides = tuple(strides)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        dt = self.compute_dtype
        w = self.weight.to(dt)
        return [F.conv2d(x.to(dt), w, None, s, 1) for s in self.strides]


class CNNEncoder(nn.Module):
    """`backbone.py:39-117`: NCHW features at 1/8 (one scale) or [1/4, 1/8]
    through the trident conv (two scales), high to low resolution."""

    def __init__(self, output_dim: int = 128, num_output_scales: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, dtype, bias=False)
        self.layer1 = nn.Sequential(_ResBlock(64, 64, 1, dtype=dtype),
                                    _ResBlock(64, 64, 1, dtype=dtype))
        self.layer2 = nn.Sequential(_ResBlock(64, 96, 2, dtype=dtype),
                                    _ResBlock(96, 96, 1, dtype=dtype))
        stride3 = 2 if num_output_scales == 1 else 1
        self.layer3 = nn.Sequential(_ResBlock(96, 128, stride3, dtype=dtype),
                                    _ResBlock(128, 128, 1, dtype=dtype))
        self.conv2 = Conv(128, output_dim, 1, dtype=dtype)
        self.trident_conv: Optional[_TridentConv] = None
        if num_output_scales > 1:
            self.trident_conv = _TridentConv(
                output_dim, (1, 2, 4, 8)[:num_output_scales], dtype)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = torch.relu(instance_norm(self.conv1(x))[0])
        for layer in (self.layer1, self.layer2, self.layer3):
            x = layer(x)
        x = self.conv2(x)
        if self.trident_conv is None:
            return [x]
        return self.trident_conv(x)


# ---------------------------------------------------------------------------
# position embedding and window utilities (NHWC)
# ---------------------------------------------------------------------------

def position_embedding_sine(h: int, w: int, num_pos_feats: int = 64,
                            temperature: float = 10000.0,
                            device="cpu") -> torch.Tensor:
    """``[H, W, 2*num_pos_feats]`` sine embedding; `position.py:26-46`."""
    scale = 2 * math.pi
    ones = torch.ones(h, w, device=device)
    y_embed = torch.cumsum(ones, 0)
    x_embed = torch.cumsum(ones, 1)
    eps = 1e-6
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()],
                        dim=3).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()],
                        dim=3).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1)


def split_feature(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """``[B, H, W, C] -> [B*K*K, H/K, W/K, C]``, windows ordered [b, wy, wx];
    `gmflow/utils.py:5-30`."""
    b, h, w, c = x.shape
    k = num_splits
    x = x.reshape(b, k, h // k, k, w // k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, h // k, w // k, c)


def merge_splits(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """Inverse of :func:`split_feature`; `gmflow/utils.py:33-52`."""
    bk, hk, wk, c = x.shape
    k = num_splits
    x = x.reshape(bk // (k * k), k, k, hk, wk, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(bk // (k * k), k * hk, k * wk, c)


@functools.lru_cache(maxsize=None)
def _position_tile(h: int, w: int, num_splits: int, channels: int,
                   device: torch.device) -> torch.Tensor:
    """``[H, W, C]``: the sine embedding of one window, tiled over the
    image (made outside inference mode, so that training may use it)."""
    k = num_splits
    with torch.inference_mode(False):
        return position_embedding_sine(h // k, w // k, channels // 2,
                                       device=device).repeat(k, k, 1)


def feature_add_position(feature0: torch.Tensor, feature1: torch.Tensor,
                         attn_splits: int, channels: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add the sine position (inside each window when split);
    `utils.py:66-86`. The window's embedding tiled over the image, cached
    by shape and device, gives the reference's sums without splitting
    the features into windows."""
    _, h, w, _ = feature0.shape
    pos = _position_tile(h, w, attn_splits, channels, feature0.device)
    return feature0 + pos, feature1 + pos


def shift_window_attn_mask(h: int, w: int, window_h: int, window_w: int,
                           shift_h: int, shift_w: int,
                           device="cpu") -> torch.Tensor:
    """Swin SW-MSA mask ``[K*K, win, win]`` built from image regions
    (`transformer.py:19-43`). The model does not build it: the flash kernel
    and its plain version generate the same mask from token indices
    (``ops.flash.swin_mask_dense`` is this, tiled over the batch)."""
    img_mask = torch.zeros(1, h, w, 1, device=device)
    cnt = 0
    for hs in (slice(0, h - window_h), slice(h - window_h, h - shift_h),
               slice(h - shift_h, h)):
        for ws in (slice(0, w - window_w), slice(w - window_w, w - shift_w),
                   slice(w - shift_w, w)):
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    windows = split_feature(img_mask, w // window_w)
    windows = windows.reshape(-1, window_h * window_w)
    mask = windows[:, None, :] - windows[:, :, None]
    return torch.where(mask != 0, -100.0, 0.0)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _full_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """``[B, L, C]`` single-head attention; `transformer.py:8-16`."""
    return flash_softmax_matmul(q, k, v).to(v.dtype)


def _window_order(h: int, w: int, num_splits: int,
                  order: Optional[bool]) -> torch.Tensor:
    """The raster index ``[H*W]`` of each token in ``order``: None is
    raster; False the window order, each window's tokens together and the
    windows [wy, wx] (``split_feature``'s); True the same of the image
    rolled by (-(wh // 2), -(ww // 2)), the shifted blocks' windows."""
    if order is None:
        return torch.arange(h * w)
    k = num_splits
    wh, ww = h // k, w // k
    y = torch.arange(h).reshape(k, 1, wh, 1)             # [wy, ., ty, .]
    x = torch.arange(w).reshape(1, k, 1, ww)             # [., wx, ., tx]
    if order:
        y, x = (y + wh // 2) % h, (x + ww // 2) % w
    return (y * w + x).reshape(-1)


@functools.lru_cache(maxsize=None)
def token_reorder(h: int, w: int, num_splits: int, src: Optional[bool],
                  dst: Optional[bool], device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(index, inverse)`` on ``device``, cached: ``x[:, index]`` puts
    tokens in order ``src`` into order ``dst``, ``y[:, inverse]`` puts
    them back (made outside inference mode, as the position tile)."""
    with torch.inference_mode(False):
        arange = torch.arange(h * w)
        at_src = torch.empty_like(arange)
        at_src[_window_order(h, w, num_splits, src)] = arange
        index = at_src[_window_order(h, w, num_splits, dst)]
        inverse = torch.empty_like(index)
        inverse[index] = arange
        return index.to(device), inverse.to(device)


def _gather(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[:, index]`` for ``[B, L, C]`` rows; rows of whole 8-byte words
    are gathered as such (on the H100 twice the rate of 2-byte elements,
    2.3-2.7 against 1.1-1.3 TB/s at GMFlow's token grids)."""
    if (x.is_contiguous() and x.shape[2] * x.element_size() % 8 == 0
            and x.storage_offset() * x.element_size() % 8 == 0):
        return x.view(torch.int64).index_select(1, index).view(x.dtype)
    return x.index_select(1, index)


class _Gather(torch.autograd.Function):
    """Tokens ``[B, L, C]`` gathered by a permutation; the backward
    gathers by its inverse (deterministic, no scatter)."""

    @staticmethod
    def forward(ctx, x, index, inverse):
        ctx.inverse = inverse
        return _gather(x, index)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.inverse), None, None


@spanned("ofd.gmflow.reorder")
def reorder_tokens(x: torch.Tensor, h: int, w: int, num_splits: int,
                   src: Optional[bool], dst: Optional[bool]) -> torch.Tensor:
    """``[B, H*W, C]`` tokens in order ``src`` -> the same in order ``dst``
    (:func:`_window_order`): one gather. ``reorder_tokens.calls`` counts the
    calls."""
    reorder_tokens.calls += 1
    return _Gather.apply(x, *token_reorder(h, w, num_splits, src, dst,
                                           x.device))


reorder_tokens.calls = 0


def _window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      num_splits: int, with_shift: bool, h: int, w: int,
                      group=None) -> torch.Tensor:
    """Swin window attention (`transformer.py:46-105`) on ``[B, H*W, C]``
    tokens in the window order of ``with_shift``, the result in the same
    order. The windows (views) are the batch of one flash call (with a
    shift, the kernel generates the mask), split over ``group``'s ranks
    where ``window_shards`` allows."""
    b, _, c = q.shape
    wh, ww = h // num_splits, w // num_splits
    qs, ks, vs = (t.reshape(-1, wh * ww, c) for t in (q, k, v))
    swin = (num_splits, wh, ww, wh // 2, ww // 2) if with_shift else None
    if window_shards(group, b, qs.shape[0], with_shift):
        out = sharded_window_attention(qs, ks, vs, group, swin)
    else:
        out = flash_softmax_matmul(qs, ks, vs, swin=swin)
    return out.to(vs.dtype).reshape(b, h * w, c)


def _split_window_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, num_splits: int,
                            with_shift: bool, h: int, w: int,
                            group=None) -> torch.Tensor:
    """:func:`_window_attention` on tokens in raster order: gathered into
    the windows and back."""
    q, k, v = (reorder_tokens(t, h, w, num_splits, None, with_shift)
               for t in (q, k, v))
    out = _window_attention(q, k, v, num_splits, with_shift, h, w, group)
    return reorder_tokens(out, h, w, num_splits, with_shift, None)


class TransformerLayer(nn.Module):
    """Single-head attention (+ FFN unless ``no_ffn``);
    `transformer.py:108-185`."""

    def __init__(self, d_model: int = 128, no_ffn: bool = False,
                 ffn_dim_expansion: int = 4, with_shift: bool = False,
                 dtype=torch.float32, group=None):
        super().__init__()
        self.with_shift = with_shift
        self.dtype = dtype
        self.group = group
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.mlp: Optional[nn.Sequential] = None
        if not no_ffn:
            hidden = d_model * 2 * ffn_dim_expansion
            self.mlp = nn.Sequential(
                nn.Linear(d_model * 2, hidden, bias=False), nn.GELU(),
                nn.Linear(hidden, d_model, bias=False))
            self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, source: torch.Tensor, target: torch.Tensor, h: int,
                w: int, attn_num_splits: int) -> torch.Tensor:
        """The layer on ``[B, H*W, C]`` tokens in raster order."""
        k = attn_num_splits
        if k <= 1:
            return self.windowed(source, target, h, w, k)
        source, target = (reorder_tokens(t, h, w, k, None, self.with_shift)
                          for t in (source, target))
        return reorder_tokens(self.windowed(source, target, h, w, k),
                              h, w, k, self.with_shift, None)

    def windowed(self, source: torch.Tensor, target: torch.Tensor, h: int,
                 w: int, attn_num_splits: int) -> torch.Tensor:
        """The layer on tokens in its window order (raster at one split),
        the result in the same order."""
        dt = self.dtype
        q = _linear(self.q_proj, source, dt)
        k = _linear(self.k_proj, target, dt)
        v = _linear(self.v_proj, target, dt)
        if attn_num_splits > 1:
            message = _window_attention(q, k, v, attn_num_splits,
                                        self.with_shift, h, w, self.group)
        elif group_size(self.group) > 1:
            message = ring_softmax_matmul(q.float(), k.float(), v.float(),
                                          self.group).to(v.dtype)
        else:
            message = _full_attention(q, k, v)
        message = _linear(self.merge, message, dt)
        # training records a graph through the epilogues: op by op there
        records = records_graph(message, source, *self.parameters())
        if self.mlp is None:
            return _norm(self.norm1, message, source, records)
        y = torch.cat([source.to(dt), _norm(self.norm1, message, None,
                                            records)], dim=-1)
        y = _linear(self.mlp[0], y, dt)
        y = gelu_plain(y) if records else gelu(y)
        return _norm(self.norm2, _linear(self.mlp[2], y, dt), source, records)


class TransformerBlock(nn.Module):
    """Self attention, then cross attention with the FFN;
    `transformer.py:188-241`."""

    def __init__(self, d_model: int = 128, ffn_dim_expansion: int = 4,
                 with_shift: bool = False, dtype=torch.float32, group=None):
        super().__init__()
        self.with_shift = with_shift
        self.self_attn = TransformerLayer(d_model, True, ffn_dim_expansion,
                                          with_shift, dtype, group)
        self.cross_attn_ffn = TransformerLayer(d_model, False,
                                               ffn_dim_expansion, with_shift,
                                               dtype, group)

    def forward(self, source, target, h, w, attn_num_splits):
        """Tokens in the block's window order (raster at one split)."""
        source = self.self_attn.windowed(source, source, h, w,
                                         attn_num_splits)
        return self.cross_attn_ffn.windowed(source, target, h, w,
                                            attn_num_splits)


class FeatureTransformer(nn.Module):
    """Interleaved blocks over the concatenated pair ``[2B, L, C]``, the
    odd ones with shifted windows; `transformer.py:244-322`."""

    def __init__(self, num_layers: int = 6, d_model: int = 128,
                 ffn_dim_expansion: int = 4, dtype=torch.float32,
                 group=None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(d_model, ffn_dim_expansion, i % 2 == 1, dtype,
                             group)
            for i in range(num_layers))

    def forward(self, feature0: torch.Tensor, feature1: torch.Tensor,
                attn_num_splits: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[B, H, W, C]`` features in and out; in between the pair's
        tokens are gathered into each block's window order where it
        changes (module docstring), and back to raster at the end."""
        b, h, w, c = feature0.shape
        k = attn_num_splits
        concat0 = torch.cat([feature0.reshape(b, h * w, c),
                             feature1.reshape(b, h * w, c)], dim=0)
        order = None
        for block in self.layers:
            if k > 1 and block.with_shift != order:
                concat0 = reorder_tokens(concat0, h, w, k, order,
                                         block.with_shift)
                order = block.with_shift
            half0, half1 = concat0.chunk(2, dim=0)
            concat0 = block(concat0, torch.cat([half1, half0], dim=0), h, w,
                            k)
        if order is not None:
            concat0 = reorder_tokens(concat0, h, w, k, order, None)
        f0, f1 = concat0.chunk(2, dim=0)
        return f0.reshape(b, h, w, c), f1.reshape(b, h, w, c)


class FeatureFlowAttention(nn.Module):
    """Flow propagation, query and key from feature0, value the flow;
    `transformer.py:325-409`."""

    def __init__(self, in_channels: int = 128, dtype=torch.float32,
                 group=None):
        super().__init__()
        self.dtype = dtype
        self.group = group
        self.q_proj = nn.Linear(in_channels, in_channels)
        self.k_proj = nn.Linear(in_channels, in_channels)

    def forward(self, feature0: torch.Tensor, flow: torch.Tensor,
                local_window_attn: bool = False,
                local_window_radius: int = 1) -> torch.Tensor:
        """feature0 ``[B, H, W, C]``, flow ``[B, H, W, 2]`` -> ``[B, H, W, 2]``
        f32."""
        b, h, w, c = feature0.shape
        dt = self.dtype
        query = _linear(self.q_proj, feature0.reshape(b, h * w, c), dt)
        if not local_window_attn:
            # the reference's quirk (`transformer.py:357-364`): the key is a
            # projection of the query; the local branch projects feature0
            key = _linear(self.k_proj, query, dt)
            value = flow.reshape(b, h * w, 2)
            if group_size(self.group) > 1:
                out = ring_softmax_matmul(query.float(), key.float(),
                                          value.float(), self.group)
            else:
                out = flash_softmax_matmul(query, key, value)
            return out.reshape(b, h, w, 2)

        key = _linear(self.k_proj, feature0.reshape(b, h * w, c), dt)
        return local_flow_propagation(query.reshape(b, h, w, c),
                                      key.reshape(b, h, w, c), flow,
                                      local_window_radius)


@spanned("ofd.gmflow.local_propagation")
def local_flow_propagation(query: torch.Tensor, key: torch.Tensor,
                           flow: torch.Tensor, radius: int) -> torch.Tensor:
    """Propagation inside a ``(2r+1)^2`` window (`transformer.py:368-409`):
    each query ``[B, H, W, C]`` attends to the keys around it, zero-padded
    past the image, as k^2 shifted dot products in f32, and takes that
    softmax's mean of the zero-padded flow ``[B, H, W, 2]``.
    ``local_flow_propagation.calls`` counts the calls."""
    local_flow_propagation.calls += 1
    b, h, w, c = query.shape
    r = radius
    ks = 2 * r + 1
    kp = F.pad(key, (0, 0, r, r, r, r)).float()
    fp = F.pad(flow, (0, 0, r, r, r, r)).float()
    q = query.float()
    shifts = [(dy, dx) for dy in range(ks) for dx in range(ks)]
    scores = torch.stack([(q * kp[:, dy:dy + h, dx:dx + w]).sum(-1)
                          for dy, dx in shifts], -1) / (c ** 0.5)
    prob = torch.softmax(scores, dim=-1)
    out = torch.zeros(b, h, w, 2, device=flow.device)
    for i, (dy, dx) in enumerate(shifts):
        out = out + prob[..., i:i + 1] * fp[:, dy:dy + h, dx:dx + w]
    return out


local_flow_propagation.calls = 0


# ---------------------------------------------------------------------------
# matching (NHWC)
# ---------------------------------------------------------------------------

def global_correlation_softmax(feature0: torch.Tensor,
                               feature1: torch.Tensor,
                               pred_bidir_flow: bool = False,
                               dtype=None, group=None
                               ) -> Tuple[torch.Tensor, None]:
    """Global matching, ``softmax(f0 f1^T / sqrt(C)) @ grid - grid``
    (`matching.py:7-36`) as one flash call per direction, with the
    features in ``dtype`` (default: theirs); with a ``group`` of several
    ranks, the f32 ring of ``sharded_global_matching``. Returns (flow
    ``[B, H, W, 2]`` f32, or ``[2B, ...]`` bidirectional, and None: the
    probabilities never exist)."""
    if group_size(group) > 1:
        flow = sharded_global_matching(feature0, feature1, group)[0]
        if pred_bidir_flow:
            flow = torch.cat([flow, sharded_global_matching(
                feature1, feature0, group)[0]], dim=0)
        return flow, None
    b, h, w, c = feature0.shape
    dt = feature0.dtype if dtype is None else dtype
    f0 = feature0.reshape(b, h * w, c).to(dt)
    f1 = feature1.reshape(b, h * w, c).to(dt)
    grid = pixel_grid(h, w, device=feature0.device).permute(1, 2, 0)
    gv = grid.reshape(1, h * w, 2).expand(b, h * w, 2)
    corr = flash_softmax_matmul(f0, f1, gv)
    if pred_bidir_flow:
        corr = torch.cat([corr, flash_softmax_matmul(f1, f0, gv)], dim=0)
    return corr.reshape(-1, h, w, 2) - grid[None], None


@spanned("ofd.gmflow.local_matching")
def local_correlation_softmax(feature0: torch.Tensor, feature1: torch.Tensor,
                              local_radius: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matching inside a ``(2r+1)^2`` window, as k^2 shifted dot products;
    `matching.py:39-83`. Returns (flow ``[B, H, W, 2]``, prob ``[B, L,
    k^2]``). ``local_correlation_softmax.calls`` counts the calls."""
    local_correlation_softmax.calls += 1
    b, h, w, c = feature0.shape
    r = local_radius
    k = 2 * r + 1
    dev = feature0.device
    coords = pixel_grid(h, w, device=dev).permute(1, 2, 0)       # [H, W, 2]
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    window = torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)
    sample = coords.reshape(1, h * w, 1, 2) + window[None, None]
    valid = ((sample[..., 0] >= 0) & (sample[..., 0] < w)
             & (sample[..., 1] >= 0) & (sample[..., 1] < h))
    f0 = feature0.float()
    f1p = F.pad(feature1, (0, 0, r, r, r, r)).float()
    corr = torch.stack([(f0 * f1p[:, r + oy:r + oy + h, r + ox:r + ox + w])
                        .sum(-1) for oy in range(-r, r + 1)
                        for ox in range(-r, r + 1)], dim=-1)
    corr = corr.reshape(b, h * w, k * k) / (c ** 0.5)
    corr = torch.where(valid, corr, torch.full((), -1e9, device=dev))
    prob = torch.softmax(corr, dim=-1)
    correspondence = torch.einsum("blk,blkd->bld", prob,
                                  sample.expand(b, h * w, k * k, 2))
    return correspondence.reshape(b, h, w, 2) - coords[None], prob


local_correlation_softmax.calls = 0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def normalize_img(img0: torch.Tensor, img1: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ImageNet normalization of NCHW [0, 255] images; `utils.py:55-63`."""
    mean = torch.tensor([0.485, 0.456, 0.406],
                        device=img0.device).reshape(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225],
                       device=img0.device).reshape(1, 3, 1, 1)
    return (img0 / 255.0 - mean) / std, (img1 / 255.0 - mean) / std


def _upsample_bilinear(flow: torch.Tensor, factor: int) -> torch.Tensor:
    """``[B, H, W, 2]`` -> align-corners bilinear ``[B, 2, fH, fW]`` * f."""
    _, h, w, _ = flow.shape
    up = resize_bilinear_align_corners(flow, factor * h, factor * w) * factor
    return up.permute(0, 3, 1, 2)


class GMFlow(nn.Module):
    """Adjusted GMFlow; the forward contract of `gmflow.py:92-170`.

    ``forward(img0, img1, attn_splits_list, corr_radius_list,
    prop_radius_list, pred_bidir_flow, training)`` takes NCHW [0, 255]
    images and the per-scale recipe ([2], [-1], [-1] for one scale; [2,
    8], [-1, 4], [-1, 1] with refinement) and returns
    ``{"flow_preds": [...]}`` of NCHW f32 flows at full resolution, the
    last one convex-upsampled (``[2B, ...]`` with ``pred_bidir_flow``).
    ``generator`` draws random weights (the reference's init scheme).
    ``group``: the model group that matching, full attention, propagation
    and the windows are split over (module docstring); None: unsharded."""

    def __init__(self, num_scales: int = 1, upsample_factor: int = 8,
                 feature_channels: int = 128,
                 num_transformer_layers: int = 6,
                 ffn_dim_expansion: int = 4, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, group=None):
        super().__init__()
        self.num_scales = num_scales
        self.upsample_factor = upsample_factor
        self.feature_channels = feature_channels
        self.dtype = dtype
        self.group = group
        self.backbone = CNNEncoder(feature_channels, num_scales, dtype)
        self.transformer = FeatureTransformer(
            num_transformer_layers, feature_channels, ffn_dim_expansion,
            dtype, group)
        self.feature_flow_attn = FeatureFlowAttention(feature_channels, dtype,
                                                      group)
        self.upsampler = nn.Sequential(
            Conv(2 + feature_channels, 256, 3, dtype=dtype), nn.ReLU(),
            Conv(256, upsample_factor ** 2 * 9, 1, dtype=dtype))
        if generator is not None:
            init_gmflow_weights_(self, generator)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor,
                attn_splits_list: Sequence[int] = (2,),
                corr_radius_list: Sequence[int] = (-1,),
                prop_radius_list: Sequence[int] = (-1,),
                pred_bidir_flow: bool = False,
                training: bool = True) -> Dict[str, List[torch.Tensor]]:
        if not (len(attn_splits_list) == len(corr_radius_list)
                == len(prop_radius_list) == self.num_scales):
            raise ValueError(f"GMFlow(num_scales={self.num_scales}) needs one "
                             f"entry per scale in attn_splits_list, "
                             f"corr_radius_list and prop_radius_list")
        dt = self.dtype
        with annotate("ofd.gmflow.backbone"):
            img0, img1 = normalize_img(img0, img1)
            features = self.backbone(torch.cat([img0, img1], dim=0).to(dt))
        features = features[::-1]                      # low -> high res

        flow_preds: List[torch.Tensor] = []
        flow: Optional[torch.Tensor] = None
        for scale_idx in range(self.num_scales):
            factor = self.upsample_factor * 2 ** (self.num_scales - 1
                                                  - scale_idx)
            # every scale after the first refines the flow so far
            with (annotate("ofd.gmflow.refine") if scale_idx
                  else contextlib.nullcontext()):
                feat = features[scale_idx].permute(0, 2, 3, 1).float()
                feature0, feature1 = feat.chunk(2, dim=0)
                if pred_bidir_flow and scale_idx > 0:
                    feature0, feature1 = (
                        torch.cat([feature0, feature1], dim=0),
                        torch.cat([feature1, feature0], dim=0))
                if flow is not None:
                    _, fh, fw, _ = flow.shape
                    flow = resize_bilinear_align_corners(flow, 2 * fh,
                                                         2 * fw) * 2.0
                    flow = flow.detach()
                    with annotate("ofd.gmflow.warp"):
                        feature1 = flow_warp(feature1.permute(0, 3, 1, 2),
                                             flow.permute(0, 3, 1, 2)
                                             ).permute(0, 2, 3, 1)
                splits = attn_splits_list[scale_idx]
                corr_radius = corr_radius_list[scale_idx]
                prop_radius = prop_radius_list[scale_idx]

                with annotate("ofd.gmflow.transformer"):
                    feature0, feature1 = feature_add_position(
                        feature0, feature1, splits, self.feature_channels)
                    feature0, feature1 = self.transformer(
                        feature0.to(dt), feature1.to(dt), splits)
                    feature0, feature1 = feature0.float(), feature1.float()

                with annotate("ofd.gmflow.matching"):
                    if corr_radius == -1:
                        flow_pred = global_correlation_softmax(
                            feature0, feature1, pred_bidir_flow, dtype=dt,
                            group=self.group)[0]
                    else:
                        flow_pred = local_correlation_softmax(
                            feature0, feature1, corr_radius)[0]
                    flow = flow_pred if flow is None else flow + flow_pred
                if training:
                    with annotate("ofd.gmflow.upsample"):
                        flow_preds.append(_upsample_bilinear(flow, factor))

                with annotate("ofd.gmflow.propagation"):
                    if pred_bidir_flow and scale_idx == 0:
                        feature0 = torch.cat([feature0, feature1], dim=0)
                    flow = self.feature_flow_attn(feature0.to(dt),
                                                  flow.detach(),
                                                  prop_radius > 0,
                                                  prop_radius)
                if training and scale_idx < self.num_scales - 1:
                    with annotate("ofd.gmflow.upsample"):
                        flow_preds.append(_upsample_bilinear(flow, factor))

            if scale_idx == self.num_scales - 1:
                with annotate("ofd.gmflow.upsample"):
                    concat = torch.cat([flow.to(dt), feature0.to(dt)], dim=-1)
                    mask = self.upsampler(concat.permute(0, 3, 1, 2)).float()
                    flow_preds.append(convex_upsample(
                        flow.permute(0, 3, 1, 2), mask,
                        factor=self.upsample_factor))
        return {"flow_preds": flow_preds}



def init_gmflow_weights_(model: GMFlow, generator: torch.Generator) -> None:
    """Random weights from ``generator`` in the reference's scheme:
    He-normal fan-out backbone convs (and trident kernel), torch's default
    U(+-1/sqrt(fan_in)) for the upsampler, Xavier-uniform attention and
    FFN matrices (`transformer.py:_reset_parameters`) with U(+-1/sqrt(
    fan_in)) biases, LayerNorm scale 1 and shift 0."""
    init_weights_(model.backbone, generator)
    init_weights_(model.upsampler, generator, he_normal=False)
    with torch.no_grad():
        trident = model.backbone.trident_conv
        if trident is not None:
            std = math.sqrt(2.0 / (trident.weight.shape[0] * 9))
            trident.weight.normal_(0.0, std, generator=generator)
        for mod in (model.transformer, model.feature_flow_attn):
            for m in mod.modules():
                if isinstance(m, nn.Linear):
                    fan_out, fan_in = m.weight.shape
                    bound = math.sqrt(6.0 / (fan_in + fan_out))
                    m.weight.uniform_(-bound, bound, generator=generator)
                    if m.bias is not None:
                        b = 1.0 / math.sqrt(fan_in)
                        m.bias.uniform_(-b, b, generator=generator)
                elif isinstance(m, nn.LayerNorm):
                    m.reset_parameters()
