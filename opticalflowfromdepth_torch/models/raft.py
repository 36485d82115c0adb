"""Adjusted RAFT (port of ``opticalflowfromdepth_tpu/models/raft.py``).

NCHW modules with the reference's ``state_dict`` names
(``adjusted_RAFT/core/raft.py``, ``update.py``). Images are ``[B, 3, H, W]``
in [0, 255]; flows are ``[B, 2, H, W]``. ``dtype`` is the compute dtype of
the encoders and the update block (parameters stay f32); correlation
features and the flow arithmetic stay f32, and in ``test_mode`` the final
upsample runs once, in f32. ``train`` turns on the context encoder's batch
statistics and the encoders' dropout.

Blocked layout (training with ``blocked_supervision``): the NCHW
counterpart of the JAX package's ``[B, h, w, f*f, C]`` is ``[B, f*f, C,
h, w]`` (its axes in the order ``(0, 3, 4, 1, 2)``), sub-pixel ``(i, j)``
of a block at ``i * f + j``; a mask or valid map ``[B, H, W]`` blocks to
``[B, f*f, h, w]``.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.utils.checkpoint

from ..core.geometry import pixel_grid
from ..ops.correlation import CorrPyramid, on_demand_corr
from ..ops.fused_corr import corr_levels_cat, fused_corr_lookup_cat
from ..ops.sampling import resize_bilinear_align_corners
from ..utils.profiling import annotate
from .layers import BasicEncoder, Conv, SmallEncoder, init_weights_


def coords_grid(b: int, h: int, w: int, device="cpu") -> torch.Tensor:
    """[B, 2, H, W] identity coords (x, y); `core/utils/utils.py:74-77`."""
    return pixel_grid(h, w, device=device)[None].expand(b, 2, h, w)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x align-corners bilinear upsample of [B, 2, H, W] flow, times 8."""
    _, _, h, w = flow.shape
    up = resize_bilinear_align_corners(flow.permute(0, 2, 3, 1), 8 * h, 8 * w)
    return 8.0 * up.permute(0, 3, 1, 2)


def unblock_pixels(up: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Blocked [B, f*f, C, h, w] -> full-res [B, C, h*f, w*f]
    (depth-to-space; the inverse of :func:`block_pixels`)."""
    b, _, c, h, w = up.shape
    f = factor
    up = up.reshape(b, f, f, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return up.reshape(b, c, h * f, w * f)


def block_pixels(x: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Full-res [B, ..., H, W] -> blocked [B, f*f, ..., h, w]
    (space-to-depth): flows [B, C, H, W] -> [B, f*f, C, h, w], valid maps
    [B, H, W] -> [B, f*f, h, w]. Training supervision can run in this
    layout (``RAFT(blocked_supervision=True)``): the ground truth and the
    valid map are blocked once a step, and the loss and metrics see the
    same values in blocked order."""
    b, hh, ww = x.shape[0], x.shape[-2], x.shape[-1]
    rest = tuple(x.shape[1:-2])
    f, r = factor, len(rest)
    x = x.reshape((b,) + rest + (hh // f, f, ww // f, f))
    x = x.permute((0, r + 2, r + 4) + tuple(range(1, r + 1)) + (r + 1, r + 3))
    return x.reshape((b, f * f) + rest + (hh // f, ww // f))


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, factor: int = 8,
                    dtype=torch.float32, pixel_shuffle: bool = True
                    ) -> torch.Tensor:
    """Convex-combination upsampling (`raft.py:72-83`): flow [B, 2, H, W],
    mask [B, 9*f*f, H, W] -> [B, 2, f*H, f*W], or with ``pixel_shuffle``
    off the blocked [B, f*f, 2, H, W]. Softmax over the 9 taps in f32;
    taps in (ky, kx) row-major order with zero padding (F.unfold's); the
    combination runs in ``dtype``."""
    b, _, h, w = flow.shape
    f = factor
    mask = torch.softmax(mask.float().reshape(b, 9, f * f, h, w), dim=1)
    mask = mask.to(dtype)
    fp = nn.functional.pad((f * flow).to(dtype), (1, 1, 1, 1))
    up = torch.zeros(b, f * f, 2, h, w, dtype=dtype, device=flow.device)
    for k in range(9):
        dy, dx = divmod(k, 3)
        up = up + mask[:, k, :, None] * fp[:, None, :, dy:dy + h, dx:dx + w]
    return unblock_pixels(up, f) if pixel_shuffle else up


# remat="dots": what each GRU iteration keeps for its backward (the JAX
# package saves its dot products), the rest recomputed
DOTS_SAVED = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
              torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
              torch.ops.ofd.fused_corr_lookup.default)
_dots_contexts = functools.partial(
    torch.utils.checkpoint.create_selective_checkpoint_contexts,
    list(DOTS_SAVED))


class FlowHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, dtype):
        super().__init__()
        self.conv1 = Conv(input_dim, hidden_dim, 3, dtype=dtype)
        self.conv2 = Conv(hidden_dim, 2, 3, dtype=dtype)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    """Plain 3x3 ConvGRU (small model); `update.py:16-31`."""

    def __init__(self, hidden_dim: int, input_dim: int, dtype):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = Conv(cin, hidden_dim, 3, dtype=dtype)
        self.convr = Conv(cin, hidden_dim, 3, dtype=dtype)
        self.convq = Conv(cin, hidden_dim, 3, dtype=dtype)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class SepConvGRU(nn.Module):
    """Separable 1x5 then 5x1 ConvGRU; `update.py:33-60`."""

    def __init__(self, hidden_dim: int, input_dim: int, dtype):
        super().__init__()
        cin = hidden_dim + input_dim
        for i, kernel in ((1, (1, 5)), (2, (5, 1))):
            for g in "zrq":
                setattr(self, f"conv{g}{i}",
                        Conv(cin, hidden_dim, kernel, dtype=dtype))

    def forward(self, h, x):
        for i in (1, 2):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{i}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{i}")(hx))
            q = torch.tanh(getattr(self, f"convq{i}")(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class BasicMotionEncoder(nn.Module):
    """`update.py:79-97`: 128 output channels (126 + the flow)."""

    def __init__(self, corr_planes: int, dtype):
        super().__init__()
        self.convc1 = Conv(corr_planes, 256, 1, dtype=dtype)
        self.convc2 = Conv(256, 192, 3, dtype=dtype)
        self.convf1 = Conv(2, 128, 7, dtype=dtype)
        self.convf2 = Conv(128, 64, 3, dtype=dtype)
        self.conv = Conv(64 + 192, 126, 3, dtype=dtype)

    def forward(self, flow, corr):
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SmallMotionEncoder(nn.Module):
    """`update.py:62-77`: 82 output channels (80 + the flow)."""

    def __init__(self, corr_planes: int, dtype):
        super().__init__()
        self.convc1 = Conv(corr_planes, 96, 1, dtype=dtype)
        self.convf1 = Conv(2, 64, 7, dtype=dtype)
        self.convf2 = Conv(64, 32, 3, dtype=dtype)
        self.conv = Conv(128, 80, 3, dtype=dtype)

    def forward(self, flow, corr):
        cor = torch.relu(self.convc1(corr))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    """`update.py:114-136`."""

    def __init__(self, corr_planes: int, hidden_dim: int, dtype):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes, dtype)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim, dtype)
        self.flow_head = FlowHead(hidden_dim, 256, dtype)
        self.mask = nn.Sequential(Conv(hidden_dim, 256, 3, dtype=dtype),
                                  nn.ReLU(),
                                  Conv(256, 64 * 9, 1, dtype=dtype))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


class SmallUpdateBlock(nn.Module):
    """`update.py:99-112`: no upsample mask."""

    def __init__(self, corr_planes: int, hidden_dim: int, dtype):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_planes, dtype)
        self.gru = ConvGRU(hidden_dim, 82 + 64, dtype)
        self.flow_head = FlowHead(hidden_dim, 128, dtype)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, None, self.flow_head(net)


class RAFT(nn.Module):
    """Adjusted RAFT (`raft.py:86-144`).

    ``corr_impl`` picks the correlation: ``"fused"`` (packed pyramid built
    once, one fused lookup per iteration: the CUDA kernels on the card),
    ``"pyramid"`` (dense volume, plain PyTorch) or ``"alternate"``
    (on-demand lookup, plain PyTorch). ``dropout`` is the encoders' output
    dropout in training. ``generator`` seeds a random init.

    The JAX package's scheduling options, which change no number:
    ``remat`` ("none", "dots" or "full") runs each GRU iteration under
    ``torch.utils.checkpoint`` (non-reentrant) in training: "full"
    recomputes all of it in the backward; "dots" keeps the outputs of the
    convolutions, matrix products and the lookup (:data:`DOTS_SAVED`,
    a selective checkpoint policy) and recomputes the rest, as JAX's
    ``dots_with_no_batch_dims_saveable``, so the lookup runs once forward
    and once backward an iteration. ``unroll`` (an int >= 0) is the JAX
    scan's unroll factor, kept so that a JAX configuration builds; the
    eager loop runs one iteration at a time whatever it is.
    ``blocked_supervision`` (the basic model, in training) returns the
    per-iteration flows in the blocked layout (module docstring).
    """

    def __init__(self, small: bool = False, corr_levels: int = 4,
                 corr_impl: str = "pyramid", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0, remat: str = "none", unroll: int = 1,
                 blocked_supervision: bool = False):
        super().__init__()
        if corr_impl not in ("pyramid", "fused", "alternate"):
            raise ValueError(f"RAFT.corr_impl must be pyramid/fused/alternate,"
                             f" got {corr_impl!r}")
        if remat not in ("none", "dots", "full"):
            raise ValueError(f"RAFT.remat must be none/dots/full, got "
                             f"{remat!r}")
        if not isinstance(unroll, int) or isinstance(unroll, bool) \
                or unroll < 0:
            raise ValueError(f"RAFT.unroll must be an int >= 0, got "
                             f"{unroll!r}")
        self.remat = remat
        self.unroll = unroll
        self.blocked_supervision = blocked_supervision
        self.small = small
        self.corr_levels = corr_levels
        self.corr_radius = 3 if small else 4
        self.corr_impl = corr_impl
        self.dtype = dtype
        self.hidden_dim = 96 if small else 128
        self.context_dim = 64 if small else 128
        corr_planes = corr_levels * (2 * self.corr_radius + 1) ** 2
        enc = SmallEncoder if small else BasicEncoder
        self.fnet = enc(128 if small else 256, "instance", dtype=dtype,
                        dropout=dropout)
        self.cnet = enc(self.hidden_dim + self.context_dim,
                        "none" if small else "batch", dtype=dtype,
                        dropout=dropout)
        block = SmallUpdateBlock if small else BasicUpdateBlock
        self.update_block = block(corr_planes, self.hidden_dim, dtype)
        if generator is not None:
            init_weights_(self.fnet, generator)
            init_weights_(self.cnet, generator)
            init_weights_(self.update_block, generator, he_normal=False)

    def _corr_fn(self, fmap1: torch.Tensor, fmap2: torch.Tensor):
        """A lookup ``coords [B, 2, h, w] -> [B, L*(2r+1)^2, h, w]``."""
        b, c, h, w = fmap1.shape
        f1 = fmap1.permute(0, 2, 3, 1)                       # NHWC views
        f2 = fmap2.permute(0, 2, 3, 1)
        lv, r, dt = self.corr_levels, self.corr_radius, self.dtype
        if self.corr_impl == "fused":
            f2cat = corr_levels_cat(f2, lv, dt)
            f1flat = f1.to(dt).reshape(b, h * w, c)

            def lookup(coords):
                cl = coords.permute(0, 2, 3, 1).reshape(b, h * w, 2)
                return fused_corr_lookup_cat(f1flat, f2cat, cl, h, w, lv, r)
        elif self.corr_impl == "pyramid":
            pyramid = CorrPyramid(f1, f2, lv, r, dtype=dt)

            def lookup(coords):
                return pyramid(coords.permute(0, 2, 3, 1))
        else:
            def lookup(coords):
                return on_demand_corr(f1, f2, coords.permute(0, 2, 3, 1),
                                      lv, r, dtype=dt)
        return lambda coords: lookup(coords).reshape(b, h, w, -1).permute(
            0, 3, 1, 2)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: int = 12, flow_init: Optional[torch.Tensor] = None,
                test_mode: bool = False, train: Optional[bool] = None,
                generator: Optional[torch.Generator] = None
                ) -> Union[Tuple[torch.Tensor, torch.Tensor],
                           List[torch.Tensor]]:
        """Per-iteration upsampled flows ``[B, 2, H, W]`` (with
        ``blocked_supervision``, the basic model's ``[B, 64, 2, h, w]``) in
        the compute dtype; with ``test_mode`` the pair (1/8-res flow, final
        upsampled flow), both f32. ``train`` (default: the module's
        training flag) uses and updates the batch statistics and applies
        dropout, drawn from ``generator``."""
        train = self.training if train is None else train
        dt = self.dtype
        image1 = (2.0 * (image1 / 255.0) - 1.0).to(dt)
        image2 = (2.0 * (image2 / 255.0) - 1.0).to(dt)

        with annotate("ofd.raft.fnet"):
            fmaps = self.fnet(torch.cat([image1, image2], dim=0), train,
                              generator).float()
            fmap1, fmap2 = fmaps.chunk(2, dim=0)
        with annotate("ofd.raft.cnet"):
            cnet = self.cnet(image1, train, generator)
            net, inp = torch.split(cnet, [self.hidden_dim,
                                          self.context_dim], dim=1)
            net = torch.tanh(net)
            inp = torch.relu(inp)

        b, _, h8, w8 = fmap1.shape
        coords0 = coords_grid(b, h8, w8, fmap1.device)
        coords1 = coords0.clone()
        if flow_init is not None:
            coords1 = coords1 + flow_init
        with annotate("ofd.raft.corr_pyramid"):
            corr_fn = self._corr_fn(fmap1, fmap2)

        def step(net, coords1):
            corr = corr_fn(coords1).to(dt)
            flow = (coords1 - coords0).to(dt)
            net, up_mask, delta = self.update_block(net, inp, corr, flow)
            return net, up_mask, coords1 + delta.float()

        remat = self.remat != "none" and torch.is_grad_enabled()
        context_fn = _dots_contexts if self.remat == "dots" \
            else torch.utils.checkpoint.noop_context_fn
        flow_ups = []
        mask = None
        for _ in range(iters):
            coords1 = coords1.detach()                       # `raft.py:123`
            with annotate("ofd.raft.update"):
                if remat:
                    net, up_mask, coords1 = torch.utils.checkpoint.checkpoint(
                        step, net, coords1, use_reentrant=False,
                        context_fn=context_fn)
                else:
                    net, up_mask, coords1 = step(net, coords1)
                if test_mode:
                    mask = None if up_mask is None else up_mask.float()
                    continue
            with annotate("ofd.raft.upsample"):
                if up_mask is None:
                    flow_ups.append(upflow8(coords1 - coords0).to(dt))
                else:
                    flow_ups.append(convex_upsample(
                        coords1 - coords0, up_mask.float(), dtype=dt,
                        pixel_shuffle=not self.blocked_supervision).to(dt))

        if test_mode:
            with annotate("ofd.raft.upsample"):
                flow_lr = coords1 - coords0
                if self.small:
                    return flow_lr, upflow8(flow_lr)
                return flow_lr, convex_upsample(flow_lr, mask)
        return flow_ups
