"""Z-buffer forward warp (port of ``opticalflowfromdepth_tpu/ops/forward_warp.py``).

Every source pixel splats ``obj[:, j, i]`` to its target ``(y, x) =
trunc(clamp(p0 + flow, 0, size - 1))``; at each target the writer of the
smallest depth wins, and among equal depths the first in raster order
(the reference's ``fw_cuda``, `alt_cuda/fw_cuda_kernel.cu:10-49`, scans
serially with a strict ``<`` test against a z-buffer set to 1000). A hit
writes only if the winner's depth is below ``ZBUF_INIT``; ``valid`` marks
the targets hit, ``collision`` those hit whose winner's depth is >= 1000.

The winner is the minimum of one 64-bit key per source pixel: the depth's
order-preserving bits (``-0.0 < +0.0``, as ``_float_to_sortable_int`` in
the JAX package) above the source's raster index. A minimum does not
depend on the order in which the writers arrive, so the result is
deterministic, and the output is a gather of the input: the kernel and
the plain version agree bit for bit.

:func:`forward_warp` on a CUDA tensor launches ``csrc/forward_warp.cu``
(``forward_warp.launches`` counts those calls), on a CPU tensor it runs
:func:`forward_warp_plain`. The kernel is not a port of a Pallas kernel:
the JAX package computes the warp with a 3-key ``lax.sort`` and a scatter
of each run's head (``ops/forward_warp.py:42``), which the card has no
reason to repeat. It replaces the reference's L0 CUDA kernel
``alt_cuda/fw_cuda``. It is one cooperative launch of persistent blocks
(:func:`plan`): the z-buffer's reset, the z-test (a pixel a thread a
step; where neighbouring lanes of a warp share a target, the warp takes
each target's minimum key first and one ``atomicMin`` issues for it) and
a gather of each winner's channels, ``VEC`` adjacent targets a thread
with vector loads and stores, the winner's depth taken from its key;
grid syncs between the three.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import _build
from ..utils.device import sm_count
from ..utils.profiling import spanned
from ..core.geometry import pixel_grid

ZBUF_INIT = 1000.0  # `fw_cuda.cpp:58`: the z-buffer's initial depth
_EMPTY = torch.iinfo(torch.int64).max

THREADS = 256       # csrc/forward_warp.cu:kThreads
VEC = 2             # csrc/forward_warp.cu:kVec, adjacent targets a thread
BLOCKS_PER_SM = 6   # csrc/forward_warp.cu:kBlocksPerSm (its launch bounds)


def _sortable_u32(depth: torch.Tensor) -> torch.Tensor:
    """f32 -> its order-preserving unsigned 32-bit key, in int64:
    negative floats' bits inverted, others' sign bit set (JAX's
    ``_float_to_sortable_int`` with the sign bit flipped)."""
    bits = depth.float().contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, -bits - 1, bits + 2 ** 31)


def forward_warp_plain(obj: torch.Tensor, flow: torch.Tensor,
                       depth: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``obj`` [B, C, H, W], ``flow`` [B, 2, H, W]
    (channel 0 = x), ``depth`` [B, 1, H, W] -> (out [B, C, H, W], valid
    [B, 1, H, W], collision [B, 1, H, W]), f32. The z-buffer pass is one
    ``scatter_reduce(..., "amin")`` of the key ``(sortable << 31) | src``,
    which fits in 63 bits."""
    b, c, h, w = obj.shape
    n = h * w
    p1 = pixel_grid(h, w, device=obj.device)[None] + flow.float()
    tx = torch.clamp(p1[:, 0], 0, w - 1).to(torch.int64).reshape(b, n)
    ty = torch.clamp(p1[:, 1], 0, h - 1).to(torch.int64).reshape(b, n)
    base = torch.arange(b, device=obj.device)[:, None] * n
    src = torch.arange(n, device=obj.device)
    key = (_sortable_u32(depth.reshape(b, n)) << 31) | src
    zbuf = torch.full((b * n,), _EMPTY, dtype=torch.int64, device=obj.device)
    zbuf.scatter_reduce_(0, (base + ty * w + tx).reshape(-1),
                         key.reshape(-1), "amin")
    zbuf = zbuf.reshape(b, n)
    hit = zbuf != _EMPTY
    winner = torch.where(hit, zbuf & (2 ** 31 - 1), torch.zeros_like(zbuf))
    win_depth = depth.float().reshape(b, n).gather(1, winner)
    write_ok = hit & (win_depth < ZBUF_INIT)
    gathered = obj.float().reshape(b, c, n).gather(
        2, winner[:, None].expand(b, c, n))
    out = torch.where(write_ok[:, None], gathered, torch.zeros_like(gathered))
    collision = hit & ~(win_depth < ZBUF_INIT)
    return (out.reshape(b, c, h, w), hit.float().reshape(b, 1, h, w),
            collision.float().reshape(b, 1, h, w))


def plan(b: int, h: int, w: int, sms: int, vec: int = VEC,
         blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """The persistent blocks of THREADS for one call on a card of ``sms``
    SMs: a thread a unit of ``vec`` targets (the reset and the gather;
    the z-test takes a pixel a thread a step) while the blocks fit
    ``blocks_per_sm`` a SM (a cooperative launch must have every block
    resident: the grid syncs wait for all of them), then each thread
    takes more steps. The defaults are the kernel's;
    ``tools/warp_variants.py`` plans its variants with their own."""
    units = -(-b * h * w // vec)
    return max(1, min(sms * blocks_per_sm, -(-units // THREADS)))


def bind(lib: ctypes.CDLL):
    """The typed entry point ``ofd_forward_warp`` of a build of
    ``csrc/forward_warp.cu``."""
    fn = lib.ofd_forward_warp
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    return bind(_build.load("forward_warp"))


def _forward_warp_cuda(obj: torch.Tensor, flow: torch.Tensor,
                       depth: torch.Tensor, plant_fault: bool = False):
    """The kernel. ``plant_fault`` makes each group of equal targets keep
    its largest key (a fault that a check must catch); no path passes
    it."""
    if obj.device.type != "cuda":
        raise ValueError(f"forward_warp: tensor on {obj.device}; the kernel "
                         "takes CUDA tensors (CPU tensors take the plain "
                         "version)")
    b, c, h, w = obj.shape
    if flow.shape != (b, 2, h, w) or depth.shape != (b, 1, h, w):
        raise ValueError(f"forward_warp: obj {tuple(obj.shape)}, flow "
                         f"{tuple(flow.shape)}, depth {tuple(depth.shape)}")
    if any(t.dtype != torch.float32 for t in (obj, flow, depth)) \
            or any(t.device != obj.device for t in (flow, depth)):
        raise ValueError("forward_warp takes f32 tensors on one device")
    if b * h * w >= 2 ** 31:
        raise ValueError(f"forward_warp: {b}x{h}x{w} has over 2^31 pixels")
    obj, flow, depth = (t.contiguous() for t in (obj, flow, depth))
    out = torch.empty_like(obj)
    valid = torch.empty_like(depth)
    collision = torch.empty_like(depth)
    zbuf = torch.empty(b * h * w, dtype=torch.int64, device=obj.device)
    ptrs = [t.data_ptr() for t in (obj, flow, depth, zbuf, out, valid,
                                   collision)]
    if b * h * w:
        stream = torch.cuda.current_stream(obj.device).cuda_stream
        with torch.cuda.device(obj.device):
            err = _kernel_fn()(*ptrs, b, c, h, w,
                               plan(b, h, w, sm_count(obj.device.index)),
                               int(plant_fault), stream)
        if err:
            raise RuntimeError(f"forward_warp kernel launch failed: CUDA "
                               f"error {err}")
        forward_warp.launches += 1
    return out, valid, collision


@spanned("ofd.op.forward_warp")
def forward_warp(obj: torch.Tensor, flow: torch.Tensor, depth: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward-warp ``obj`` along ``flow`` with a nearest-depth z-buffer.

    ``obj`` [B, C, H, W] (or [C, H, W], as the JAX function takes it),
    ``flow`` [B, 2, H, W] in pixels (channel 0 = x), ``depth`` [B, 1, H,
    W] (smaller = closer = wins) -> (out, valid, collision), f32, the
    masks binary. CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if obj.dim() == 3:
        return tuple(t[0] for t in forward_warp(obj[None], flow[None],
                                                depth[None]))
    if obj.device.type == "cpu":
        return forward_warp_plain(obj, flow, depth)
    return _forward_warp_cuda(obj, flow, depth)


forward_warp.launches = 0


def forward_warp_flip(obj: torch.Tensor, depth: torch.Tensor,
                      horizontal: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``forward_warp(obj, flip_flow, depth)`` without a warp: along the
    mirror field of ``core.special_flow.flip_flow`` every target has
    exactly one writer (the integer targets are exact and in range), so
    the warp is the mirror, ``valid`` is all ones and the depth test is
    per pixel. [..., C, H, W] and [..., 1, H, W]."""
    ax = -1 if horizontal else -2
    f_obj = torch.flip(obj, (ax,)).float()
    f_depth = torch.flip(depth, (ax,))
    write_ok = f_depth < ZBUF_INIT
    out = torch.where(write_ok, f_obj, torch.zeros_like(f_obj))
    return out, torch.ones_like(depth, dtype=torch.float32), \
        (~write_ok).float()


def concat_flow(flow_ab: torch.Tensor, back_flow_ab: torch.Tensor,
                flow_bc: torch.Tensor, depth_b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flow A->B composed with B->C: ``(forward_warp(flowBC, by
    back_flowAB, depth_B) + flowAB) * valid`` (`preprocess.py:301-313`)."""
    warped, valid, _ = forward_warp(flow_bc, back_flow_ab, depth_b)
    return (warped + flow_ab) * valid, valid


def back_flow(flow_ab: torch.Tensor, depth_a: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward flow: ``-flowAB`` forward-warped by flowAB itself
    (`preprocess.py:315-326`)."""
    warped, valid, _ = forward_warp(flow_ab, flow_ab, depth_a)
    return (warped * -1.0) * valid, valid
