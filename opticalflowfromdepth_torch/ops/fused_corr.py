"""Fused RAFT correlation lookup from a packed pyramid (port of
``opticalflowfromdepth_tpu/ops/fused_corr.py``, forward only).

``corr_levels_cat`` packs every pyramid level of the second feature map
into one ``[B, R, C]`` tensor (per level: x-major rows, y zero-padded to a
multiple of 8, see :func:`cat_meta`). ``fused_corr_lookup_cat`` then
answers one GRU iteration's lookup from it: on a CUDA tensor it launches
the hand-written kernel in ``csrc/fused_corr.cu``; on a CPU tensor it
runs the plain PyTorch version below, which computes the same window form
(dot products at the integer neighbours, then the bilinear combination).
Nothing falls back: a CUDA input that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .correlation import _avg_pool2x2


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def cat_meta(h: int, w: int, num_levels: int
             ) -> List[Tuple[int, int, int, int]]:
    """Per-level ``(hl, wl, hp, row_offset)`` of the packed tensor. Levels
    pooled to emptiness keep hl/wl = 0 and give zero lookups."""
    meta = []
    off = 0
    hl, wl = h, w
    for _ in range(num_levels):
        hp = _ceil(max(hl, 1), 8) * 8 if hl > 0 and wl > 0 else 0
        meta.append((hl, wl, hp, off))
        off += wl * hp
        hl, wl = hl // 2, wl // 2
    return meta


def corr_levels_cat(fmap2: torch.Tensor, num_levels: int,
                    dtype) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` feature map -> ``[B, R, C]`` packed pyramid.
    Pools the features in f32 and stores each level in ``dtype``."""
    b, h, w, c = fmap2.shape
    cur = fmap2.to(dtype)
    rows = []
    for (hl, wl, hp, _off) in cat_meta(h, w, num_levels):
        if hl > 0 and wl > 0:
            f2t = cur.transpose(1, 2)                       # [B, wl, hl, C]
            if hp != hl:
                f2t = F.pad(f2t, (0, 0, 0, hp - hl))
            rows.append(f2t.reshape(b, wl * hp, c))
            pooled = _avg_pool2x2(cur.float().permute(0, 3, 1, 2))
            cur = pooled.permute(0, 2, 3, 1).to(dtype)
    if not rows:
        return torch.zeros(b, 0, c, dtype=dtype, device=fmap2.device)
    return torch.cat(rows, dim=1)


def fused_corr_lookup_cat_plain(f1: torch.Tensor, f2cat: torch.Tensor,
                                coords: torch.Tensor, h2: int, w2: int,
                                num_levels: int = 4,
                                radius: int = 4) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same window form from the
    same packed tensor, accumulated in f32, output in f1's dtype."""
    b, n, c = f1.shape
    k = 2 * radius + 1
    k1 = k + 1
    corr = torch.matmul(f1.float(), f2cat.float().transpose(1, 2)) \
        * (1.0 / (c ** 0.5))                                 # [B, N, R]
    d = torch.arange(k1, dtype=torch.float32, device=f1.device) - radius
    outs = []
    for li, (hl, wl, hp, off) in enumerate(cat_meta(h2, w2, num_levels)):
        if hl == 0 or wl == 0:
            outs.append(torch.zeros(b, n, k * k, device=f1.device))
            continue
        cl = coords.float() * (1.0 / 2.0 ** li)
        x0 = torch.floor(cl[..., 0])
        y0 = torch.floor(cl[..., 1])
        fx = (cl[..., 0] - x0)[..., None, None]
        fy = (cl[..., 1] - y0)[..., None, None]
        xs = x0[..., None] + d                               # [B, N, K+1]
        ys = y0[..., None] + d
        inb = (((xs >= 0) & (xs < wl))[..., :, None]
               & ((ys >= 0) & (ys < hl))[..., None, :])     # [B, N, K+1, K+1]
        xi = xs.clamp(0, wl - 1).long()
        yi = ys.clamp(0, hl - 1).long()
        idx = off + xi[..., :, None] * hp + yi[..., None, :]
        dots = torch.gather(corr, 2, idx.reshape(b, n, -1)).reshape(idx.shape)
        dots = torch.where(inb, dots, torch.zeros((), device=f1.device))
        ty = (1.0 - fy) * dots[..., :, :k] + fy * dots[..., :, 1:]
        win = (1.0 - fx) * ty[..., :k, :] + fx * ty[..., 1:, :]
        outs.append(win.reshape(b, n, k * k))                # x-major
    return torch.cat(outs, dim=-1).to(f1.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("fused_corr").ofd_fused_corr_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _lookup_cuda(f1, f2cat, coords, meta, radius):
    tensors = (f1, f2cat, coords)
    if any(t.device.type != "cuda" or t.device != f1.device
           for t in tensors):
        raise ValueError("fused_corr_lookup_cat: f1, f2cat and coords must "
                         "all lie on the CPU or all on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("fused_corr_lookup_cat has no CUDA backward yet; "
                           "call it under torch.no_grad/inference_mode")
    if f1.dtype not in (torch.float32, torch.bfloat16) \
            or f2cat.dtype != f1.dtype:
        raise ValueError(f"fused_corr_lookup_cat: f1/f2cat must share dtype "
                         f"float32 or bfloat16, got {f1.dtype}/{f2cat.dtype}")
    b, n, c = f1.shape
    k = 2 * radius + 1
    if c % 8 or c > 512 or (k + 1) ** 2 > 128 or len(meta) > 8:
        raise ValueError(f"fused_corr kernel takes C % 8 == 0, C <= 512, "
                         f"radius <= 4 and <= 8 levels, got C={c}, "
                         f"radius={radius}, levels={len(meta)}")
    f1c = f1.contiguous()
    f2c = f2cat.contiguous()
    cc = coords.float().contiguous()
    if f1c.data_ptr() % 16 or f2c.data_ptr() % 16:
        raise ValueError("fused_corr kernel needs 16-byte aligned f1/f2cat")
    out = torch.empty(b, n, len(meta) * k * k, dtype=f1.dtype,
                      device=f1.device)
    flat = [v for lvl in meta for v in lvl]
    stream = torch.cuda.current_stream(f1.device).cuda_stream
    err = _kernel_fn()(
        f1c.data_ptr(), f2c.data_ptr(), cc.data_ptr(), out.data_ptr(),
        b, n, c, f2c.shape[1], len(meta), (ctypes.c_int * len(flat))(*flat),
        radius, 1.0 / (c ** 0.5), int(f1.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"fused_corr kernel launch failed: CUDA error {err}")
    fused_corr_lookup_cat.launches += 1
    return out


def fused_corr_lookup_cat(f1: torch.Tensor, f2cat: torch.Tensor,
                          coords: torch.Tensor, h2: int, w2: int,
                          num_levels: int = 4,
                          radius: int = 4) -> torch.Tensor:
    """Window lookups from the packed pyramid: f1 ``[B, N, C]`` (compute
    dtype), f2cat ``[B, R, C]`` (:func:`corr_levels_cat` of a
    ``[B, h2, w2, C]`` map), coords ``[B, N, 2]`` level-0 centres ->
    ``[B, N, num_levels*(2r+1)^2]`` in f1's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``fused_corr_lookup_cat.launches`` counts those launches)."""
    meta = cat_meta(h2, w2, num_levels)
    b, n, c = f1.shape
    rows = sum(wl * hp for (_, wl, hp, _) in meta)
    if f2cat.shape != (b, rows, c) or coords.shape != (b, n, 2):
        raise ValueError(f"fused_corr_lookup_cat: shapes f1 {tuple(f1.shape)}"
                         f", f2cat {tuple(f2cat.shape)} (want {(b, rows, c)})"
                         f", coords {tuple(coords.shape)}")
    if all(t.device.type == "cpu" for t in (f1, f2cat, coords)):
        return fused_corr_lookup_cat_plain(f1, f2cat, coords, h2, w2,
                                           num_levels, radius)
    return _lookup_cuda(f1, f2cat, coords, meta, radius)


fused_corr_lookup_cat.launches = 0


def fused_corr_lookup(fmap1: torch.Tensor, fmap2: torch.Tensor,
                      coords: torch.Tensor, num_levels: int = 4,
                      radius: int = 4, dtype=torch.float32) -> torch.Tensor:
    """CorrPyramid-shaped convenience: NHWC fmap1/fmap2 ``[B, H, W, C]``,
    coords ``[B, H, W, 2]`` -> ``[B, H, W, num_levels*(2r+1)^2]``."""
    b, h, w, c = fmap1.shape
    f1 = fmap1.to(dtype).reshape(b, h * w, c)
    f2cat = corr_levels_cat(fmap2, num_levels, dtype)
    out = fused_corr_lookup_cat(f1, f2cat, coords.reshape(b, h * w, 2),
                                h, w, num_levels, radius)
    return out.reshape(b, h, w, -1)
