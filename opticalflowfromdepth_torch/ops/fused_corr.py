"""Fused RAFT correlation lookup from a packed pyramid, with its backward
(port of ``opticalflowfromdepth_tpu/ops/fused_corr.py``).

``corr_levels_cat`` packs every pyramid level of the second feature map
into one ``[B, R, C]`` tensor (per level: x-major rows, y zero-padded to a
multiple of 8, see :func:`cat_meta`). ``fused_corr_lookup_cat`` then
answers one GRU iteration's lookup from it. It is one operator,
``torch.ops.ofd.fused_corr_lookup`` (a ``torch.library.custom_op`` with
its backward registered), so that a selective checkpoint policy can name
it and keep its output (``models/raft.py``, ``remat="dots"``): on CUDA
tensors its forward and its backward launch the hand-written kernels in
``csrc/fused_corr.cu``; on CPU tensors they run the plain PyTorch
versions below. They take what the JAX function takes: any C >= 1, any
radius >= 0, any level count (levels pooled to nothing, an ``f2cat`` of
zero rows). Both kernels take bf16 at C = 128 or 256 and radius <= 4 on
the tensor cores and everything else on the CUDA cores in f32
(:func:`route`). The forward computes the window form (dot products
at the integer neighbours, then the bilinear combination); on the tensor
cores per 8x8 query tile and level, from the box of rows its windows
cover (:func:`tile_plan` repeats the kernel's plan), the queries whose
windows overflow the box one by one. The backward forms the dense
``d_corr`` and takes its two products, as the TPU kernel does, without
atomics (every launch on the same inputs gives the same bits), on the
tensor cores with ``d_corr`` split into bf16 hi + lo; the plain backward
repeats the route's arithmetic. Nothing falls back: a CUDA input that
no kernel takes (another device or dtype, or a map past the kernels'
index types, :func:`_check_cuda`) raises. Coordinates get no gradient,
by contract (RAFT detaches them before every lookup).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from ..utils.profiling import spanned
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


KERNEL_TILE = 64      # rows of the backward kernels' tiles (both sides)
# the tensor-core backward's df2cat sweeps over more query tiles than this
# add their accumulator into an f32 scratch every 16 tiles
SWEEP_TILES = 64
QUERY_TILE = 8        # the forward's query tiles: 8x8 of the query image
BOX = 64              # the forward's box: at most 64 columns and 64 rows


def window_origins(coords: torch.Tensor, level: int, hl: int, wl: int,
                   radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' window of each query at ``level``: its first integer
    tap ``(ix0, iy0)`` (int64) from f32 coordinates ``[..., 2]``; the
    centre is clamped before the conversion, so a centre far out of range
    still has no tap in the level."""
    c = torch.floor(coords.float() * (1.0 / 2.0 ** level))
    ix0 = c[..., 0].clamp(-radius - 2.0, float(wl + radius)).long() - radius
    iy0 = c[..., 1].clamp(-radius - 2.0, float(hl + radius)).long() - radius
    return ix0, iy0


def query_width(n: int, h2: int, w2: int) -> int:
    """The width of the query image the forward tiles: the map's, when
    the queries are its pixels (RAFT's lookups), else one tile's."""
    return w2 if w2 > 0 and n == h2 * w2 else QUERY_TILE


def query_tiles(n: int, wq: int) -> torch.Tensor:
    """The forward's 8x8 query tiles of an image ``wq`` queries wide
    holding ``n`` (query ``y * wq + x``): ``[tiles, 64]`` query indices,
    row-major in the tile, -1 outside the image."""
    tx = _ceil(wq, QUERY_TILE)
    t = torch.arange(tx * _ceil(_ceil(max(n, 1), wq), QUERY_TILE))[:, None]
    s = torch.arange(QUERY_TILE * QUERY_TILE)
    qx = (t % tx) * QUERY_TILE + s % QUERY_TILE
    q = ((t // tx) * QUERY_TILE + s // QUERY_TILE) * wq + qx
    return torch.where((qx < wq) & (q < n), q, torch.full_like(q, -1))


def _place(on: torch.Tensor, start: torch.Tensor, end: torch.Tensor):
    """The box along one axis over the windows ``[start, end)`` that are
    ``on`` (``[..., 64]``): their span if at most BOX, else BOX placed on
    their mean centre within the span; ``(start, length)``."""
    big = torch.iinfo(torch.int64).max
    lo = torch.where(on, start, big).amin(-1)
    hi = torch.where(on, end, -big).amax(-1)
    cnt = on.sum(-1)
    centre = torch.where(on, start + end, 0).sum(-1) // (2 * cnt).clamp(min=1)
    wide = hi - lo > BOX
    box0 = torch.minimum(torch.maximum(centre - BOX // 2, lo), hi - BOX)
    b0 = torch.where(cnt == 0, 0, torch.where(wide, box0, lo))
    n = torch.where(cnt == 0, 0, torch.where(wide, BOX, hi - lo))
    return b0, n


def tile_plan(coords: torch.Tensor, h2: int, w2: int, num_levels: int = 4,
              radius: int = 4) -> List[dict]:
    """The tensor-core forward's plan, as the kernel makes it: per level,
    for every (batch entry, query tile) the box of columns ``[x0, x0 +
    bw)`` and rows ``[y0, y0 + hb)`` (``[B, tiles]``), and per query of
    the tile (``[B, tiles, 64]``) whether its window has a tap in the level
    (``live``) and whether it takes the tile path (``fast``: the window
    clipped to the level lies inside the box) or the per-query path
    (``live`` and not ``fast``). ``None`` for a level pooled away."""
    b, n, _ = coords.shape
    q = query_tiles(n, query_width(n, h2, w2)).to(coords.device)
    ok = q >= 0
    cq = coords.float()[:, q.clamp(min=0)]                 # [B, T, 64, 2]
    k1 = 2 * radius + 2
    plans = []
    for li, (hl, wl, _hp, _off) in enumerate(cat_meta(h2, w2, num_levels)):
        if hl == 0 or wl == 0:
            plans.append(None)
            continue
        ix0, iy0 = window_origins(cq, li, hl, wl, radius)
        xs, xe = ix0.clamp(min=0), (ix0 + k1).clamp(max=wl)
        ys, ye = iy0.clamp(min=0), (iy0 + k1).clamp(max=hl)
        live = ok & (xs < xe) & (ys < ye)
        y0, hb = _place(live, ys, ye)
        fit_y = live & (ys >= y0[..., None]) & (ye <= (y0 + hb)[..., None])
        x0, bw = _place(fit_y, xs, xe)
        fast = fit_y & (xs >= x0[..., None]) & (xe <= (x0 + bw)[..., None])
        plans.append(dict(x0=x0, bw=bw, y0=y0, hb=hb, live=live, fast=fast,
                          slow=live & ~fast))
    return plans


def live_levels(meta) -> int:
    """The non-empty levels of :func:`cat_meta`'s table: a prefix, since a
    level pooled to nothing leaves nothing to pool."""
    return sum(1 for (hl, wl, _hp, _off) in meta if hl > 0 and wl > 0)


def route(dtype, c: int, radius: int = 4, levels: int = 1) -> str:
    """Which route of the kernels takes these operands (``levels``: the
    non-empty levels). "tensor_cores": bf16 at C = 128 or 256, radius <= 4
    (the routes' tap tables hold (2r+2)^2 <= 100) and at least one
    non-empty level (their TMA maps need rows; every map's non-empty
    levels fit the level table); the backward splits ``d_corr`` into bf16
    hi + lo. "cuda_cores": everything else, in f32: any C, radius and
    level count."""
    return "tensor_cores" if (dtype == torch.bfloat16 and c in (128, 256)
                              and radius <= 4 and levels >= 1) \
        else "cuda_cores"


def level_tiles(meta) -> List[Tuple[int, int]]:
    """The backward kernels' row tiles: the packed rows cut level by level
    into tiles of ``KERNEL_TILE`` (a level's last tile may be short), as
    ``(first row, rows)``."""
    tiles = []
    for (hl, wl, hp, off) in meta:
        if hl > 0 and wl > 0:
            n = wl * hp
            tiles += [(off + t, min(KERNEL_TILE, n - t))
                      for t in range(0, n, KERNEL_TILE)]
    return tiles


def _split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (bf16 hi, bf16 rounding of what is left), both as f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def fused_corr_lookup_cat_bwd_plain(g: torch.Tensor, f1: torch.Tensor,
                                    f2cat: torch.Tensor, coords: torch.Tensor,
                                    h2: int, w2: int, num_levels: int = 4,
                                    radius: int = 4,
                                    d_corr_rounding: str = "route"
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: the cotangent ``g``
    ``[B, N, L*(2r+1)^2]`` of the lookup -> ``(df1 in f1's dtype, df2cat in
    f2cat's dtype)``. ``g`` goes back through the x-stage, then the
    y-stage, to the ``(2r+2)^2`` integer taps; the in-range taps, times
    ``s = 1/sqrt(C)``, are scattered into a dense ``d_corr [B, N, R]``
    (each tap of a query and level lands on its own row); then ``df1 =
    d_corr @ f2cat`` and ``df2cat = d_corr^T @ f1``, in f32. The padded
    rows of each level get exactly 0.

    ``d_corr_rounding``: "route" (default) repeats the arithmetic of the
    kernel's route for these operands (:func:`route`); "none" keeps
    ``d_corr`` in f32 (one matmul each, the CUDA-core route's numbers);
    "hi_lo" splits it into bf16 hi + lo and sums both products in f32 tile
    by tile in the kernel's order (df1 over :func:`level_tiles`, df2cat
    over query tiles of ``KERNEL_TILE``), the tensor-core route's numbers;
    "bf16" rounds it to bf16 once (not a route: the rounding that the
    split exists to avoid)."""
    b, n, c = f1.shape
    k = 2 * radius + 1
    k1 = k + 1
    s = 1.0 / (c ** 0.5)
    meta = cat_meta(h2, w2, num_levels)
    if d_corr_rounding == "route":
        d_corr_rounding = "hi_lo" if route(
            f1.dtype, c, radius, live_levels(meta)) == "tensor_cores" \
            else "none"
    if d_corr_rounding not in ("none", "hi_lo", "bf16"):
        raise ValueError(f"d_corr_rounding={d_corr_rounding!r}")
    gf = g.float().reshape(b, n, num_levels, k, k)           # (kx, ky)
    d = torch.arange(k1, dtype=torch.float32, device=f1.device) - radius
    d_corr = torch.zeros(b, n, f2cat.shape[1], device=f1.device)
    for li, (hl, wl, hp, off) in enumerate(meta):
        if hl == 0 or wl == 0:
            continue
        cl = coords.float() * (1.0 / 2.0 ** li)
        x0 = torch.floor(cl[..., 0])
        y0 = torch.floor(cl[..., 1])
        fx = (cl[..., 0] - x0)[..., None, None]
        fy = (cl[..., 1] - y0)[..., None, None]
        gl = gf[:, :, li]                                    # [B, N, K, K]
        d_ty = gl.new_zeros(b, n, k1, k)                     # x-stage
        d_ty[..., :k, :] += (1.0 - fx) * gl
        d_ty[..., 1:, :] += fx * gl
        dots = gl.new_zeros(b, n, k1, k1)                    # y-stage
        dots[..., :, :k] += (1.0 - fy) * d_ty
        dots[..., :, 1:] += fy * d_ty
        xs = x0[..., None] + d
        ys = y0[..., None] + d
        inb = (((xs >= 0) & (xs < wl))[..., :, None]
               & ((ys >= 0) & (ys < hl))[..., None, :])
        dots = torch.where(inb, dots * s, torch.zeros((), device=f1.device))
        xi = xs.clamp(0, wl - 1).long()
        yi = ys.clamp(0, hl - 1).long()
        idx = off + xi[..., :, None] * hp + yi[..., None, :]
        d_corr.scatter_add_(2, idx.reshape(b, n, -1), dots.reshape(b, n, -1))
    f1f, f2f = f1.float(), f2cat.float()
    if d_corr_rounding == "hi_lo":
        hi, lo = _split(d_corr)
        df1 = torch.zeros(b, n, c, device=f1.device)
        for r0, rows in level_tiles(meta):
            t = slice(r0, r0 + rows)
            df1 = df1 + torch.matmul(hi[:, :, t], f2f[:, t])
            df1 = df1 + torch.matmul(lo[:, :, t], f2f[:, t])
        df2 = torch.zeros(b, f2cat.shape[1], c, device=f1.device)
        for q0 in range(0, n, KERNEL_TILE):
            t = slice(q0, q0 + KERNEL_TILE)
            df2 = df2 + torch.matmul(hi[:, t].transpose(1, 2), f1f[:, t])
            df2 = df2 + torch.matmul(lo[:, t].transpose(1, 2), f1f[:, t])
    else:
        if d_corr_rounding == "bf16":
            d_corr = d_corr.to(torch.bfloat16).float()
        df1 = torch.matmul(d_corr, f2f)
        df2 = torch.matmul(d_corr.transpose(1, 2), f1f)
    return df1.to(f1.dtype), df2.to(f2cat.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = _build.load("fused_corr")
    fwd, bwd = lib.ofd_fused_corr_fwd, lib.ofd_fused_corr_bwd
    # B, N, C, R, the non-empty levels, the output's levels; the level
    # table; radius, scale, is_bf16, tensor_cores
    tail = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                 ctypes.c_float, ctypes.c_int, ctypes.c_int]
    # the forward also takes the query image's width and the per-query
    # path's counter
    fwd.argtypes = [ctypes.c_void_p] * 4 + tail + [ctypes.c_int,
                                                   ctypes.c_void_p,
                                                   ctypes.c_void_p]
    # the backward also takes its f32 scratch of long sweeps
    bwd.argtypes = [ctypes.c_void_p] * 10 + tail + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels' vector
    and TMA loads), copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_devices(*tensors):
    if any(t.device.type != "cuda" or t.device != tensors[0].device
           for t in tensors):
        raise ValueError("fused_corr_lookup_cat: f1, f2cat and coords must "
                         "all lie on the CPU or all on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")


def _check_cuda(f1, f2cat, coords, meta, radius):
    """Raise on what no kernel takes; else the contiguous f32 coordinates,
    the flat table of the non-empty levels, their count and the route.
    JAX's only limit is VMEM; the kernels' are their index types: a row
    table entry packs a level's column and row as (x << 16 | y), the
    backward's grid takes the batch on its second axis, rows and queries
    are int."""
    _check_devices(f1, f2cat, coords)
    if f1.dtype not in (torch.float32, torch.bfloat16) \
            or f2cat.dtype != f1.dtype:
        raise ValueError(f"fused_corr_lookup_cat: f1/f2cat must share dtype "
                         f"float32 or bfloat16, got {f1.dtype}/{f2cat.dtype}")
    b, n, c = f1.shape
    live = live_levels(meta)
    if c < 1 or radius < 0:
        raise ValueError(f"fused_corr_lookup_cat: C >= 1 and radius >= 0, "
                         f"got C={c}, radius={radius}")
    if b > 65535 or b * max(n, f2cat.shape[1]) >= 2 ** 31 or any(
            wl >= 2 ** 15 or hp >= 2 ** 16 for (_, wl, hp, _) in meta[:live]):
        raise ValueError(f"fused_corr kernel index types: B <= 65535, B * "
                         f"max(N, R) < 2^31, each level < 2^15 columns and "
                         f"< 2^16 padded rows; got B={b}, N={n}, R="
                         f"{f2cat.shape[1]}, levels {meta[:live]}")
    flat = [v for lvl in meta[:live] for v in lvl]
    return (coords.float().contiguous(),
            (ctypes.c_int * max(1, len(flat)))(*flat), live,
            route(f1.dtype, c, radius, live))


def _launch_tail(f1, f2cat, meta, flat, live, radius, rt):
    b, n, c = f1.shape
    return (b, n, c, f2cat.shape[1], live, len(meta), flat, radius,
            1.0 / (c ** 0.5), int(f1.dtype == torch.bfloat16),
            int(rt == "tensor_cores"))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _lookup_cuda(f1, f2cat, coords, h2, w2, num_levels, radius,
                 n_slow=None):
    meta = cat_meta(h2, w2, num_levels)
    cc, flat, live, rt = _check_cuda(f1, f2cat, coords, meta, radius)
    f1, f2cat = _aligned(f1), _aligned(f2cat)
    b, n, _ = f1.shape
    k = 2 * radius + 1
    out = torch.empty(b, n, len(meta) * k * k, dtype=f1.dtype,
                      device=f1.device)
    err = _kernel_fns()[0](f1.data_ptr(), f2cat.data_ptr(), cc.data_ptr(),
                           out.data_ptr(),
                           *_launch_tail(f1, f2cat, meta, flat, live, radius,
                                         rt),
                           query_width(n, h2, w2),
                           0 if n_slow is None else n_slow.data_ptr(),
                           _stream(f1))
    if err:
        raise RuntimeError(f"fused_corr kernel launch failed: CUDA error {err}")
    fused_corr_lookup_cat.launches += 1
    return out


def _lookup_bwd_cuda(g, f1, f2cat, coords, meta, radius):
    cc, flat, live, rt = _check_cuda(f1, f2cat, coords, meta, radius)
    f1, f2cat = _aligned(f1), _aligned(f2cat)
    b, n, _ = f1.shape
    k = 2 * radius + 1
    if g.shape != (b, n, len(meta) * k * k) or g.device != f1.device:
        raise ValueError(f"fused_corr_lookup_cat_bwd: g {tuple(g.shape)} on "
                         f"{g.device}, want {(b, n, len(meta) * k * k)} on "
                         f"{f1.device}")
    gc = g.to(f1.dtype).contiguous()
    df1, df2 = torch.empty_like(f1), torch.empty_like(f2cat)
    # the kernels' scratch: per (query, non-empty level) the window origin
    # and the tap gradients (queries padded to 128), the row table, and
    # the f32 partial sums of long df2cat sweeps
    npad = _ceil(max(n, 1), 128) * 128
    dev = f1.device
    dtap = torch.empty(b, live, npad, (k + 1) ** 2, device=dev)
    orig = torch.empty(b, live, npad, 2, dtype=torch.int32, device=dev)
    tab = torch.empty(max(1, len(level_tiles(meta))) * KERNEL_TILE,
                      dtype=torch.int32, device=dev)
    part = torch.empty(f2cat.shape, device=dev) if (
        rt == "tensor_cores" and _ceil(n, KERNEL_TILE) > SWEEP_TILES) else None
    err = _kernel_fns()[1](gc.data_ptr(), f1.data_ptr(), f2cat.data_ptr(),
                           cc.data_ptr(), df1.data_ptr(), df2.data_ptr(),
                           dtap.data_ptr(), orig.data_ptr(), tab.data_ptr(),
                           0 if part is None else part.data_ptr(),
                           *_launch_tail(f1, f2cat, meta, flat, live, radius,
                                         rt),
                           _stream(f1))
    if err:
        raise RuntimeError(f"fused_corr backward kernel launch failed: CUDA "
                           f"error {err}")
    fused_corr_lookup_cat.bwd_launches += 1
    return df1, df2


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


@spanned("ofd.op.corr_lookup_bwd")
def fused_corr_lookup_cat_bwd(g: torch.Tensor, f1: torch.Tensor,
                              f2cat: torch.Tensor, coords: torch.Tensor,
                              h2: int, w2: int, num_levels: int = 4,
                              radius: int = 4
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lookup's backward, ``(df1, df2cat)`` in the features' dtypes.
    CPU tensors take :func:`fused_corr_lookup_cat_bwd_plain`; CUDA tensors
    launch the kernel (``fused_corr_lookup_cat.bwd_launches`` counts
    those launches)."""
    if _on_cpu(g, f1, f2cat, coords):
        return fused_corr_lookup_cat_bwd_plain(g, f1, f2cat, coords, h2, w2,
                                               num_levels, radius)
    return _lookup_bwd_cuda(g, f1, f2cat, coords,
                            cat_meta(h2, w2, num_levels), radius)


@torch.library.custom_op("ofd::fused_corr_lookup", mutates_args=())
def _lookup_op(f1: torch.Tensor, f2cat: torch.Tensor, coords: torch.Tensor,
               h2: int, w2: int, num_levels: int, radius: int
               ) -> torch.Tensor:
    """The lookup as one operator: the plain version on CPU tensors, the
    kernel on CUDA tensors."""
    if _on_cpu(f1, f2cat, coords):
        return fused_corr_lookup_cat_plain(f1, f2cat, coords, h2, w2,
                                           num_levels, radius)
    return _lookup_cuda(f1, f2cat, coords, h2, w2, num_levels, radius)


def _lookup_setup(ctx, inputs, output):
    f1, f2cat, coords, h2, w2, num_levels, radius = inputs
    ctx.save_for_backward(f1, f2cat, coords)
    ctx.shape_args = (h2, w2, num_levels, radius)


def _lookup_vjp(ctx, g):
    """The backward; coordinates get no gradient."""
    f1, f2cat, coords = ctx.saved_tensors
    df1, df2 = fused_corr_lookup_cat_bwd(g, f1, f2cat, coords,
                                         *ctx.shape_args)
    return df1, df2, None, None, None, None, None


@_lookup_op.register_fake
def _lookup_shape(f1, f2cat, coords, h2, w2, num_levels, radius):
    """The output's shape and dtype, not computed; tensors on neither the
    CPU nor one CUDA device (meta tensors) raise, as the wrapper does."""
    _check_devices(f1, f2cat, coords)
    k = 2 * radius + 1
    return f1.new_empty(f1.shape[0], f1.shape[1], num_levels * k * k)


_lookup_op.register_autograd(_lookup_vjp, setup_context=_lookup_setup)


@spanned("ofd.op.corr_lookup")
def fused_corr_lookup_cat(f1: torch.Tensor, f2cat: torch.Tensor,
                          coords: torch.Tensor, h2: int, w2: int,
                          num_levels: int = 4,
                          radius: int = 4) -> torch.Tensor:
    """Window lookups from the packed pyramid: f1 ``[B, N, C]`` (compute
    dtype), f2cat ``[B, R, C]`` (:func:`corr_levels_cat` of a
    ``[B, h2, w2, C]`` map), coords ``[B, N, 2]`` level-0 centres ->
    ``[B, N, num_levels*(2r+1)^2]`` in f1's dtype. Differentiable in f1
    and f2cat.

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    (``fused_corr_lookup_cat.launches`` and ``.bwd_launches`` count those
    launches)."""
    meta = cat_meta(h2, w2, num_levels)
    b, n, c = f1.shape
    rows = sum(wl * hp for (_, wl, hp, _) in meta)
    if f2cat.shape != (b, rows, c) or coords.shape != (b, n, 2):
        raise ValueError(f"fused_corr_lookup_cat: shapes f1 {tuple(f1.shape)}"
                         f", f2cat {tuple(f2cat.shape)} (want {(b, rows, c)})"
                         f", coords {tuple(coords.shape)}")
    return _lookup_op(f1, f2cat, coords, h2, w2, num_levels, radius)


fused_corr_lookup_cat.launches = 0
fused_corr_lookup_cat.bwd_launches = 0


@spanned("ofd.op.corr_lookup")
def fused_corr_lookup_cat_slow_count(f1: torch.Tensor, f2cat: torch.Tensor,
                                     coords: torch.Tensor, h2: int, w2: int,
                                     num_levels: int = 4, radius: int = 4
                                     ) -> Tuple[torch.Tensor, int]:
    """One forward launch on CUDA tensors (counted in ``.launches``), and
    the number of (query, level) pairs that took the tensor-core route's
    per-query path (0 on the CUDA-core route)."""
    count = torch.zeros(1, dtype=torch.int32, device=f1.device)
    out = _lookup_cuda(f1, f2cat, coords, h2, w2, num_levels, radius, count)
    return out, int(count.item())


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
