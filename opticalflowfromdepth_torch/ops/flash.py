"""Flash (streaming-softmax) attention forward (port of
``opticalflowfromdepth_tpu/ops/flash.py``).

``flash_softmax_matmul(q, k, v)`` computes ``softmax(q @ k^T * scale) @
v`` for GMFlow's window attention, global matching and global flow
propagation, optionally with the Swin shifted-window mask generated from
token indices (``swin=(num_splits, wh, ww, sh, sw)``, batch ordered [b,
wy, wx]) and the per-row log-sum-exp. CUDA tensors launch the hand-written
kernels in ``csrc/flash.cu`` on the route :func:`plan` names; CPU tensors
take the plain version below. Nothing falls back: a CUDA input no route
takes raises.

The operand dtype is q's: bf16 (the serving path, as the TPU kernel, which
casts every operand to bf16; v is cast here, so an f32 flow payload is
rounded exactly as the TPU kernel rounds it) or f32 (f32 models keep f32
operands, as the JAX dense path on the CPU does; every sequence-parallel
ring step is f32). The output is f32. The routes: bf16 at GMFlow's widths
(C padded to 128, D = 128 or 2) and at GMFlow at 256 channels' (C padded
to 256, D = 256 or 2) ``wgmma`` (:func:`wgmma_widths`, the backward's
predicate too), other bf16 ``mma_sync``; f32 at GMFlow's widths
``tf32x3``, whose products run on the tensor cores in split TF32 (three
TF32 products for each f32 one, within f32's tolerance:
:func:`flash_softmax_matmul_tf32` repeats their rounding) and whose key
sweep is split where its blocks would fill less than one wave of the
card (the runs' partials merged in a fixed order by a second launch);
other f32 widths ``f32``, on the CUDA cores.

An optional dense additive ``bias`` ``[B, Lq, Lk]`` (read as f32) joins the
scores inside every route, in the TPU kernel's order: ``s * scale +
bias``, then the Swin mask, then the key padding. A row whose every key
the bias masks (-1e30) gives the mean of v over the real keys and the LSE
``-1e30 + log(Lk)``, as JAX's dense oracle does (the TPU kernel, whose
padded keys enter the denominator, gives ``sum(v) / Lk_padded`` where Lk
is not a multiple of its key block).

Widths: the kernels' tiles take C % 16 == 0 and D == 2 or D % 16 == 0, at
any width up to :data:`MAX_WIDTH` (65,535 chunks of 128 columns on a grid
axis); :func:`pad_widths` appends zero columns to q and k (the dot
products do not change; ``scale`` stays ``1/sqrt(C)`` of the unpadded C)
and to v, and the result is sliced back. Every width but the wgmma and
tf32x3 routes' (every width past 256 among them) takes the mma.sync route
(bf16) or the CUDA-core route (f32): S summed over C in panels of 128
columns, D in chunks of 128 columns on a grid axis, each block within 227
KB of shared memory at any width (the C side's layout; :func:`kernel_plan`
reports it). Past :data:`MAX_WIDTH` a CUDA call raises.

A call whose inputs require grad goes through an autograd Function, as
the JAX package's ``custom_vjp``: its forward also emits the LSE and saves
q, k, v, the f32 output and the LSE; its backward is
``ops.flash_bwd.flash_backward`` (the two backward kernels on the card,
their plain version on the CPU). With a bias the backward is JAX's dense
recompute (``_flash_vjp_bwd``) in plain PyTorch on both devices
(``ops.flash_bwd.flash_backward_with_bias``), and the bias's gradient is
zeros. One known difference: JAX's dense backward rounds q, k and ds to
bf16 even for f32 operands; the port keeps f32 operands in f32 there, as
everywhere.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import _build

KERNEL_BLOCK_K = 64          # keys per tile of csrc/flash.cu's bf16 routes
LOG2E = 1.4426950408889634
CHUNK = 128       # output columns a block of the mma.sync and CUDA-core
                  # routes takes (a grid axis)
MAX_WIDTH = 65535 * CHUNK    # the widest C and D: the grid's z axis holds
                             # at most 65,535 chunks

Swin = Tuple[int, int, int, int, int]


def swin_mask_dense(l: int, swin: Swin, batch: int,
                    device="cpu") -> torch.Tensor:
    """Dense ``[batch, L, L]`` f32 equivalent of the kernel's analytic Swin
    mask (0, or -100 across regions); batch ordered [b, wy, wx]."""
    num_splits, wh, ww, sh, sw = swin
    kk = num_splits * num_splits
    tok = torch.arange(l, device=device)
    r, c = tok // ww, tok % ww
    win = torch.arange(kk, device=device)
    yreg = ((win // num_splits)[:, None] == num_splits - 1) & (r >= wh - sh)
    xreg = ((win % num_splits)[:, None] == num_splits - 1) & (c >= ww - sw)
    same = ((yreg[:, :, None] == yreg[:, None, :])
            & (xreg[:, :, None] == xreg[:, None, :]))
    mask = torch.where(same, 0.0, -100.0).to(torch.float32)
    return mask.repeat(batch // kk, 1, 1)


def flash_softmax_matmul_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, scale: Optional[float] = None,
                               swin: Optional[Swin] = None,
                               with_lse: bool = False,
                               block_k: Optional[int] = KERNEL_BLOCK_K,
                               exp2: bool = False,
                               bias: Optional[torch.Tensor] = None
                               ) -> Union[torch.Tensor,
                                          Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version with the kernel's arithmetic: scores
    ``(q . k) * scale`` in f32 from the operands (k and v cast to q's
    dtype), the bias (f32) added, then the Swin mask, then the online
    softmax over key blocks of ``block_k`` (running max from -inf, taken
    as 0 while a row has no finite score; rescaled denominator and
    accumulator). In bf16 the unnormalized P of each block
    is rounded to bf16 before P . v, as the TPU and the CUDA kernel round
    it (relative to the running max of the blocks swept so far, so
    ``block_k`` chooses which kernel's rounding is repeated; None: one
    block). In f32 nothing is rounded and the blocks do not matter.
    ``exp2=True`` repeats the base-2 form of the kernel's wgmma and tf32x3
    routes: the scores times ``f32(scale * log2(e))``, plus the bias
    times ``f32(log2(e))`` (each product rounded to f32, then the sum),
    the Swin mask's -100 times ``log2(e)``, the running max in base 2 and
    ``p = 2^(x - m)``; the LSE is then ``m ln 2 + log(den)``. A row the
    bias masks whole (-1e30 on every key) gives the mean of v and the LSE
    ``-1e30 + log(Lk)``. Returns out ``[B, Lq, D]`` f32 (and the LSE
    ``[B, Lq]`` f32)."""
    b, lq, c = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(c)
    bf16 = q.dtype == torch.bfloat16
    base = LOG2E if exp2 else 1.0
    s = torch.matmul(q.float(), k.to(q.dtype).float().transpose(1, 2)) \
        * float(np.float32(scale) * np.float32(base))
    if bias is not None:
        s = s + (bias.float() * float(np.float32(base)) if exp2
                 else bias.float())
    if swin is not None:
        s = s + swin_mask_dense(lk, swin, b, q.device) * base
    exp = torch.exp2 if exp2 else torch.exp
    vf = v.to(q.dtype).float()
    step = lk if block_k is None or not bf16 else block_k
    m = torch.full((b, lq, 1), -math.inf, device=q.device)
    den = torch.zeros(b, lq, 1, device=q.device)
    acc = torch.zeros(b, lq, v.shape[2], device=q.device)
    for k0 in range(0, lk, step):
        sb = s[:, :, k0:k0 + step]
        m_new = torch.maximum(m, sb.amax(-1, keepdim=True))
        ms = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = exp(m - ms)
        p = exp(sb - ms)
        den = den * alpha + p.sum(-1, keepdim=True)
        if bf16:
            p = p.to(torch.bfloat16).float()
        acc = acc * alpha + torch.matmul(p, vf[:, k0:k0 + step])
        m = m_new
    den = torch.clamp(den, min=1e-30)
    out = acc / den
    if with_lse:
        return out, (m * (math.log(2.0) if exp2 else 1.0)
                     + torch.log(den))[..., 0]
    return out


def bf16_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None,
                   swin: Optional[Swin] = None,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[B, Lq, 1]``: how far, row by row, the kernel's bf16 output may lie
    from :func:`flash_softmax_matmul_plain`'s. Both round the same
    unnormalized P to bf16 at the same key blocks, but a P whose f32 value
    differs in its last bits (scores summed in another order, another
    ``exp``) can round to the neighbouring bf16 value. That moves the row
    by at most a bf16 step, 2^-7 of the term ``pi_i |v_i|`` (``pi`` the
    softmax probability of ``s * scale + bias`` with the Swin mask,
    ``|v_i|`` the largest of key i's payload). Allowed: two such steps of
    the row's largest term, 2^-16 of ``sum_i pi_i |v_i|`` for the f32
    sums, and 1e-6."""
    b, _, c = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(c)
    s = torch.matmul(q.float(), k.to(q.dtype).float().transpose(1, 2)) * scale
    if bias is not None:
        s = s + bias.float()
    if swin is not None:
        s = s + swin_mask_dense(k.shape[1], swin, b, q.device)
    w = torch.softmax(s, -1) * v.to(q.dtype).float().abs().amax(-1)[:, None]
    return (2 ** -6 * w.amax(-1, keepdim=True)
            + 2 ** -16 * w.sum(-1, keepdim=True) + 1e-6)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` -> (hi, lo) as the tf32x3 route splits an operand: hi is
    x rounded to TF32 (to nearest, ties away from zero: 0x1000 added to
    its bits, the low 13 cleared), lo = x - hi (exact in f32) as the
    tensor cores read it (its low 13 bits dropped). hi + lo is x to within
    2^-21 of |x|."""
    x = x.float().contiguous()
    hi = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def matmul_tf32(a: torch.Tensor, b: torch.Tensor,
                terms: int = 3) -> torch.Tensor:
    """``a @ b`` from split-TF32 pieces, in f32: ``a_hi b_hi + a_hi b_lo +
    a_lo b_hi`` (``terms=3``, the tf32x3 route's products) or ``a_hi b_hi``
    alone (``terms=1``, plain TF32). Each piece's products are exact in
    f32; only the order of the sums differs from the kernels'."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    out = torch.matmul(ah, bh)
    if terms == 3:
        out = out + (torch.matmul(al, bh) + torch.matmul(ah, bl))
    return out


def flash_softmax_matmul_tf32(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: Optional[float] = None,
                              swin: Optional[Swin] = None,
                              with_lse: bool = False, terms: int = 3,
                              bias: Optional[torch.Tensor] = None
                              ) -> Union[torch.Tensor,
                                         Tuple[torch.Tensor, torch.Tensor]]:
    """The tf32x3 route's arithmetic in plain PyTorch (f32 operands, C =
    128, D = 128 or 2): S = q k^T through :func:`matmul_tf32` (``terms``
    pieces), then the base-2 softmax of the wgmma route (the scores times
    ``scale * log2(e)``, the bias times ``log2(e)``, the Swin mask's -100
    times ``log2(e)``, ``p = 2^(x - m)``) and ``P V`` through
    :func:`matmul_tf32` at D = 128, in plain f32 at D = 2 (the kernel
    takes it on the CUDA cores); the LSE is ``m ln 2 + log(den)``.
    ``terms=1`` shows what plain TF32 products would lose. For tests and
    readings only: no path calls it."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    b = q.shape[0]
    s = matmul_tf32(q.float(), k.float().transpose(1, 2), terms) \
        * float(np.float32(scale) * np.float32(LOG2E))
    if bias is not None:
        s = s + bias.float() * float(np.float32(LOG2E))
    if swin is not None:
        s = s + swin_mask_dense(k.shape[1], swin, b, q.device) * LOG2E
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    den = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    vf = v.float()
    acc = torch.matmul(p, vf) if v.shape[2] == 2 else matmul_tf32(p, vf,
                                                                  terms)
    out = acc / den
    if with_lse:
        return out, (m * math.log(2.0) + torch.log(den))[..., 0]
    return out


# The routes and their codes in the C entry points (csrc/flash_common.cuh,
# enum Route), the forward's and the backward's.
ROUTES = {"f32": 0, "tf32x3": 1, "mma_sync": 2, "wgmma": 3}
H100_SMS = 132
SMEM_SM = 233472        # shared memory of an SM that blocks may take
SMEM_RESERVED = 1024    # the system's share of it for each block
MAX_SPLITS = 16         # runs of a split sweep at most (its scratch)
RUN_OVERHEAD = 2        # a block's fixed work (its resident rows, its
                        # partial sums out and back in), in tiles
TF32_STRIDE = 132       # floats a shared row of the tf32x3 routes


def padded_widths(c: int, d: int) -> Tuple[int, int]:
    """The widths the kernels' tiles take for C = c and D = d: C to the
    next multiple of 16, D to 2 or the next multiple of 16. Below 1, or
    padded past :data:`MAX_WIDTH` (the grid axis of 128-column chunks),
    raises ``ValueError``."""
    cp, dp = -(-c // 16) * 16, (2 if d <= 2 else -(-d // 16) * 16)
    if not (c >= 1 and d >= 1 and cp <= MAX_WIDTH and dp <= MAX_WIDTH):
        raise ValueError(f"the flash kernels take C and D from 1 to "
                         f"{MAX_WIDTH} (65535 chunks of {CHUNK} columns on "
                         f"the grid's z axis), got C={c}, D={d}")
    return cp, dp


def _pad_last(x: torch.Tensor, width: int) -> torch.Tensor:
    if x.shape[-1] == width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def pad_widths(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k and v with zero columns appended to :func:`padded_widths`
    (the same tensors where nothing is appended): q . k and P . v keep
    their values in the real columns."""
    cp, dp = padded_widths(q.shape[2], v.shape[2])
    return _pad_last(q, cp), _pad_last(k, cp), _pad_last(v, dp)


def gmflow_widths(b: int, lq: int, lk: int, c: int, d: int) -> bool:
    """GMFlow's widths, which the tf32x3 routes take: C padded to 128, D =
    128 or 2, the rows of every batch entry within int32."""
    cp, dp = padded_widths(c, d)
    return cp == 128 and dp in (2, 128) and b * max(lq, lk) < 2 ** 31


def wgmma_widths(b: int, lq: int, lk: int, c: int, d: int) -> bool:
    """The widths the bf16 wgmma routes take, forward and backward: C
    padded to 128 with D = 128 or 2 (GMFlow's), or C padded to 256 with D
    = 256 or 2 (GMFlow at 256 channels), the rows of every batch entry
    within int32 (``sm90::takes`` in ``csrc/flash.cu`` and
    ``csrc/flash_bwd.cu``)."""
    cp, dp = padded_widths(c, d)
    return (cp, dp) in ((128, 2), (128, 128), (256, 2), (256, 256)) \
        and b * max(lq, lk) < 2 ** 31


def split_count(blocks: int, tiles: int, slots: int) -> int:
    """How many runs to cut a sweep of ``tiles`` tiles into, for ``blocks``
    blocks (batch entries x row blocks) on a card that holds ``slots`` at
    once: 1 if the blocks fill the slots; else the count whose waves
    times a block's work (its run's tiles and RUN_OVERHEAD) is least (the
    fewest runs among equals), at most MAX_SPLITS, each run whole tiles
    and none empty."""
    if blocks >= slots:
        return 1
    best, cost = 1, -(-blocks // slots) * (tiles + RUN_OVERHEAD)
    for s in range(2, min(MAX_SPLITS, tiles) + 1):
        per = -(-tiles // s)
        if -(-tiles // per) != s:
            continue                       # that many runs leave one empty
        c = -(-blocks * s // slots) * (per + RUN_OVERHEAD)
        if c < cost:
            best, cost = s, c
    return best


class FwdPlan(NamedTuple):
    """How the forward runs one call: the ``route``; for the tf32x3 route
    the query rows a block (``rows``), keys a ring tile (``tile``), the
    shared memory a block (``smem``, bytes) and blocks an SM, the runs the
    key sweep is cut into (``splits``; the grid is (row blocks, splits,
    B)), and where it is split the f32 scratch shapes of the runs'
    partials (``scratch_out`` ``[splits, B, Lq, D]``, the unnormalised
    outputs; ``scratch_ml`` ``[splits, B, Lq, 2]``, each row's running max
    in base 2 and denominator; None where not); for the wgmma route its
    query rows a block, keys a tile and shared memory (``sm90::choose``'s,
    mirrored by :func:`wgmma_warpgroups` and :func:`wgmma_smem`; blocks an
    SM, which ptxas's registers also bound, stay 0); the padded widths
    (``c_pad``, ``d_pad``). The other routes' blocks are the C side's to
    choose: :func:`kernel_plan` reports them, every route's."""
    route: str
    rows: int = 0
    tile: int = 0
    smem: int = 0
    blocks_per_sm: int = 0
    splits: int = 1
    scratch_out: Optional[Tuple[int, ...]] = None
    scratch_ml: Optional[Tuple[int, ...]] = None
    c_pad: int = 0
    d_pad: int = 0


def tf32_blocks(d: int) -> Tuple[int, int, int]:
    """The forward's tf32x3 block at D = d (``tf32x3::FwdCfg``): (query
    rows, keys a tile, blocks an SM by its launch bounds). D = 2: 4 warps,
    64-key tiles, two blocks an SM; D = 128: 8 warps (a tile's V shared
    by more rows), 32-key tiles, one."""
    return (64, 64, 2) if d == 2 else (128, 32, 1)


def tf32_smem(d: int) -> int:
    """Shared memory of a forward tf32x3 block (``FwdCfg::SMEM``): Q's
    resident rows and two ring stages (the K tile, and V's tile or its
    pairs), rows of TF32_STRIDE floats."""
    rows, tile, _ = tf32_blocks(d)
    stage = tile * TF32_STRIDE + (2 * tile if d == 2 else tile * TF32_STRIDE)
    return 4 * (rows * TF32_STRIDE + 2 * stage)


WGMMA_PANEL_BYTES = 64 * 64 * 2   # a [64 rows][64] bf16 panel


def wgmma_smem(c: int, d: int, warpgroups: int) -> int:
    """Shared memory of a forward wgmma block (``sm90::fwd_smem_bytes``) at
    padded widths C = c (128 or 256) and D = d (c or 2): each warpgroup's
    64 queries resident in c / 64 panels, two ring stages of K's c / 64
    panels and of V's (D = c) or its 64 bf16 pairs (D = 2), then the five
    mbarriers, the struct rounded up to its 1 KB alignment, and 1 KB of
    slack to align the base."""
    cp = c // 64
    v = 2 * (2 * 64 * 2 if d == 2 else cp * WGMMA_PANEL_BYTES)
    return ((warpgroups + 2) * cp * WGMMA_PANEL_BYTES
            + -(-(v + 5 * 8) // 1024) * 1024 + 1024)


def wgmma_warpgroups(b: int, lq: int, c: int, d: int, bias: bool = False,
                     sms: int = H100_SMS) -> int:
    """Warpgroups (64 queries each) of a forward wgmma block
    (``sm90::choose``) at padded widths C = c, D = d: one at D = 2; two
    with a bias or at D = 256 (O's 128 registers a thread); at C = D = 128
    three where such blocks fill every SM at least twice, else two."""
    if d == 2:
        return 1
    if bias or c == 256:
        return 2
    return 3 if b * -(-lq // 192) >= 2 * sms else 2


def plan(b: int, lq: int, lk: int, c: int, d: int,
         dtype: torch.dtype = torch.float32, sms: int = H100_SMS,
         bias: bool = False) -> FwdPlan:
    """The forward's route and its parameters for q ``[b, lq, c]``, k ``[b,
    lk, c]``, v ``[b, lk, d]`` of ``dtype`` (with a dense bias or
    without); pure host arithmetic, on the widths :func:`padded_widths`
    gives (past :data:`MAX_WIDTH` raises). bf16 at :func:`wgmma_widths`
    takes the wgmma route, other bf16 the mma.sync route; f32 at GMFlow's
    widths the tf32x3 route, other f32 the CUDA-core route."""
    cp, dp = padded_widths(c, d)
    if dtype == torch.bfloat16:
        if not wgmma_widths(b, lq, lk, c, d):
            return FwdPlan("mma_sync", c_pad=cp, d_pad=dp)
        wgs = wgmma_warpgroups(b, lq, cp, dp, bias, sms)
        return FwdPlan("wgmma", 64 * wgs, 64, wgmma_smem(cp, dp, wgs),
                       c_pad=cp, d_pad=dp)
    if not gmflow_widths(b, lq, lk, c, d):
        return FwdPlan("f32", c_pad=cp, d_pad=dp)
    rows, tile, per_sm = tf32_blocks(dp)
    smem = tf32_smem(dp)
    per_sm = min(per_sm, SMEM_SM // (smem + SMEM_RESERVED))
    splits = split_count(b * -(-lq // rows), -(-lk // tile), sms * per_sm)
    return FwdPlan("tf32x3", rows, tile, smem, per_sm, splits,
                   (splits, b, lq, dp) if splits > 1 else None,
                   (splits, b, lq, 2) if splits > 1 else None, cp, dp)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The C entry points: the forward and the merge of a split sweep's
    runs."""
    lib = _build.load("flash")
    fn = lib.ofd_flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    merge = lib.ofd_flash_fwd_merge
    merge.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                              ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p]
    merge.restype = ctypes.c_int
    return fn, merge


@functools.lru_cache(maxsize=None)
def _plan_fn():
    fn = _build.load("flash").ofd_flash_fwd_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_plan(b: int, lq: int, lk: int, c: int, d: int,
                bf16: bool, bias: bool = False) -> dict:
    """What the forward kernel launches for these operands (at their
    padded widths, with a bias or without) on the current CUDA device by
    the C side's own rule: its route (a key of ROUTES), query rows a
    block, keys a tile, blocks (every run's and D chunk's), blocks resident
    per SM, waves over the SMs, the runs of its key sweep (tf32x3: the
    split :func:`plan` must name too), D chunks (mma.sync), shared memory
    a block (bytes, static included), threads a block, registers and local
    memory (bytes) a thread. Raises where the card cannot hold a block."""
    cp, dp = padded_widths(c, d)
    out = (ctypes.c_int * 13)()
    err = _plan_fn()(b, lq, lk, cp, dp, int(bf16), int(bias), out)
    if err:
        raise RuntimeError(f"flash kernel plan failed: CUDA error {err}")
    route = {code: name for name, code in ROUTES.items()}[out[0]]
    return dict(route=route, rows=out[1], tile=out[2], blocks=out[3],
                per_sm=out[4], waves=out[5], splits=out[6], chunks=out[7],
                smem=out[8] + out[9], threads=out[10], regs=out[11],
                local=out[12])


def _check_shapes(q, k, v, swin, bias=None):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 \
            or k.shape[0] != q.shape[0] or v.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2] or v.shape[1] != k.shape[1]:
        raise ValueError(f"flash_softmax_matmul: q [B, Lq, C], k [B, Lk, C],"
                         f" v [B, Lk, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if swin is not None:
        num_splits, wh, ww, sh, sw = swin
        if num_splits < 1 or q.shape[0] % (num_splits * num_splits) \
                or q.shape[1] != wh * ww or k.shape[1] != wh * ww \
                or not (0 <= sh < wh and 0 <= sw < ww):
            raise ValueError(f"flash_softmax_matmul: swin={swin} does not fit "
                             f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    # JAX's BlockSpec indexes the bias (ib, iq, ik) and never broadcasts
    if bias is not None and (tuple(bias.shape) != (q.shape[0], q.shape[1],
                                                   k.shape[1])
                             or not bias.dtype.is_floating_point):
        raise ValueError(f"flash_softmax_matmul: bias must be a float [B, Lq, "
                         f"Lk] = {[q.shape[0], q.shape[1], k.shape[1]]}, got "
                         f"{bias.dtype} {list(bias.shape)}")


def check_kernel_operands(q, k, v, tensors, what: str) -> None:
    """What the forward and the backward kernels take: every tensor on
    one CUDA device, q/k both bf16 or both f32, C and D from 1 to
    :data:`MAX_WIDTH` (padded to the kernels' widths by the caller), B <=
    65535, L >= 1; raises otherwise."""
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"{what}: the tensors must all lie on the CPU or "
                         f"all on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype:
        raise ValueError(f"{what} takes q/k both bf16 or both f32, got "
                         f"{q.dtype}/{k.dtype}")
    b, lq, c = q.shape
    lk, d = v.shape[1], v.shape[2]
    padded_widths(c, d)
    if b > 65535 or lq < 1 or lk < 1:
        raise ValueError(f"{what} takes B <= 65535, L >= 1; got B={b}, "
                         f"Lq={lq}, Lk={lk}")


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"flash {what} launch failed: CUDA error {err}")


def kernel_bias(bias: torch.Tensor) -> torch.Tensor:
    """The bias as the kernels read it: f32, contiguous, 16-byte aligned
    (rows of an even Lk are then 8-byte aligned, for their float2 loads)."""
    bias = bias.float().contiguous()
    return bias.clone() if bias.data_ptr() % 16 else bias


def launcher(q, k, v, scale=None, swin=None, with_lse=False,
             route: Optional[str] = None, bias=None):
    """The kernel's launch for one call on CUDA tensors, without the
    count: ``((out, lse), launch, plan)``, the launch filling out (and lse
    with ``with_lse``, else None) on the current stream, a split sweep's
    runs merged into them. q, k and v are padded to the kernels' widths
    (:func:`pad_widths`) and out is the real columns of the padded
    output. ``route`` forces another route of the same dtype unsplit (to
    time it beside the planned one); by default :func:`plan` picks it."""
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    check_kernel_operands(q, k, v, tensors, "flash kernel")
    b, lq, c = q.shape
    lk, d = v.shape[1], v.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(c)
    p = plan(b, lq, lk, c, d, q.dtype, _sms(q.device.index), bias is not None)
    if route is not None:
        p = FwdPlan(route, c_pad=p.c_pad, d_pad=p.d_pad)
    qc, kc, vc = (t.contiguous()
                  for t in pad_widths(q, k, v.to(q.dtype)))
    bc = None if bias is None else kernel_bias(bias)
    if any(t.data_ptr() % 16 for t in (qc, kc, vc)):
        raise ValueError("flash kernel needs 16-byte aligned q, k and v")
    dev = q.device
    cp, dp = p.c_pad, p.d_pad
    out = torch.empty(b, lq, dp, dtype=torch.float32, device=dev)
    lse = torch.empty(b, lq, dtype=torch.float32, device=dev) \
        if with_lse else None
    parts = None if p.splits == 1 else tuple(
        torch.empty(s, dtype=torch.float32, device=dev)
        for s in (p.scratch_out, p.scratch_ml))
    sw = swin if swin is not None else (0, 0, 0, 0, 0)
    dims = (b, lq, lk, cp, dp, float(scale), *sw,
            int(q.dtype == torch.bfloat16), ROUTES[p.route], p.splits)
    fn, merge = _kernel_fns()

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    # the launch holds the operands (any copies live nowhere else) for as
    # long as it may be called
    def launch():
        stream = torch.cuda.current_stream(dev).cuda_stream
        o, l = parts if parts is not None else (out, lse)
        _check(fn(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), ptr(bc),
                  o.data_ptr(), ptr(l), *dims, stream), "kernel")
        if parts is not None:
            _check(merge(o.data_ptr(), l.data_ptr(), out.data_ptr(), ptr(lse),
                         b * lq, dp, p.splits, stream), "merge")

    return (out[..., :d] if dp != d else out, lse), launch, p


def _flash_cuda(q, k, v, scale, swin, with_lse, bias):
    (out, lse), launch, _ = launcher(q, k, v, scale, swin, with_lse,
                                     bias=bias)
    launch()
    flash_softmax_matmul.launches += 1
    return (out, lse) if with_lse else out


def flash_softmax_matmul(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None,
                         bias: Optional[torch.Tensor] = None,
                         swin: Optional[Swin] = None,
                         with_lse: bool = False
                         ) -> Union[torch.Tensor,
                                    Tuple[torch.Tensor, torch.Tensor]]:
    """``softmax(q @ k^T * scale [+ bias] [+ Swin mask]) @ v`` without the
    ``[Lq, Lk]`` scores in device memory: q ``[B, Lq, C]``, k ``[B, Lk,
    C]``, v ``[B, Lk, D]``, an optional additive ``bias`` of exactly ``[B,
    Lq, Lk]`` (any float dtype, read as f32; other shapes raise) -> ``[B,
    Lq, D]`` f32 (and the LSE ``[B, Lq]`` f32 with ``with_lse``).
    ``scale`` defaults to ``1/sqrt(C)``.

    CPU tensors take :func:`flash_softmax_matmul_plain`; CUDA tensors
    launch the kernel on the route :func:`plan` names
    (``flash_softmax_matmul.launches`` counts those calls, a split sweep's
    merge included), which takes bf16 or f32 q/k and any C and D from 1 to
    :data:`MAX_WIDTH` (padded to the kernels' widths; wider raises; past
    256 on the mma.sync and CUDA-core routes). f32 at C = 128 and
    D = 128 or 2 runs its products in split TF32 on the tensor cores
    (within f32's tolerance; :func:`flash_softmax_matmul_tf32`), its key
    sweep split at small batches; bf16 at C = 128 and 256 (with D = C or
    2) runs on wgmma. Differentiable in q, k and v (not in
    ``lse``); the gradients come back in their dtypes; the bias's is
    zeros."""
    _check_shapes(q, k, v, swin, bias)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        out, lse = _FlashFunction.apply(q, k, v, bias, float(scale), swin)
        return (out, lse) if with_lse else out
    return _forward(q, k, v, scale, swin, with_lse, bias)


def _forward(q, k, v, scale, swin, with_lse, bias=None):
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_softmax_matmul_plain(q, k, v, scale, swin, with_lse,
                                          bias=bias)
    return _flash_cuda(q, k, v, scale, swin, with_lse, bias)


class _FlashFunction(torch.autograd.Function):
    """The forward with its LSE; the backward from the saved f32 output and
    LSE, or with a bias JAX's dense recompute
    (`flash.py:_flash_vjp_fwd/_flash_vjp_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, swin):
        out, lse = _forward(q, k, v, scale, swin, True, bias)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale, ctx.swin = scale, swin
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        from .flash_bwd import flash_backward, flash_backward_with_bias
        q, k, v, bias, out, lse = ctx.saved_tensors
        if bias is None:
            dq, dk, dv = flash_backward(q, k, v, out, lse, g, ctx.scale,
                                        ctx.swin)
        else:
            dq, dk, dv = flash_backward_with_bias(q, k, v, bias, g, ctx.scale,
                                                  ctx.swin)
        need = ctx.needs_input_grad
        return (dq.to(q.dtype) if need[0] else None,
                dk.to(k.dtype) if need[1] else None,
                dv.to(v.dtype) if need[2] else None,
                torch.zeros_like(bias) if need[3] else None, None, None)


flash_softmax_matmul.launches = 0
