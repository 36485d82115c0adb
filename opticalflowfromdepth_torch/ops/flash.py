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
(C = 128, D = 128 or 2) ``wgmma``, other bf16 ``mma_sync``; f32 at
GMFlow's widths ``tf32x3``, whose products run on the tensor cores in
split TF32 (three TF32 products for each f32 one, within f32's tolerance:
:func:`flash_softmax_matmul_tf32` repeats their rounding) and whose key
sweep is split where its blocks would fill less than one wave of the
card (the runs' partials merged in a fixed order by a second launch);
other f32 widths ``f32``, on the CUDA cores.

A call whose inputs require grad goes through an autograd Function, as
the JAX package's ``custom_vjp``: its forward also emits the LSE and saves
q, k, v, the f32 output and the LSE; its backward is
``ops.flash_bwd.flash_backward`` (the two backward kernels on the card,
their plain version on the CPU). The TPU kernel's optional dense ``bias``
operand is not ported: no caller passes one.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import _build

NEG_INF = -1e30
KERNEL_BLOCK_K = 64          # keys per tile of csrc/flash.cu's bf16 routes
LOG2E = 1.4426950408889634

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
                               exp2: bool = False
                               ) -> Union[torch.Tensor,
                                          Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version with the kernel's arithmetic: scores
    ``(q . k) * scale`` in f32 from the operands (k and v cast to q's
    dtype), the Swin mask added, then the online softmax over
    key blocks of ``block_k`` (running max from -1e30, rescaled
    denominator and accumulator). In bf16 the unnormalized P of each block
    is rounded to bf16 before P . v, as the TPU and the CUDA kernel round
    it (relative to the running max of the blocks swept so far, so
    ``block_k`` chooses which kernel's rounding is repeated; None: one
    block). In f32 nothing is rounded and the blocks do not matter.
    ``exp2=True`` repeats the base-2 form of the kernel's wgmma route
    (bf16, C = 128): the scores times ``scale * log2(e)`` (rounded to f32),
    the Swin mask's -100 times ``log2(e)``, the running max in base 2 and
    ``p = 2^(x - m)``; the LSE is then ``m ln 2 + log(den)``.
    Returns out ``[B, Lq, D]`` f32 (and the LSE ``[B, Lq]`` f32)."""
    b, lq, c = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(c)
    bf16 = q.dtype == torch.bfloat16
    base = LOG2E if exp2 else 1.0
    s = torch.matmul(q.float(), k.to(q.dtype).float().transpose(1, 2)) \
        * float(np.float32(scale) * np.float32(base))
    if swin is not None:
        s = s + swin_mask_dense(lk, swin, b, q.device) * base
    exp = torch.exp2 if exp2 else torch.exp
    vf = v.to(q.dtype).float()
    step = lk if block_k is None or not bf16 else block_k
    m = torch.full((b, lq, 1), NEG_INF, device=q.device)
    den = torch.zeros(b, lq, 1, device=q.device)
    acc = torch.zeros(b, lq, v.shape[2], device=q.device)
    for k0 in range(0, lk, step):
        sb = s[:, :, k0:k0 + step]
        m_new = torch.maximum(m, sb.amax(-1, keepdim=True))
        alpha = exp(m - m_new)
        p = exp(sb - m_new)
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
                   swin: Optional[Swin] = None) -> torch.Tensor:
    """``[B, Lq, 1]``: how far, row by row, the kernel's bf16 output may lie
    from :func:`flash_softmax_matmul_plain`'s. Both round the same
    unnormalized P to bf16 at the same key blocks, but a P whose f32 value
    differs in its last bits (scores summed in another order, another
    ``exp``) can round to the neighbouring bf16 value. That moves the row
    by at most a bf16 step, 2^-7 of the term ``pi_i |v_i|`` (``pi`` the
    softmax probability, ``|v_i|`` the largest of key i's payload). Allowed:
    two such steps of the row's largest term, 2^-16 of ``sum_i pi_i
    |v_i|`` for the f32 sums, and 1e-6."""
    b, _, c = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(c)
    s = torch.matmul(q.float(), k.to(q.dtype).float().transpose(1, 2)) * scale
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
                              with_lse: bool = False, terms: int = 3
                              ) -> Union[torch.Tensor,
                                         Tuple[torch.Tensor, torch.Tensor]]:
    """The tf32x3 route's arithmetic in plain PyTorch (f32 operands, C =
    128, D = 128 or 2): S = q k^T through :func:`matmul_tf32` (``terms``
    pieces), then the base-2 softmax of the wgmma route (the scores times
    ``scale * log2(e)``, the Swin mask's -100 times ``log2(e)``, ``p =
    2^(x - m)``) and ``P V`` through :func:`matmul_tf32` at D = 128, in
    plain f32 at D = 2 (the kernel takes it on the CUDA cores); the LSE is
    ``m ln 2 + log(den)``. ``terms=1`` shows what plain TF32 products
    would lose. For tests and readings only: no path calls it."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    b = q.shape[0]
    s = matmul_tf32(q.float(), k.float().transpose(1, 2), terms) \
        * float(np.float32(scale) * np.float32(LOG2E))
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


def gmflow_widths(b: int, lq: int, lk: int, c: int, d: int) -> bool:
    """GMFlow's widths, which the wgmma and tf32x3 routes take: C = 128, D
    = 128 or 2, the rows of every batch entry within int32."""
    return c == 128 and d in (2, 128) and b * max(lq, lk) < 2 ** 31


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
    in base 2 and denominator; None where not)."""
    route: str
    rows: int = 0
    tile: int = 0
    smem: int = 0
    blocks_per_sm: int = 0
    splits: int = 1
    scratch_out: Optional[Tuple[int, ...]] = None
    scratch_ml: Optional[Tuple[int, ...]] = None


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


def plan(b: int, lq: int, lk: int, c: int, d: int,
         dtype: torch.dtype = torch.float32, sms: int = H100_SMS) -> FwdPlan:
    """The forward's route and its parameters for q ``[b, lq, c]``, k ``[b,
    lk, c]``, v ``[b, lk, d]`` of ``dtype``; pure host arithmetic. bf16 at
    GMFlow's widths takes the wgmma route, other bf16 the mma.sync route;
    f32 at GMFlow's widths the tf32x3 route, other f32 the CUDA-core
    route."""
    gmflow = gmflow_widths(b, lq, lk, c, d)
    if dtype == torch.bfloat16:
        return FwdPlan("wgmma" if gmflow else "mma_sync")
    if not gmflow:
        return FwdPlan("f32")
    rows, tile, per_sm = tf32_blocks(d)
    smem = tf32_smem(d)
    per_sm = min(per_sm, SMEM_SM // (smem + SMEM_RESERVED))
    splits = split_count(b * -(-lq // rows), -(-lk // tile), sms * per_sm)
    return FwdPlan("tf32x3", rows, tile, smem, per_sm, splits,
                   (splits, b, lq, d) if splits > 1 else None,
                   (splits, b, lq, 2) if splits > 1 else None)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The C entry points: the forward and the merge of a split sweep's
    runs."""
    lib = _build.load("flash")
    fn = lib.ofd_flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
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
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_plan(b: int, lq: int, lk: int, c: int, d: int,
                bf16: bool) -> dict:
    """What the forward kernel launches for these operands on the current
    CUDA device by the C side's own rule: its route (a key of ROUTES),
    query rows a block, keys a tile, blocks (every run's), blocks resident
    per SM, waves over the SMs, and the runs of its key sweep (tf32x3: the
    split :func:`plan` must name too)."""
    out = (ctypes.c_int * 7)()
    err = _plan_fn()(b, lq, lk, c, d, int(bf16), out)
    if err:
        raise RuntimeError(f"flash kernel plan failed: CUDA error {err}")
    route = {code: name for name, code in ROUTES.items()}[out[0]]
    return dict(route=route, rows=out[1], tile=out[2], blocks=out[3],
                per_sm=out[4], waves=out[5], splits=out[6])


def _check_shapes(q, k, v, swin):
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


def check_kernel_operands(q, k, v, tensors, what: str) -> None:
    """What the forward and the backward kernels take: every tensor on
    one CUDA device, q/k both bf16 or both f32, C % 16 == 0 up to 128, D
    == 2 or a multiple of 16 up to 128, B <= 65535, L >= 1; raises
    otherwise."""
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"{what}: the tensors must all lie on the CPU or "
                         f"all on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype:
        raise ValueError(f"{what} takes q/k both bf16 or both f32, got "
                         f"{q.dtype}/{k.dtype}")
    b, lq, c = q.shape
    lk, d = v.shape[1], v.shape[2]
    if c % 16 or not 16 <= c <= 128 \
            or not (d == 2 or (d % 16 == 0 and 16 <= d <= 128)) \
            or b > 65535 or lq < 1 or lk < 1:
        raise ValueError(f"{what} takes C % 16 == 0, C <= 128, D == 2 or D "
                         f"% 16 == 0 <= 128, B <= 65535, L >= 1; got B={b}, "
                         f"Lq={lq}, Lk={lk}, C={c}, D={d}")


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"flash {what} launch failed: CUDA error {err}")


def launcher(q, k, v, scale=None, swin=None, with_lse=False,
             route: Optional[str] = None):
    """The kernel's launch for one call on CUDA tensors, without the
    count: ``((out, lse), launch, plan)``, the launch filling out (and lse
    with ``with_lse``, else None) on the current stream, a split sweep's
    runs merged into them. ``route`` forces another route of the same
    dtype unsplit (to time it beside the planned one); by default
    :func:`plan` picks it."""
    check_kernel_operands(q, k, v, (q, k, v), "flash kernel")
    b, lq, c = q.shape
    lk, d = v.shape[1], v.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(c)
    p = plan(b, lq, lk, c, d, q.dtype, _sms(q.device.index))
    if route is not None:
        p = FwdPlan(route)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.to(q.dtype).contiguous()
    if any(t.data_ptr() % 16 for t in (qc, kc, vc)):
        raise ValueError("flash kernel needs 16-byte aligned q, k and v")
    dev = q.device
    out = torch.empty(b, lq, d, dtype=torch.float32, device=dev)
    lse = torch.empty(b, lq, dtype=torch.float32, device=dev) \
        if with_lse else None
    parts = None if p.splits == 1 else tuple(
        torch.empty(s, dtype=torch.float32, device=dev)
        for s in (p.scratch_out, p.scratch_ml))
    sw = swin if swin is not None else (0, 0, 0, 0, 0)
    dims = (b, lq, lk, c, d, float(scale), *sw,
            int(q.dtype == torch.bfloat16), ROUTES[p.route], p.splits)
    fn, merge = _kernel_fns()

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    # the launch holds the operands (any copies live nowhere else) for as
    # long as it may be called
    def launch():
        stream = torch.cuda.current_stream(dev).cuda_stream
        o, l = parts if parts is not None else (out, lse)
        _check(fn(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), o.data_ptr(),
                  ptr(l), *dims, stream), "kernel")
        if parts is not None:
            _check(merge(o.data_ptr(), l.data_ptr(), out.data_ptr(), ptr(lse),
                         b * lq, d, p.splits, stream), "merge")

    return (out, lse), launch, p


def _flash_cuda(q, k, v, scale, swin, with_lse):
    (out, lse), launch, _ = launcher(q, k, v, scale, swin, with_lse)
    launch()
    flash_softmax_matmul.launches += 1
    return (out, lse) if with_lse else out


def flash_softmax_matmul(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None,
                         swin: Optional[Swin] = None,
                         with_lse: bool = False
                         ) -> Union[torch.Tensor,
                                    Tuple[torch.Tensor, torch.Tensor]]:
    """``softmax(q @ k^T * scale [+ Swin mask]) @ v`` without the
    ``[Lq, Lk]`` scores in device memory: q ``[B, Lq, C]``, k ``[B, Lk,
    C]``, v ``[B, Lk, D]`` -> ``[B, Lq, D]`` f32 (and the LSE ``[B, Lq]``
    f32 with ``with_lse``). ``scale`` defaults to ``1/sqrt(C)``.

    CPU tensors take :func:`flash_softmax_matmul_plain`; CUDA tensors
    launch the kernel on the route :func:`plan` names
    (``flash_softmax_matmul.launches`` counts those calls, a split sweep's
    merge included), which takes bf16 or f32 q/k, C % 16 == 0 up to 128
    (GMFlow's width), and D == 2 or a multiple of 16 up to 128. f32 at C =
    128 and D = 128 or 2 runs its products in split TF32 on the tensor
    cores (within f32's tolerance; :func:`flash_softmax_matmul_tf32`), its
    key sweep split at small batches. Differentiable in q, k and v (not in
    ``lse``); the gradients come back in their dtypes."""
    _check_shapes(q, k, v, swin)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _FlashFunction.apply(q, k, v, float(scale), swin)
        return (out, lse) if with_lse else out
    return _forward(q, k, v, scale, swin, with_lse)


def _forward(q, k, v, scale, swin, with_lse):
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_softmax_matmul_plain(q, k, v, scale, swin, with_lse)
    return _flash_cuda(q, k, v, scale, swin, with_lse)


class _FlashFunction(torch.autograd.Function):
    """The forward with its LSE; the backward from the saved f32 output and
    LSE (`flash.py:_flash_vjp_fwd/_flash_vjp_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, swin):
        out, lse = _forward(q, k, v, scale, swin, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.swin = scale, swin
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        from .flash_bwd import flash_backward
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g, ctx.scale, ctx.swin)
        need = ctx.needs_input_grad
        return (dq.to(q.dtype) if need[0] else None,
                dk.to(k.dtype) if need[1] else None,
                dv.to(v.dtype) if need[2] else None, None, None)


flash_softmax_matmul.launches = 0
