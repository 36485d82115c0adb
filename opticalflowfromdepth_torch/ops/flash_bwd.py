"""Flash (streaming-softmax) attention backward (port of
``opticalflowfromdepth_tpu/ops/flash_bwd.py``).

Given the forward's residuals (the f32 output ``out`` and the per-row
log-sum-exp ``lse``) and the output's gradient ``g``, the standard
two-pass flash backward of ``softmax(q k^T * scale [+ Swin]) v``:

    delta_i = sum_d g_id out_id                    (f32, dense, beforehand)
    p  = exp(s - lse),  s the masked scores recomputed from q and k
    dv = p^T g,   dp = g v^T,   ds = p (dp - delta)
    dq = ds k * scale,   dk = ds^T q * scale

CUDA tensors launch the two hand-written kernels of ``csrc/flash_bwd.cu``
(dq: blocks over (batch, query rows) sweeping the key tiles; dk and dv:
blocks over (batch, key rows) sweeping the query tiles; no atomics, so
every gradient is bit-reproducible); CPU tensors take
:func:`flash_backward_plain`. :func:`plan` picks the route from the dtype
and widths: bf16 at C = 128 with D = 128 or 2 (GMFlow's widths) and at C =
256 with D = 256 or 2 (GMFlow at 256 channels) the ``wgmma`` route (TMA, a
ring of tiles, two warpgroups; :func:`wgmma_widths`); other bf16 widths
the ``mma.sync`` route; f32 at C = 128 with D = 128 or 2 (every
sequence-parallel ring step, every f32 GMFlow call) the ``tf32x3`` route
(split-TF32 ``mma.sync`` products, whose sweep it splits where the card
would otherwise hold less than one wave of blocks, the partial sums
reduced in a fixed order); other f32 widths the CUDA-core kernels.
Nothing falls back: a CUDA input that no route takes raises.

The operand dtype is q's, as in the forward: bf16 rounds what the TPU
kernels round (q, k, v, g to bf16, ``p`` to bf16 before ``p^T g`` and
``ds`` to bf16 before both of its products), f32 rounds nothing but what
the split-TF32 products drop (:func:`flash_backward_tf32` repeats them).
The gradients come back in f32. Widths are the forward's: C and D from 1
to ``MAX_WIDTH``, padded to the kernels' tiles (q, k with zero columns to
C % 16 == 0, v and g to D = 2 or D % 16 == 0) and dq, dk, dv sliced back;
the mma.sync and CUDA-core kernels take every width (C, or C and D, split
over a grid axis in 128-column chunks, S and dP recomputed by each
chunk's blocks over panels of 128 columns of C and D; each block within
227 KB of shared memory, as :func:`kernel_plan` reports).
The forward takes its wgmma route at the same widths (one predicate,
``ops/flash.py:wgmma_widths``).

With a dense ``bias`` the backward is JAX's ``_flash_vjp_bwd``: a dense
recompute outside any kernel (:func:`flash_backward_with_bias`, plain
PyTorch on both devices; JAX computes it in XLA, not in Pallas).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
# the plan's constants, the width predicates, the split count and the
# split-TF32 products are the forward's too
from .flash import (
    H100_SMS, ROUTES, SMEM_RESERVED, SMEM_SM, TF32_STRIDE, Swin, _pad_last,
    _sms, check_kernel_operands, gmflow_widths, matmul_tf32, padded_widths,
    split_count, swin_mask_dense, wgmma_widths)

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _operands(q, k, v, g):
    """f32 copies of the operands as the kernels see them: rounded to bf16
    when q is bf16, unrounded when it is f32."""
    dt = q.dtype
    return tuple(t.to(dt).float() for t in (q, k, v, g))


def _scores(qf, kf, scale, swin):
    s = torch.matmul(qf, kf.transpose(1, 2)) * scale
    if swin is not None:
        s = s + swin_mask_dense(kf.shape[1], swin, qf.shape[0], qf.device)
    return s


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                         scale: Optional[float] = None,
                         swin: Optional[Swin] = None) -> Grads:
    """Plain PyTorch version with the TPU kernels' arithmetic
    (`flash_bwd.py:64-136`): ``delta`` from the unrounded f32 ``g`` and
    ``out``; scores ``(q . k) * scale`` in f32, the Swin mask added; ``p =
    exp(s - lse)``; in bf16, ``p`` rounded before ``p^T g`` and ``ds``
    rounded before ``ds k`` and ``ds^T q``, the sums in f32 and the scale
    applied after them. Returns f32 (dq ``[B, Lq, C]``, dk ``[B, Lk, C]``,
    dv ``[B, Lk, D]``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    bf16 = q.dtype == torch.bfloat16
    delta = (g.float() * out.float()).sum(-1, keepdim=True)
    qf, kf, vf, gf = _operands(q, k, v, g)
    p = torch.exp(_scores(qf, kf, scale, swin) - lse.float()[..., None])
    ds = p * (torch.matmul(gf, vf.transpose(1, 2)) - delta)
    if bf16:
        p = p.to(torch.bfloat16).float()
        ds = ds.to(torch.bfloat16).float()
    dv = torch.matmul(p.transpose(1, 2), gf)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(1, 2), qf) * scale
    return dq, dk, dv


def flash_backward_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        g: torch.Tensor, scale: Optional[float] = None,
                        swin: Optional[Swin] = None, terms: int = 3) -> Grads:
    """The tf32x3 route's arithmetic in plain PyTorch (f32 operands, C =
    128, D = 128 or 2): as :func:`flash_backward_plain` in f32, but every
    C- and D-wide product through :func:`matmul_tf32` (``terms`` pieces);
    at D = 2 ``dp`` and ``dv`` stay plain f32, as the kernels take them on
    the CUDA cores. ``terms=1`` shows what plain TF32 products would lose."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    d = v.shape[2]
    delta = (g.float() * out.float()).sum(-1, keepdim=True)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s = matmul_tf32(qf, kf.transpose(1, 2), terms) * scale
    if swin is not None:
        s = s + swin_mask_dense(kf.shape[1], swin, qf.shape[0], qf.device)
    p = torch.exp(s - lse.float()[..., None])
    if d == 2:
        dp = torch.matmul(gf, vf.transpose(1, 2))
        dv = torch.matmul(p.transpose(1, 2), gf)
    else:
        dp = matmul_tf32(gf, vf.transpose(1, 2), terms)
        dv = matmul_tf32(p.transpose(1, 2), gf, terms)
    ds = p * (dp - delta)
    dq = matmul_tf32(ds, kf, terms) * scale
    dk = matmul_tf32(ds.transpose(1, 2), qf, terms) * scale
    return dq, dk, dv


def flash_backward_with_bias(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: torch.Tensor,
                             g: torch.Tensor, scale: Optional[float] = None,
                             swin: Optional[Swin] = None) -> Grads:
    """(dq, dk, dv) of ``flash_softmax_matmul(q, k, v, scale, bias, swin)``
    for the output gradient ``g``, as JAX's ``_flash_vjp_bwd`` computes
    them with a bias (`flash.py:278-300`): the softmax recomputed densely
    from ``s = q k^T * scale + bias [+ Swin]``, ``dv = p^T g``, ``dp = g
    v^T``, ``ds = p (dp - sum(dp p))``, ``dq = ds k * scale``, ``dk = ds^T
    q * scale``, in plain PyTorch on either device. bf16 operands are cast
    as JAX casts them: q, k and ds rounded to bf16 (the products summed in
    f32), p, g and v in f32. f32 operands stay f32 (JAX rounds q, k and ds
    to bf16 even then; the port keeps f32 wherever its operands are f32).
    Returns f32; the caller casts each to its operand's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    if q.dtype == torch.bfloat16:
        def cast(t):
            return t.to(torch.bfloat16).float()
    else:
        def cast(t):
            return t.float()
    qf, kf = cast(q), cast(k)
    s = torch.matmul(qf, kf.transpose(1, 2)) * scale + bias.float()
    if swin is not None:
        s = s + swin_mask_dense(k.shape[1], swin, q.shape[0], q.device)
    p = torch.softmax(s, -1)
    gf = g.float()
    dv = torch.matmul(p.transpose(1, 2), gf)
    dp = torch.matmul(gf, v.float().transpose(1, 2))
    ds = cast(p * (dp - (dp * p).sum(-1, keepdim=True)))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(1, 2), qf) * scale
    return dq, dk, dv


def bwd_bf16_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                       scale: Optional[float] = None,
                       swin: Optional[Swin] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """How far the kernels' bf16 gradients may lie from
    :func:`flash_backward_plain`'s: dq row by row ``[B, Lq, 1]``, dk and dv
    key by key ``[B, Lk, 1]``.

    Both round the same ``p`` and ``ds`` to bf16 at the same places, but
    their f32 values differ in the last bits: the scores and ``dp`` are
    summed in another order (at most ``2^-20`` of ``scale sum |q||k|`` and
    of ``sum |g||v|``, derived for C, D <= 128; the kernels stay within
    the allowance at the widths past 256 that ``chip_smoke.py`` [3k]
    tries, C up to 2000 and D up to 600, and at GMFlow-512's training
    shapes, 3220 keys) and ``exp`` and
    ``s - lse`` differ by an ulp or two (``2^-18``), so ``p`` may differ
    by ``p eps_s``, ``eps_s = 2^-20 (scale sum |q||k| + 4)``, and ``ds`` by
    ``eps_s p |dp - delta| + p eps_dp``. That moves each term of a sum
    by as much, and a value that then rounds to the neighbouring bf16
    number moves its term by at most 2^-7 of it. Allowed for each output
    row: the summed f32 differences of its terms, two bf16 steps of its
    largest term (as ``ops/flash.py:bf16_tolerance``), ``2^-16`` of the sum
    of its terms' sizes for the f32 sums, and 1e-6. The terms are ``|ds|
    |k|`` (dq, times scale), ``|ds| |q|`` (dk, times scale) and ``p |g|``
    (dv), ``|x|`` the largest entry of a row of x."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    delta = (g.float() * out.float()).sum(-1, keepdim=True)
    qf, kf, vf, gf = _operands(q, k, v, g)
    p = torch.exp(_scores(qf, kf, scale, swin) - lse.float()[..., None])
    dp = torch.matmul(gf, vf.transpose(1, 2))
    ds = p * (dp - delta)
    eps_s = 2.0 ** -20 * (torch.matmul(qf.abs(), kf.abs().transpose(1, 2))
                          * scale + 4.0)
    eps_dp = 2.0 ** -20 * torch.matmul(gf.abs(), vf.abs().transpose(1, 2))
    d_p = p * eps_s
    d_ds = d_p * (dp - delta).abs() + p * eps_dp
    qm, km, gm = (t.abs().amax(-1)[:, None, :] for t in (qf, kf, gf))

    def limit(term, diff, weight):
        """Per row of ``term`` and ``diff``, weighted by ``weight`` along
        the last axis: ``sum diff w + 2^-6 max term w + 2^-16 sum term w +
        1e-6``."""
        w = term * weight
        return ((diff * weight).sum(-1, keepdim=True)
                + 2 ** -6 * w.amax(-1, keepdim=True)
                + 2 ** -16 * w.sum(-1, keepdim=True) + 1e-6)

    ads = ds.abs()
    tol_dq = scale * limit(ads, d_ds, km)
    tol_dk = scale * limit(ads.transpose(1, 2), d_ds.transpose(1, 2), qm)
    tol_dv = limit(p.transpose(1, 2), d_p.transpose(1, 2), gm)
    return tol_dq, tol_dk, tol_dv


class BwdPlan(NamedTuple):
    """How the two kernels run one call: the ``route`` (:func:`plan`'s
    rule: bf16 ``wgmma`` at :func:`wgmma_widths`, else ``mma_sync``; f32
    ``tf32x3`` at C = 128 with D = 128 or 2, else ``f32``); for the tf32x3
    route the output rows a block (``rows``), the other side's rows a
    ring tile (``tile``), each kernel's shared memory a block
    (``smem``: dq, dk/dv, bytes) and blocks an SM, the runs that each
    sweep is cut into (``splits_dq`` over the keys, ``splits_dkv`` over
    the queries; each kernel's grid is (row blocks, splits, B)), and the
    f32 scratch shapes of the partial sums where a sweep is split (dq
    ``[splits, B, Lq, C]``, dk ``[splits, B, Lk, C]``, dv ``[splits, B,
    Lk, D]``; None where not); the padded widths (``c_pad``, ``d_pad``).
    The other routes' blocks are the C side's to choose:
    :func:`kernel_plan` reports them."""
    route: str
    rows: int = 0
    tile: int = 0
    smem: Tuple[int, int] = (0, 0)
    blocks_per_sm: int = 0
    splits_dq: int = 1
    splits_dkv: int = 1
    scratch_dq: Optional[Tuple[int, ...]] = None
    scratch_dk: Optional[Tuple[int, ...]] = None
    scratch_dv: Optional[Tuple[int, ...]] = None
    c_pad: int = 0
    d_pad: int = 0


def tf32_blocks(d: int) -> Tuple[int, int, int]:
    """The tf32x3 route's block at D = d (``tf32x3::Cfg``): (output rows,
    streamed rows a tile, blocks an SM by its launch bounds). D = 2: 4
    warps, 64-row tiles, two blocks an SM; D = 128: 8 warps (dK's and
    dV's accumulators), 32-row tiles, one."""
    return (64, 64, 2) if d == 2 else (128, 32, 1)


def tf32_smem(d: int, dkv: bool) -> int:
    """Shared memory of a tf32x3 block (``Cfg::smem_bytes``): the resident
    rows (the C-wide side, and at D = 128 the D-wide one) and two ring
    stages (the streamed C-wide tile, its D-wide tile or pairs, and for
    dk/dv lse and delta), rows of TF32_STRIDE floats."""
    rows, tile, _ = tf32_blocks(d)
    res = rows * TF32_STRIDE * (1 if d == 2 else 2)
    stage = tile * TF32_STRIDE + (2 * tile if d == 2 else tile * TF32_STRIDE)
    return 4 * (res + 2 * (stage + (2 * tile if dkv else 0)))


def plan(b: int, lq: int, lk: int, c: int, d: int,
         dtype: torch.dtype = torch.float32, sms: int = H100_SMS) -> BwdPlan:
    """The route and its parameters for q ``[b, lq, c]``, k ``[b, lk, c]``,
    v ``[b, lk, d]`` of ``dtype``, at the widths ``padded_widths`` gives
    (past ``MAX_WIDTH`` raises); pure host arithmetic. bf16 at C = 128 with
    D = 128 or 2 and at C = 256 with D = 256 or 2 (:func:`wgmma_widths`)
    takes the wgmma route, other bf16 the mma.sync route; f32 at C = 128
    with D = 128 or 2 the tf32x3 route, other f32 the CUDA-core route (the
    widths within int32 rows, as the C side checks)."""
    cp, dp = padded_widths(c, d)
    if dtype == torch.bfloat16:
        return BwdPlan("wgmma" if wgmma_widths(b, lq, lk, c, d)
                       else "mma_sync", c_pad=cp, d_pad=dp)
    if not gmflow_widths(b, lq, lk, c, d):
        return BwdPlan("f32", c_pad=cp, d_pad=dp)
    rows, tile, per_sm = tf32_blocks(dp)
    smem = (tf32_smem(dp, False), tf32_smem(dp, True))
    per_sm = min(per_sm, SMEM_SM // (max(smem) + SMEM_RESERVED))
    slots = sms * per_sm
    s_dq = split_count(b * -(-lq // rows), -(-lk // tile), slots)
    s_dkv = split_count(b * -(-lk // rows), -(-lq // tile), slots)
    return BwdPlan(
        "tf32x3", rows, tile, smem, per_sm, s_dq, s_dkv,
        (s_dq, b, lq, cp) if s_dq > 1 else None,
        (s_dkv, b, lk, cp) if s_dkv > 1 else None,
        (s_dkv, b, lk, dp) if s_dkv > 1 else None, cp, dp)


def bind(lib: ctypes.CDLL):
    """The typed C entry points of a build of ``csrc/flash_bwd.cu``: the
    dq sweep, the dk/dv sweep and the reduction of a split sweep's partial
    sums."""
    fns = []
    for name, outputs in (("ofd_flash_bwd_dq", 1), ("ofd_flash_bwd_dkv", 2)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * (6 + outputs) + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns.append(fn)
    fn = lib.ofd_flash_bwd_reduce
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fns.append(fn)
    return tuple(fns)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    return bind(_build.load("flash_bwd"))


@functools.lru_cache(maxsize=None)
def _plan_fn():
    fn = _build.load("flash_bwd").ofd_flash_bwd_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def kernel_plan(b: int, lq: int, lk: int, c: int, d: int,
                bf16: bool) -> dict:
    """What the two kernels launch for these operands (at their padded
    widths) on the current CUDA device by the C side's own rule: for
    ``"dq"`` and ``"dkv"`` the route (a key of ROUTES), output rows and
    threads a block, blocks of one run, column chunks (mma.sync), shared
    memory a block (bytes, static included), blocks resident per SM,
    registers and local memory (bytes) a thread. Raises where the card
    cannot hold a block."""
    cp, dp = padded_widths(c, d)
    plans = {}
    for key in ("dq", "dkv"):
        out = (ctypes.c_int * 10)()
        err = _plan_fn()(b, lq, lk, cp, dp, int(bf16), int(key == "dkv"),
                         out)
        if err:
            raise RuntimeError(f"flash backward {key} kernel plan failed: "
                               f"CUDA error {err}")
        plans[key] = dict(
            route={code: name for name, code in ROUTES.items()}[out[0]],
            rows=out[1], threads=out[2], blocks=out[3], chunks=out[4],
            smem=out[5] + out[6], per_sm=out[7], regs=out[8], local=out[9])
    return plans


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"flash backward {what} kernel launch failed: "
                           f"CUDA error {err}")


def launchers(q, k, v, out, lse, g, scale=None, swin=None,
              route: Optional[str] = None):
    """The kernels' launches for one call on CUDA tensors, without the
    counts: ``((dq, dk, dv), launch_dq, launch_dkv, plan)``, each launch
    filling its outputs (a split sweep's partial sums reduced into them)
    on the current stream. ``route`` forces another route of the same
    dtype unsplit (to time it beside the planned one); by default
    :func:`plan` picks it."""
    check_kernel_operands(q, k, v, (q, k, v, out, lse, g),
                          "flash backward kernels")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    b, lq, c = q.shape
    lk, d = v.shape[1], v.shape[2]
    if out.shape != (b, lq, d) or lse.shape != (b, lq) \
            or g.shape != (b, lq, d):
        raise ValueError(f"flash_backward: out and g [B, Lq, D], lse [B, Lq];"
                         f" got {tuple(out.shape)}, {tuple(g.shape)}, "
                         f"{tuple(lse.shape)}")
    p = plan(b, lq, lk, c, d, q.dtype, _sms(q.device.index))
    if route is not None:
        p = BwdPlan(route, c_pad=p.c_pad, d_pad=p.d_pad)
    cp, dp = p.c_pad, p.d_pad
    delta = (g.float() * out.float()).sum(-1)
    qc, kc = (_pad_last(t, cp).contiguous() for t in (q, k))
    vc, gc = (_pad_last(t.to(q.dtype), dp).contiguous() for t in (v, g))
    lc = lse.float().contiguous()
    if any(t.data_ptr() % 16 for t in (qc, kc, vc, gc)):
        raise ValueError("flash backward kernels need 16-byte aligned q, k, "
                         "v and g")
    dev = q.device
    dq = torch.empty(b, lq, cp, dtype=torch.float32, device=dev)
    dk = torch.empty(b, lk, cp, dtype=torch.float32, device=dev)
    dv = torch.empty(b, lk, dp, dtype=torch.float32, device=dev)
    parts = [torch.empty(s, dtype=torch.float32, device=dev) if s else None
             for s in (p.scratch_dq, p.scratch_dk, p.scratch_dv)]
    sw = swin if swin is not None else (0, 0, 0, 0, 0)
    dims = (b, lq, lk, cp, dp, float(scale), *sw,
            int(q.dtype == torch.bfloat16), ROUTES[p.route])
    fn_dq, fn_dkv, fn_reduce = _kernel_fns()
    # the launches hold the operands (delta and any copies live nowhere
    # else) for as long as they may be called
    operands = (qc, kc, vc, gc, lc, delta)

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def reduce(part, target, splits, mult):
        _check(fn_reduce(part.data_ptr(), target.data_ptr(), target.numel(),
                         splits, float(mult), stream()), "reduction")

    def launch_dq():
        part = parts[0] if parts[0] is not None else dq
        _check(fn_dq(*(t.data_ptr() for t in operands), part.data_ptr(),
                     *dims, p.splits_dq, stream()), "dq")
        if parts[0] is not None:
            reduce(part, dq, p.splits_dq, scale)

    def launch_dkv():
        pk = parts[1] if parts[1] is not None else dk
        pv = parts[2] if parts[2] is not None else dv
        _check(fn_dkv(*(t.data_ptr() for t in operands), pk.data_ptr(),
                      pv.data_ptr(), *dims, p.splits_dkv, stream()),
               "dk/dv")
        if parts[1] is not None:
            reduce(pk, dk, p.splits_dkv, scale)
            reduce(pv, dv, p.splits_dkv, 1.0)

    grads = (dq[..., :c], dk[..., :c], dv[..., :d]) if (cp, dp) != (c, d) \
        else (dq, dk, dv)
    return grads, launch_dq, launch_dkv, p


def _flash_bwd_cuda(q, k, v, out, lse, g, scale, swin) -> Grads:
    grads, launch_dq, launch_dkv, _ = launchers(q, k, v, out, lse, g, scale,
                                                swin)
    launch_dq()
    flash_backward.launches_dq += 1
    launch_dkv()
    flash_backward.launches_dkv += 1
    return grads


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                   scale: Optional[float] = None,
                   swin: Optional[Swin] = None) -> Grads:
    """(dq, dk, dv) in f32 of ``flash_softmax_matmul(q, k, v, scale,
    swin)`` for the output gradient ``g`` ``[B, Lq, D]``, from the forward's
    f32 ``out`` and ``lse``. CPU tensors take :func:`flash_backward_plain`;
    CUDA tensors launch the dq kernel and then the dk/dv kernel on the
    route :func:`plan` picks (``flash_backward.launches_dq`` and
    ``.launches_dkv`` count them, a split sweep's reduction included);
    they take what the forward kernel takes (any C and D up to
    ``MAX_WIDTH``). A call with a dense bias takes
    :func:`flash_backward_with_bias` instead."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    if all(t.device.type == "cpu" for t in (q, k, v, out, lse, g)):
        return flash_backward_plain(q, k, v, out, lse, g, scale, swin)
    return _flash_bwd_cuda(q, k, v, out, lse, g, scale, swin)


flash_backward.launches_dq = 0
flash_backward.launches_dkv = 0
