"""Flash (streaming-softmax) attention forward (port of
``opticalflowfromdepth_tpu/ops/flash.py``).

``flash_softmax_matmul(q, k, v)`` computes ``softmax(q @ k^T * scale) @
v`` for GMFlow's window attention, global matching and global flow
propagation, optionally with the Swin shifted-window mask generated from
token indices (``swin=(num_splits, wh, ww, sh, sw)``, batch ordered [b,
wy, wx]) and the per-row log-sum-exp. CUDA tensors launch the hand-written
kernel in ``csrc/flash.cu``; CPU tensors take the plain version below.
Nothing falls back: a CUDA input the kernel does not take raises.

The operand dtype is q's: bf16 (the serving path, as the TPU kernel, which
casts every operand to bf16; v is cast here, so an f32 flow payload is
rounded exactly as the TPU kernel rounds it) or f32 (f32 models keep f32
operands, as the JAX dense path on the CPU does). The output is f32.

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
from typing import Optional, Tuple, Union

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


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("flash").ofd_flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _plan_fn():
    fn = _build.load("flash").ofd_flash_fwd_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def kernel_plan(b: int, lq: int, lk: int, c: int, d: int,
                bf16: bool) -> dict:
    """What the forward kernel launches for these operands on the current
    CUDA device: its route ("wgmma", "mma.sync" or "f32"), warpgroups a
    block, blocks, blocks resident per SM and waves over the SMs."""
    plan = (ctypes.c_int * 5)()
    err = _plan_fn()(b, lq, lk, c, d, int(bf16), plan)
    if err:
        raise RuntimeError(f"flash kernel plan failed: CUDA error {err}")
    return dict(route=("f32", "mma.sync", "wgmma")[plan[0]],
                warpgroups=plan[1], blocks=plan[2], per_sm=plan[3],
                waves=plan[4])


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


def _flash_cuda(q, k, v, scale, swin, with_lse):
    check_kernel_operands(q, k, v, (q, k, v), "flash kernel")
    b, lq, c = q.shape
    lk, d = v.shape[1], v.shape[2]
    qc, kc, vc = q.contiguous(), k.contiguous(), v.to(q.dtype).contiguous()
    if any(t.data_ptr() % 16 for t in (qc, kc, vc)):
        raise ValueError("flash kernel needs 16-byte aligned q, k and v")
    out = torch.empty(b, lq, d, dtype=torch.float32, device=q.device)
    lse = torch.empty(b, lq, dtype=torch.float32, device=q.device) \
        if with_lse else None
    sw = swin if swin is not None else (0, 0, 0, 0, 0)
    err = _kernel_fn()(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                       out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                       b, lq, lk, c, d, float(scale), *sw,
                       int(q.dtype == torch.bfloat16),
                       torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash kernel launch failed: CUDA error {err}")
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
    launch the kernel (``flash_softmax_matmul.launches`` counts those
    launches), which takes bf16 or f32 q/k, C % 16 == 0 up to 128 (GMFlow's
    width), and D == 2 or a multiple of 16 up to 128. Differentiable in q,
    k and v (not in ``lse``); the gradients come back in their dtypes."""
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
