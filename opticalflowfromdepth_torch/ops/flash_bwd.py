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
(dq: one block per (batch, query tile) sweeping the key tiles; dk and dv:
one block per (batch, key tile) sweeping the query tiles; no atomics, so
every gradient is bit-reproducible); CPU tensors take
:func:`flash_backward_plain`. The C entry points pick the route: bf16 at
C = 128 with D = 128 or 2 (GMFlow's widths) the ``wgmma`` route (TMA, a
ring of tiles, two warpgroups); other bf16 widths the ``mma.sync``
route; f32 the CUDA-core kernels. Nothing falls back: a CUDA input that
no route takes raises.

The operand dtype is q's, as in the forward: bf16 rounds what the TPU
kernels round (q, k, v, g to bf16, ``p`` to bf16 before ``p^T g`` and
``ds`` to bf16 before both of its products), f32 rounds nothing. The
gradients come back in f32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .. import _build
from .flash import Swin, check_kernel_operands, swin_mask_dense

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
    of ``sum |g||v|`` for the widths taken, C, D <= 128) and ``exp`` and
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


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = _build.load("flash_bwd")
    fns = []
    for name, outputs in (("ofd_flash_bwd_dq", 1), ("ofd_flash_bwd_dkv", 2)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * (6 + outputs) + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns.append(fn)
    return tuple(fns)


def _flash_bwd_cuda(q, k, v, out, lse, g, scale, swin) -> Grads:
    check_kernel_operands(q, k, v, (q, k, v, out, lse, g),
                          "flash backward kernels")
    b, lq, c = q.shape
    lk, d = v.shape[1], v.shape[2]
    if out.shape != (b, lq, d) or lse.shape != (b, lq) \
            or g.shape != (b, lq, d):
        raise ValueError(f"flash_backward: out and g [B, Lq, D], lse [B, Lq];"
                         f" got {tuple(out.shape)}, {tuple(g.shape)}, "
                         f"{tuple(lse.shape)}")
    delta = (g.float() * out.float()).sum(-1)
    qc, kc = q.contiguous(), k.contiguous()
    vc, gc = v.to(q.dtype).contiguous(), g.to(q.dtype).contiguous()
    lc = lse.float().contiguous()
    if any(t.data_ptr() % 16 for t in (qc, kc, vc, gc)):
        raise ValueError("flash backward kernels need 16-byte aligned q, k, "
                         "v and g")
    dq = torch.empty(b, lq, c, dtype=torch.float32, device=q.device)
    dk = torch.empty(b, lk, c, dtype=torch.float32, device=q.device)
    dv = torch.empty(b, lk, d, dtype=torch.float32, device=q.device)
    sw = swin if swin is not None else (0, 0, 0, 0, 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn_dq, fn_dkv = _kernel_fns()
    ins = (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), gc.data_ptr(),
           lc.data_ptr(), delta.data_ptr())
    dims = (b, lq, lk, c, d, float(scale), *sw, int(q.dtype == torch.bfloat16))
    err = fn_dq(*ins, dq.data_ptr(), *dims, stream)
    if err:
        raise RuntimeError(f"flash backward dq kernel launch failed: CUDA "
                           f"error {err}")
    flash_backward.launches_dq += 1
    err = fn_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *dims, stream)
    if err:
        raise RuntimeError(f"flash backward dk/dv kernel launch failed: CUDA "
                           f"error {err}")
    flash_backward.launches_dkv += 1
    return dq, dk, dv


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                   scale: Optional[float] = None,
                   swin: Optional[Swin] = None) -> Grads:
    """(dq, dk, dv) in f32 of ``flash_softmax_matmul(q, k, v, scale,
    swin)`` for the output gradient ``g`` ``[B, Lq, D]``, from the forward's
    f32 ``out`` and ``lse``. CPU tensors take :func:`flash_backward_plain`;
    CUDA tensors launch the dq kernel and then the dk/dv kernel
    (``flash_backward.launches_dq`` and ``.launches_dkv`` count them); they
    take what the forward kernel takes."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    if all(t.device.type == "cpu" for t in (q, k, v, out, lse, g)):
        return flash_backward_plain(q, k, v, out, lse, g, scale, swin)
    return _flash_bwd_cuda(q, k, v, out, lse, g, scale, swin)


flash_backward.launches_dq = 0
flash_backward.launches_dkv = 0
