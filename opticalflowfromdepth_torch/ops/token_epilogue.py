"""The per-token epilogues of GMFlow's transformer layers in one pass each:
the layer norm with its residual add (:func:`token_norm`) and the exact
GELU (:func:`gelu`).

Replaces no TPU kernel: the JAX package leaves its LayerNorm and GELU to
XLA. The plain versions (:func:`token_norm_plain`, :func:`gelu_plain`;
``models/gmflow.py:_layer_norm`` and ``_gelu`` are theirs) are flax's
LayerNorm with f32 statistics and normalisation and the result in the
input's dtype, and ``0.5 x erfc(-x sqrt(1/2))`` with every product rounded
to x's dtype, as ``jax.nn.gelu(approximate=False)`` computes it.

The kernels have no backward. Where autograd records a graph through an
epilogue (grad enabled and an input or a parameter requiring grad:
training), the caller runs the plain versions itself, as
``TransformerLayer.windowed`` does (:func:`records_graph`); the public
entries refuse such operands. Otherwise CPU tensors take the plain
version (``token_norm.plain`` and ``gelu.plain`` count those calls) and
CUDA tensors launch the kernel of ``csrc/token_epilogue.cu``
(``token_norm.launches`` and ``gelu.launches`` count the launches), which
takes f32 or bf16 rows, contiguous and 16-byte aligned, the norm's C a
multiple of 8 up to 512 and its residual of x's dtype and shape; on any
other CUDA operand the entries raise.

The GELU kernel rounds where the plain version rounds: bit for bit (in
bf16 its erfc comes from :func:`erfc_table`). The layer norm kernel sums
in another order than ``F.layer_norm`` (two passes over registers against
Welford's), so its norm lies within one step of the output dtype of the
plain version's (or, near 0, where ``weight * xhat`` and ``bias`` cancel,
within the f32 rounding of those terms), and the residual add is the
plain version's own.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from ..utils.device import sm_count
from ..utils.profiling import spanned

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256          # a block of either kernel
MAX_C = 512            # the widest row the norm kernel takes
BLOCKS_PER_SM = 4      # the GELU's resident 256-thread blocks an SM


def token_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float,
                     residual: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``residual + LayerNorm(x)`` op by op: statistics and normalisation
    in f32, the norm in x's dtype, then the add (none without a
    residual)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight, bias,
                     eps).to(x.dtype)
    return y if residual is None else residual + y


def gelu_plain(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU as ``jax.nn.gelu(approximate=False)`` computes it, op by
    op in x's dtype: ``0.5 x erfc(-x sqrt(1/2))`` with sqrt(1/2) and every
    product rounded to that dtype (``F.gelu`` rounds once, and in bf16 the
    FFN layer then leaves the JAX one by a step in many outputs)."""
    half_sqrt = float(torch.tensor(math.sqrt(0.5), dtype=x.dtype))
    return 0.5 * x * torch.erfc(x * -half_sqrt)


def records_graph(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd records a graph through an op on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _norm_blocks_per_sm(floats: int) -> int:
    """The norm kernel's resident blocks an SM for a thread holding
    ``floats`` values of each operand (``csrc/token_epilogue.cu:
    blocks_per_sm``, its launch bounds)."""
    return 4 if floats <= 8 else 2 if floats <= 16 else 1


def plan(rows: int, c: int, itemsize: int, sms: int
         ) -> Optional[Tuple[int, int, int]]:
    """How the norm kernel cuts ``rows`` rows of ``c`` values of
    ``itemsize`` bytes on ``sms`` SMs: ``(log2_lanes, vpl, blocks)``,
    2^log2_lanes threads a row (a power of two up to a warp) each holding
    up to ``vpl`` (1, 2 or 4) 16-byte vectors of it, and a grid of
    ``blocks`` blocks that stays resident; None where the kernel does not
    take ``c``."""
    if c % 8 or not 0 < c <= MAX_C:
        return None
    vecs = c * itemsize // 16
    log2_lanes = min(5, (vecs - 1).bit_length())
    vpl = 1 << (-(-vecs // (1 << log2_lanes)) - 1).bit_length()
    rows_a_block = THREADS >> log2_lanes
    blocks = max(1, min(-(-rows // rows_a_block),
                        sms * _norm_blocks_per_sm(vpl * 16 // itemsize)))
    return log2_lanes, vpl, blocks


@functools.lru_cache(maxsize=None)
def _norm_fn():
    fn = _build.load("token_epilogue").ofd_token_norm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _gelu_fn():
    fn = _build.load("token_epilogue").ofd_gelu_exact_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def erfc_table(device: torch.device) -> torch.Tensor:
    """The bf16 GELU's table on ``device``, made there once by the
    kernel's own erfcf: entry i is the bits of bf16(erfc(t)) for the bf16
    t of bits i (``[65536]`` int16, outside inference mode). Made inside
    a CUDA graph capture it would be filled only by the graph's replay, so
    that raises: call the GELU once before capturing it."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("erfc table: first asked for inside a CUDA graph "
                           "capture; run the bf16 GELU once before")
    with torch.inference_mode(False):
        tab = torch.empty(1 << 16, dtype=torch.int16, device=device)
    fn = _build.load("token_epilogue").ofd_erfc_table
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(tab.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"erfc table kernel launch failed: CUDA error "
                           f"{err}")
    return tab


def _norm_refusal(x, weight, bias, residual) -> Optional[str]:
    """Why the norm kernel does not take these CUDA operands (None where
    it does)."""
    c = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPES:
        return f"x is {x.dtype}, not f32 or bf16"
    if c % 8 or not 0 < c <= MAX_C:
        return f"C = {c} is not a multiple of 8 up to {MAX_C}"
    if not all(p is not None and p.dtype == torch.float32
               and p.is_contiguous() and p.shape == (c,)
               and p.device == x.device for p in (weight, bias)):
        return "weight and bias are not contiguous f32 [C] on x's device"
    if not _aligned(x):
        return "x is not contiguous and 16-byte aligned"
    if residual is not None and not (
            residual.dtype == x.dtype and residual.shape == x.shape
            and residual.device == x.device and _aligned(residual)):
        return ("the residual is not x's dtype and shape, contiguous and "
                "16-byte aligned")
    return None


def _token_norm_cuda(x, weight, bias, eps, residual):
    why = _norm_refusal(x, weight, bias, residual)
    if why is not None:
        raise ValueError(f"token_norm: the kernel does not take this: {why}")
    c = x.shape[-1]
    rows = x.numel() // c
    y = torch.empty_like(x)
    if rows:
        log2_lanes, vpl, blocks = plan(rows, c, x.element_size(),
                                       sm_count(x.device.index))
        with torch.cuda.device(x.device):
            err = _norm_fn()(
                x.data_ptr(), None if residual is None else
                residual.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                y.data_ptr(), rows, c, _DTYPES[x.dtype], log2_lanes, vpl,
                blocks, float(eps),
                torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"token_norm kernel launch failed: CUDA error "
                               f"{err}")
        token_norm.launches += 1
    return y


def _gelu_cuda(x):
    if x.dtype not in _DTYPES or not _aligned(x):
        raise ValueError(f"gelu: the kernel takes contiguous, 16-byte "
                         f"aligned f32 or bf16, got {x.dtype}")
    y = torch.empty_like(x)
    n = x.numel()
    if n:
        c = -float(torch.tensor(math.sqrt(0.5), dtype=x.dtype))
        vecs = n * x.element_size() // 16
        blocks = max(1, min(-(-vecs // (2 * THREADS)),
                            sm_count(x.device.index) * BLOCKS_PER_SM))
        tab = (erfc_table(x.device).data_ptr()
               if x.dtype == torch.bfloat16 else None)
        with torch.cuda.device(x.device):
            err = _gelu_fn()(x.data_ptr(), y.data_ptr(), n, _DTYPES[x.dtype],
                             c, tab, blocks,
                             torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"gelu kernel launch failed: CUDA error {err}")
        gelu.launches += 1
    return y


def _refuse_graph(name: str, *tensors: Optional[torch.Tensor]) -> None:
    if records_graph(*tensors):
        raise ValueError(f"{name}: autograd records a graph here and the "
                         f"kernel has no backward; call {name}_plain")


@spanned("ofd.op.token_norm")
def token_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, residual: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """``residual + LayerNorm(x)`` over x's last dimension (the norm alone
    without a residual), f32 ``weight`` and ``bias``, in one pass where
    autograd records nothing (module docstring: the CPU path, the
    operands the kernel takes, the counters)."""
    _refuse_graph("token_norm", x, weight, bias, residual)
    if x.device.type == "cpu":
        token_norm.plain += 1
        return token_norm_plain(x, weight, bias, eps, residual)
    return _token_norm_cuda(x, weight, bias, eps, residual)


@spanned("ofd.op.gelu")
def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU in x's dtype, bit for bit :func:`gelu_plain`, in one
    pass where autograd records nothing (module docstring)."""
    _refuse_graph("gelu", x)
    if x.device.type == "cpu":
        gelu.plain += 1
        return gelu_plain(x)
    return _gelu_cuda(x)


token_norm.launches = token_norm.plain = 0
gelu.launches = gelu.plain = 0
