"""The arithmetic the plain references compute in.

``F32`` is true float32: every product in full f32, with TF32 switched off
for cuBLAS and cuDNN while a reference runs (:func:`true_f32`), so the
reference is not itself in a lower precision on the card.

``FP8`` is the control of the benchmark's correctness check: the same
reference with every operand of a matrix product or convolution rounded to
fp8 e4m3 (one scale per tensor, the largest magnitude mapped to e4m3's
largest value) and, in a backward pass, every incoming gradient of such a
product rounded to fp8 e5m2; products accumulate in f32. That is fp8
training as it is usually done (inputs e4m3, gradients e5m2, f32
accumulators), the next precision below the bf16 the configurations
state. A check that cannot tell the program from this is too loose.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def true_f32():
    """Full f32 products for cuBLAS and cuDNN inside the block; the flags
    are restored after it, so the program keeps its own settings."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to the fp8 ``dtype`` under one per-tensor scale, back
    in f32."""
    xf = x.float()
    amax = xf.abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (xf * scale).to(dtype).float() / scale


class _RoundOperand(torch.autograd.Function):
    """Forward: the operand in e4m3. Backward: the gradient passes as it
    is (the product's own backward already saw e5m2 gradients)."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """Forward: identity. Backward: the product's incoming gradient in
    e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


class F32:
    """Products and convolutions in f32."""

    name = "f32"

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def output(self, y: torch.Tensor) -> torch.Tensor:
        return y

    def matmul(self, a, b):
        return self.output(torch.matmul(self.operand(a), self.operand(b)))

    def linear(self, x, w, b=None):
        return self.output(F.linear(self.operand(x), self.operand(w), b))

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        return self.output(F.conv2d(self.operand(x), self.operand(w), b,
                                    stride, padding))


class FP8(F32):
    """Products and convolutions from fp8 operands (module docstring)."""

    name = "fp8"

    def operand(self, x):
        return _RoundOperand.apply(x)

    def output(self, y):
        return _RoundGrad.apply(y) if y.requires_grad else y


class _BF16Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


class BF16(F32):
    """Products and convolutions from bf16 operands, their gradients in
    bf16, f32 accumulation: the configurations' own precision, a witness
    of what rounding alone does to a number (never a control)."""

    name = "bf16"

    def operand(self, x):
        return _BF16Operand.apply(x)
