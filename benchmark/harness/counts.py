"""Work counted from a configuration's shapes: the model's FLOPs, taken
by running the plain reference on the ``meta`` device under PyTorch's
FLOP counter (every convolution and matrix product, forward and, in
training, backward: the weight and input gradients the reference's
autograd asks for, no recompute), and the shapes of the encoders'
instance norms."""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from . import precision, refs


def _meta(spec: refs.Spec, grad: bool) -> Dict[str, torch.Tensor]:
    out = {}
    for name, shape, init in spec:
        dtype = torch.long if init == "count" else torch.float32
        t = torch.empty(shape, dtype=dtype, device="meta")
        out[name] = t.requires_grad_(True) if grad and dtype.is_floating_point \
            else t
    return out


def train_flops(spec: refs.Spec, aux: refs.Spec,
                batch: Dict[str, Tuple[int, ...]],
                make_loss: Callable) -> float:
    """FLOPs of one training step: ``make_loss(P, aux_weights)`` gives the
    reference's ``loss_fn(params, batch, step)``."""
    from torch.utils.flop_counter import FlopCounterMode
    params = _meta(spec, True)
    loss_fn = make_loss(precision.F32(), _meta(aux, False))
    inputs = {k: torch.empty(s, device="meta") for k, s in batch.items()}
    with FlopCounterMode(display=False) as counter:
        loss, _ = loss_fn(params, inputs, 0)
        torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return float(counter.get_total_flops())


def infer_flops(spec: refs.Spec, run: Callable, *shapes) -> float:
    """FLOPs of one inference call: ``run(P, weights, *inputs)``."""
    from torch.utils.flop_counter import FlopCounterMode
    weights = _meta(spec, False)
    inputs = [torch.empty(s, device="meta") for s in shapes]
    with FlopCounterMode(display=False) as counter:
        run(precision.F32(), weights, *inputs)
    return float(counter.get_total_flops())


def stride_out(n: int, factor: int) -> int:
    """A side after ``log2(factor)`` stride-2 convolutions padded to keep
    ceil(n / 2) each time."""
    while factor > 1:
        n = (n + 1) // 2
        factor //= 2
    return n


def encoder_norms(images: int, h: int, w: int) -> List[int]:
    """The sizes of the 15 instance norms a residual encoder with instance
    norm runs over ``images`` images of ``h`` x ``w``: the stem's, four in
    the first stage, five in each of the others (a block's two and the
    downsampling skip's)."""
    out = []
    for i, (ch, n) in enumerate(zip(refs.ENCODER_DIMS, (4, 5, 5))):
        hh, ww = stride_out(h, 2 ** (i + 1)), stride_out(w, 2 ** (i + 1))
        if i == 0:
            out.append(images * ch * hh * ww)
        out += [images * ch * hh * ww] * n
    return out
