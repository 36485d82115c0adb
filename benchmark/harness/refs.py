"""Pieces the plain references share: the parameter lists of the residual
encoders and of the augmentation classifier, those encoders as functions,
the classifier, the sequence loss, and the optimizer step (global-norm
clip, AdamW, the OneCycle learning rate).

Written from the published code (RAFT, ``princeton-vl/RAFT``
``core/extractor.py``; GMFlow, ``haofeixu/gmflow`` ``gmflow/backbone.py``,
``loss.py``; the augmentation classifier of the adjusted trainers) in
plain PyTorch, float32. Nothing here imports the program: the references
take the weights the benchmark made and the inputs it generated, and
compute every step again. ``P`` is a precision from ``precision.py``.
A parameter list is a list of ``(name, shape, init)``; the names are the
published ``state_dict`` keys. ``init`` is one of ``he_normal`` (normal,
std sqrt(2 / fan_out)), ``uniform`` (U(+-1/sqrt(fan_in))), ``xavier``
(U(+-sqrt(6 / (fan_in + fan_out)))), ``zeros``, ``ones``, ``count`` (a
BatchNorm's step count) or ``alias:<name>`` (the same tensor under a
second key, as ``norm3`` and ``downsample.1`` are one module).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Spec = List[Tuple[str, Tuple[int, ...], str]]
ENCODER_DIMS = (64, 96, 128)
ENCODER_STRIDES = (1, 2, 2)


def conv_spec(name: str, cin: int, cout: int, kernel, init: str,
              bias: bool = True) -> Spec:
    """A convolution's kernel and bias; a He-normal kernel's bias is
    zero, a uniform one's uniform."""
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    out = [(f"{name}.weight", (cout, cin, kh, kw), init)]
    if bias:
        out.append((f"{name}.bias", (cout,),
                    "zeros" if init == "he_normal" else init))
    return out


def norm_spec(name: str, planes: int, norm: str) -> Spec:
    if norm != "batch":
        return []
    return [(f"{name}.weight", (planes,), "ones"),
            (f"{name}.bias", (planes,), "zeros"),
            (f"{name}.running_mean", (planes,), "zeros"),
            (f"{name}.running_var", (planes,), "ones"),
            (f"{name}.num_batches_tracked", (), "count")]


def encoder_spec(prefix: str, in_dim: int, output_dim: int, norm: str,
                 conv_bias: bool = True) -> Spec:
    """A residual encoder of six blocks to 1/8 (``BasicEncoder``; GMFlow's
    ``CNNEncoder`` with ``conv_bias=False``, whose block convs and stem have
    no bias and whose norms have no parameters)."""
    spec = conv_spec(f"{prefix}.conv1", in_dim, 64, 7, "he_normal",
                     conv_bias)
    spec += norm_spec(f"{prefix}.norm1", 64, norm)
    cin = ENCODER_DIMS[0]
    for i, (dim, stride) in enumerate(zip(ENCODER_DIMS, ENCODER_STRIDES)):
        for j in (0, 1):
            p = f"{prefix}.layer{i + 1}.{j}"
            blk_in = cin if j == 0 else dim
            spec += conv_spec(f"{p}.conv1", blk_in, dim, 3, "he_normal",
                              conv_bias)
            spec += conv_spec(f"{p}.conv2", dim, dim, 3, "he_normal",
                              conv_bias)
            spec += norm_spec(f"{p}.norm1", dim, norm)
            spec += norm_spec(f"{p}.norm2", dim, norm)
            if j == 0 and (stride != 1 or blk_in != dim):
                n3 = norm_spec(f"{p}.norm3", dim, norm)
                spec += n3
                spec += conv_spec(f"{p}.downsample.0", blk_in, dim, 1,
                                  "he_normal", True)
                spec += [(n.replace(".norm3.", ".downsample.1."), s,
                          f"alias:{n}") for n, s, _ in n3]
        cin = dim
    spec += conv_spec(f"{prefix}.conv2", cin, output_dim, 1, "he_normal",
                      True)
    return spec


def classifier_spec(output_dim: int = 64, classes: int = 4) -> Spec:
    """The augmentation classifier: an encoder over the 2-channel flow with
    BatchNorm, and a linear head (``classify.3``)."""
    return encoder_spec("encoder", 2, output_dim, "batch") + [
        ("classify.3.weight", (classes, output_dim), "uniform"),
        ("classify.3.bias", (classes,), "uniform")]


def _norm(W, name: str, x: torch.Tensor, norm: str) -> torch.Tensor:
    if norm == "instance":
        return F.instance_norm(x, eps=1e-5)
    if norm == "batch":
        # inference form: the running statistics
        mul = torch.rsqrt(W[f"{name}.running_var"] + 1e-5) \
            * W[f"{name}.weight"]
        return (x - W[f"{name}.running_mean"][:, None, None]) \
            * mul[:, None, None] + W[f"{name}.bias"][:, None, None]
    return x


def _conv(P, W, name: str, x, stride: int = 1):
    w = W[f"{name}.weight"]
    kh, kw = w.shape[-2:]
    return P.conv2d(x, w, W.get(f"{name}.bias"), stride,
                    ((kh - 1) // 2, (kw - 1) // 2))


def _block(P, W, p: str, x, norm: str, stride: int):
    y = F.relu(_norm(W, f"{p}.norm1", _conv(P, W, f"{p}.conv1", x, stride),
                     norm))
    y = F.relu(_norm(W, f"{p}.norm2", _conv(P, W, f"{p}.conv2", y), norm))
    if f"{p}.downsample.0.weight" in W:
        x = _norm(W, f"{p}.norm3",
                  _conv(P, W, f"{p}.downsample.0", x, stride), norm)
    return F.relu(x + y)


def encoder(P, W, prefix: str, x: torch.Tensor, norm: str) -> torch.Tensor:
    """NCHW images (or flows) -> NCHW features at 1/8."""
    x = F.relu(_norm(W, f"{prefix}.norm1",
                     _conv(P, W, f"{prefix}.conv1", x, 2), norm))
    for i, stride in enumerate(ENCODER_STRIDES):
        for j in (0, 1):
            x = _block(P, W, f"{prefix}.layer{i + 1}.{j}", x, norm,
                       stride if j == 0 else 1)
    return _conv(P, W, f"{prefix}.conv2", x)


def classifier(P, W, flow: torch.Tensor) -> torch.Tensor:
    """Frozen classifier, inference form: flow ``[B, 2, H, W]`` -> logits
    ``[B, 4]``."""
    x = encoder(P, W, "encoder", flow, "batch")
    x = F.relu(x.mean(dim=(2, 3)))
    return P.linear(x, W["classify.3.weight"], W["classify.3.bias"])


def classifier_loss(logits: torch.Tensor, onehot: torch.Tensor):
    return -torch.mean(torch.sum(onehot * torch.log_softmax(logits, -1), -1))


def sequence_loss(preds: Sequence[torch.Tensor], flow_gt: torch.Tensor,
                  valid: torch.Tensor, gamma: float,
                  max_flow: float = 400.0) -> torch.Tensor:
    """The gamma-weighted L1 over the predictions, masked where the ground
    truth is invalid or longer than ``max_flow``."""
    mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=1))
    mask = ((valid >= 0.5) & (mag < max_flow)).float()[:, None]
    n = len(preds)
    loss = flow_gt.new_zeros(())
    for i, pred in enumerate(preds):
        loss = loss + gamma ** (n - i - 1) * torch.mean(
            mask * torch.abs(pred - flow_gt))
    return loss


def classify_weight(train: dict, step: int) -> float:
    """The classifier loss's weight at ``step``: linear, clamped."""
    w = train["classify_loss_weight_init"] \
        + train["classify_loss_weight_increase"] * step
    return min(max(w, train["min_classify_loss_weight"]),
               train["max_classify_loss_weight"])


def one_cycle_lr(train: dict, count: int) -> float:
    """The learning rate of the ``count``-th update (from 0): a linear
    warm-up from lr/25 over 5% of the horizon, then a cosine to
    lr/25/1e4 (OneCycle, with optax's phase boundary)."""
    lr = train["lr"]
    total = train["num_steps"] + train["schedule_extra_steps"]
    initial = lr / 25.0
    final = initial / 1e4
    warm = max(int(math.floor(0.05 * total)), 1)
    cool = max(total - warm, 1)
    if count < warm:
        return (initial - lr) * (1.0 - count / warm) + lr
    alpha = final / lr
    t = min(count - warm, cool)
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / cool))
                 + alpha)


class Trainer:
    """The recipe's training step on plain tensors: the loss, a global-norm
    clip of the gradients at ``train["grad_clip"]`` (scaled only when the
    norm reaches it), and AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled
    weight decay) at the OneCycle rate. ``loss_fn(params, batch, step) ->
    (loss, extras)``. ``params`` are copied; ``first_grads`` is the first
    step's gradient as the optimizer takes it (after the clip)."""

    def __init__(self, params: Dict[str, torch.Tensor], loss_fn: Callable,
                 train: dict) -> None:
        self.names = list(params)
        self.params = {n: params[n].detach().clone().requires_grad_(True)
                       for n in self.names}
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.loss_fn = loss_fn
        self.train = train
        self.count = 0
        self.first_grads = None

    def step(self, batch: dict):
        names, cur, train = self.names, self.params, self.train
        loss, extra = self.loss_fn(cur, batch, self.count)
        grads = torch.autograd.grad(loss, [cur[n] for n in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(cur[n]) if g is None else g
                 for n, g in zip(names, grads)]
        loss = loss.detach()
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
        if float(norm) >= train["grad_clip"]:
            scale = float(train["grad_clip"] / norm)
            grads = [g * scale for g in grads]
        if self.first_grads is None:
            self.first_grads = {n: g.detach().clone()
                                for n, g in zip(names, grads)}
        lr = one_cycle_lr(train, self.count)
        self.count += 1
        t = self.count
        with torch.no_grad():
            for n, g in zip(names, grads):
                p = cur[n]
                p.mul_(1.0 - lr * train["wdecay"])
                self.m[n].mul_(0.9).add_(g, alpha=0.1)
                self.v[n].mul_(0.999).addcmul_(g, g, value=0.001)
                denom = (self.v[n].sqrt() / math.sqrt(1.0 - 0.999 ** t)
                         ).add_(1e-8)
                p.addcdiv_(self.m[n], denom, value=-lr / (1.0 - 0.9 ** t))
        return loss, extra


def train_steps(params: Dict[str, torch.Tensor], batches: Sequence[dict],
                loss_fn: Callable, train: dict) -> dict:
    """``len(batches)`` steps of :class:`Trainer` from ``params`` (left as
    they are): each step's loss and extras (0-d ones as floats), the first
    step's gradients after the clip, and each leaf's change over all the
    steps."""
    trainer = Trainer(params, loss_fn, train)
    losses, extras = [], []
    for batch in batches:
        loss, extra = trainer.step(batch)
        losses.append(float(loss))
        extras.append({key: float(val) if val.numel() == 1 else val
                       for key, val in extra.items()})
    change = {n: trainer.params[n].detach() - params[n]
              for n in trainer.names}
    return dict(losses=losses, extras=extras,
                first_grads=trainer.first_grads, changes=change)
