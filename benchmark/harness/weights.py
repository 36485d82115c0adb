"""Seeded weights on the device, from a reference's parameter list
(``refs.py`` explains the list and its ``init`` kinds)."""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import refs


def _fans(shape):
    if len(shape) == 2:
        return shape[1], shape[0]
    rf = shape[2] * shape[3] if len(shape) == 4 else 1
    return shape[1] * rf, shape[0] * rf


def make(spec: refs.Spec, gen: torch.Generator,
         device) -> Dict[str, torch.Tensor]:
    """Every tensor of ``spec`` in f32 (a BatchNorm's step count in int64)
    on ``device``, drawn from ``gen``: one normal draw for the He-normal
    kernels and one uniform draw for the rest, each cut into the tensors in
    the list's order and scaled by their init."""
    normal = [(n, s) for n, s, i in spec if i == "he_normal"]
    uniform = [(n, s, i) for n, s, i in spec if i in ("uniform", "xavier")]
    size_n = sum(math.prod(s) for _, s in normal)
    size_u = sum(math.prod(s) for _, s, _ in uniform)
    zn = torch.randn(size_n, generator=gen, device=device)
    zu = torch.rand(size_u, generator=gen, device=device) * 2.0 - 1.0
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape in normal:
        n = math.prod(shape)
        std = math.sqrt(2.0 / _fans(shape)[1])
        out[name] = (zn[off:off + n] * std).reshape(shape)
        off += n
    off = 0
    by_name = {n: s for n, s, _ in spec}
    for name, shape, init in uniform:
        n = math.prod(shape)
        if init == "xavier":
            fan_in, fan_out = _fans(shape)
            bound = math.sqrt(6.0 / (fan_in + fan_out))
        else:
            # a bias takes the bound of its layer's kernel
            kernel = by_name.get(name[:-len("bias")] + "weight", shape)
            bound = 1.0 / math.sqrt(_fans(kernel)[0])
        out[name] = (zu[off:off + n] * bound).reshape(shape)
        off += n
    for name, shape, init in spec:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
    for name, _, init in spec:
        if init.startswith("alias:"):
            out[name] = out[init[len("alias:"):]]
    return {name: out[name] for name, _, _ in spec}
