"""Explicit random draws of the synthesis engine (port of
``opticalflowfromdepth_tpu/core/rng.py``).

The JAX package draws every random value of the synthesis from
``jax.random`` keys, which PyTorch cannot repeat bit for bit. So here
every random value is an explicit input: :class:`GroupDraws` for the
5-pair group and :class:`AugmentDraws` for one augmentation. The
samplers draw them on the CPU from an explicit ``torch.Generator``,
with the distributions of the reference's ``utils.get_random`` (`utils.py:
96-100`): a sign of +-1 with p = 0.5 (when signed), times ``U[0, 1) *
range + begin``. Because the draws are made on the CPU, a run on the
card and a run on the CPU with the same seed get the same draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GroupDraws(NamedTuple):
    """The group's draws: the disparity scale ``s`` (f32 scalar) and the
    virtual camera motion, ``axisangle`` [3] and ``translation`` [3]."""
    s: torch.Tensor
    axisangle: torch.Tensor
    translation: torch.Tensor


class AugmentDraws(NamedTuple):
    """One augmentation's draws (f32; batched: each field [B]). Only the
    fields of its type are drawn, the others stay 0: rotate (6) the pivot
    ``cx``, ``cy`` in pixels and ``theta_deg``; shear (7) ``s``;
    brightness (0) ``scale``; channel shift (1) ``channel`` (0, 1 or 2)
    and ``value``; flip (5) and grayscale (2) nothing."""
    cx: torch.Tensor
    cy: torch.Tensor
    theta_deg: torch.Tensor
    s: torch.Tensor
    scale: torch.Tensor
    channel: torch.Tensor
    value: torch.Tensor


def get_random(gen: torch.Generator, random_range, random_begin,
               random_sign: bool = True) -> torch.Tensor:
    """f32 scalar ``sign * (U[0, 1) * random_range + random_begin)``."""
    value = torch.rand((), generator=gen) * random_range + random_begin
    if random_sign:
        sign = torch.randint(0, 2, (), generator=gen).float() * 2.0 - 1.0
        return sign * value
    return value


def draw_group(gen: torch.Generator) -> GroupDraws:
    """The group's draws (`preprocess.py:238-246`, `:211-235`): ``s`` in
    [0.8, 1.1); per axis an angle of pi/36 * [1, 2) and a translation of
    [0.1, 0.2), each signed."""
    s = get_random(gen, 0.3, 0.8, random_sign=False)
    ang = torch.stack([get_random(gen, math.pi * (1.0 / 36.0),
                                  math.pi * (1.0 / 36.0)) for _ in range(3)])
    tr = torch.stack([get_random(gen, 0.1, 0.1) for _ in range(3)])
    return GroupDraws(s, ang, tr)


def draw_augment(gen: torch.Generator, t: int, h: int, w: int
                 ) -> AugmentDraws:
    """The draws of augment type ``t`` for an ``h`` x ``w`` image
    (`preprocess.py:62-99`, `:150-182`): rotate about a pivot
    ``size / 2 +- [size / 2, 3 size / 4)`` by +-[8, 10) degrees; shear
    by +-[0.2, 0.35); brightness x [0, 1); a shift of +-[15, 25) on a
    random channel. Types 3 and 4 raise, as in the JAX package."""
    if t in (3, 4) or not 0 <= t <= 7:
        raise ValueError(f"augment type {t} is not supported (3 and 4 are "
                         "dead branches in the reference)")
    f = dict.fromkeys(AugmentDraws._fields, torch.zeros(()))
    if t == 6:
        f["cx"] = get_random(gen, w / 4.0, w / 2.0) + w / 2.0
        f["cy"] = get_random(gen, h / 4.0, h / 2.0) + h / 2.0
        f["theta_deg"] = get_random(gen, 2.0, 8.0)
    elif t == 7:
        f["s"] = get_random(gen, 0.15, 0.2)
    elif t == 0:
        f["scale"] = get_random(gen, 1.0, 0.0, random_sign=False)
    elif t == 1:
        f["channel"] = torch.randint(0, 3, (), generator=gen).float()
        f["value"] = get_random(gen, 10.0, 15.0)
    return AugmentDraws(**f)


def stack_draws(draws) -> AugmentDraws:
    """A batch of :class:`AugmentDraws` (each field [B])."""
    return AugmentDraws(*(torch.stack(f) for f in zip(*draws)))
