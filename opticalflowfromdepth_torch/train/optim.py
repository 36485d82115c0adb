"""Learning-rate schedule and optimizer (port of
``opticalflowfromdepth_tpu/train/optim.py``).

The JAX package chains optax's ``clip_by_global_norm`` and ``adamw`` with
a OneCycle schedule. Here:

* :func:`one_cycle_schedule` is a function of the step with optax's
  ``join_schedules`` boundaries (torch's ``OneCycleLR`` places the phase
  change one step elsewhere): warm up linearly from ``lr/25`` to ``lr``
  over ``floor(pct_start * total)`` steps, then anneal to
  ``lr/25/1e4``, linearly or by a cosine;
* :func:`clip_by_global_norm_` scales the gradients by ``max/norm`` only
  when ``norm >= max``, as optax does (``clip_grad_norm_`` divides by
  ``norm + 1e-6`` always), without a host sync;
* :class:`Optimizer` applies the clip and then ``torch.optim.AdamW`` over
  every parameter, biases and BatchNorm scales included, as optax's
  ``adamw`` decays every leaf. Its update ``p - lr * (adam + wd * p)``
  equals optax's. The learning rate of each update is the schedule at the
  number of updates made before it, counted from 0, as optax's
  ``scale_by_schedule`` counts.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List

import torch


def one_cycle_schedule(max_lr: float, total_steps: int,
                       pct_start: float = 0.05, div_factor: float = 25.0,
                       final_div_factor: float = 1e4,
                       anneal_strategy: str = "linear"
                       ) -> Callable[[int], float]:
    """step -> learning rate, as the JAX package's optax schedule."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    warm = max(int(math.floor(pct_start * total_steps)), 1)
    cool = max(total_steps - warm, 1)
    if anneal_strategy not in ("linear", "cos"):
        raise ValueError(anneal_strategy)

    def linear(start: float, end: float, steps: int, t: int) -> float:
        frac = 1.0 - min(max(t, 0), steps) / steps
        return (start - end) * frac + end

    def schedule(step: int) -> float:
        if step < warm:
            return linear(initial, max_lr, warm, step)
        t = step - warm
        if anneal_strategy == "linear":
            return linear(max_lr, final, cool, t)
        alpha = final / max_lr
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(t, cool) / cool))
        return max_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``
    (optax's rule); returns the norm before clipping."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """Global-norm clip + AdamW with a schedule (``make_optimizer``)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], weight_decay: float,
                 epsilon: float = 1e-8, clip: float = 1.0):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.clip = clip
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=schedule(0), betas=(0.9, 0.999), eps=epsilon,
            weight_decay=weight_decay)

    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the gradient
        norm before clipping."""
        for p in self.params:           # optax updates every leaf
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = clip_by_global_norm_(grads, self.clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   num_steps: int, weight_decay: float,
                   epsilon: float = 1e-8, clip: float = 1.0,
                   anneal_strategy: str = "linear",
                   extra_steps: int = 100) -> Optimizer:
    """AdamW + OneCycle + global-norm clip; reference `train.py:83-90,
    205-211`. ``extra_steps`` is the reference's ``num_steps + 100``
    schedule horizon."""
    schedule = one_cycle_schedule(lr, num_steps + extra_steps,
                                  anneal_strategy=anneal_strategy)
    return Optimizer(params, schedule, weight_decay, epsilon, clip)
