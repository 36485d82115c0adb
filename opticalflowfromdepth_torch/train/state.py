"""Train state and checkpoints (port of
``opticalflowfromdepth_tpu/train/state.py``).

The two checkpoint forms of the JAX package, written with ``torch.save``:

* ``latest`` (:func:`save_checkpoint`): the model's ``state_dict``, the
  optimizer's state (AdamW moments and the schedule's count) and the step,
  for a full resume; the schedule is a function of that count, so a
  resumed run continues it where it stopped;
* ``step_<n>_weights`` (:func:`save_weights`): a plain ``state_dict``
  under the reference's key names (BatchNorm running statistics
  included), which ``eval/cli.py:load_state_dict`` loads unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from .optim import Optimizer


@dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), the optimizer
    and the number of steps taken."""
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0


def _path(path: str, name: str) -> str:
    os.makedirs(path, exist_ok=True)
    return os.path.join(os.path.abspath(path), f"{name}.pth")


def save_checkpoint(path: str, state: TrainState, name: str = "latest") -> str:
    """Full checkpoint (model, optimizer, step) at ``path/<name>.pth``."""
    target = _path(path, name)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}, target)
    return target


def save_weights(path: str, model: torch.nn.Module,
                 name: str = "weights") -> str:
    """Weights-only checkpoint: the plain ``state_dict``."""
    target = _path(path, name)
    torch.save(model.state_dict(), target)
    return target


def load_checkpoint(target: str, state: TrainState) -> TrainState:
    """Full resume into ``state`` (in place); returns it."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(target, map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state
