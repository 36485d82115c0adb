"""Auxiliary-classifier training (port of
``opticalflowfromdepth_tpu/train/classifier_train.py``).

The reference ships only a frozen checkpoint and its hyperparameters
(`README.md:113-114`); this trains the classifier from synthesized flow
maps: cross-entropy over the 4 classes {none, flip, rotate, shear}, the
labels from the shard schema (`dataloader.py:154-157`: ``max(0,
augment_type - 4)``). It learns to tell the augmentation from the flow
field, the signal that later regularizes the flow estimators
(`adjusted_RAFT/train.py:196-203`).

The optimizer is the flow trainers': a global-norm clip and AdamW with
the OneCycle-cosine schedule over ``num_steps + 100``
(``train/optim.py:make_optimizer``). Dropout draws from the
``torch.Generator`` the step is given. ``state.save_weights(dir,
state.model)`` writes a ``state_dict`` under the reference's names, which
the training CLI's ``--classifier_ckpt`` loads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.classifier import Classifier
from ..models.layers import init_weights_
from ..utils.device import resolve_device
from .loss import classifier_loss
from .optim import make_optimizer
from .state import TrainState


@dataclass(frozen=True)
class ClassifierTrainConfig:
    lr: float = 1e-4
    num_steps: int = 20000
    batch_size: int = 32
    image_size: Tuple[int, int] = (320, 448)
    wdecay: float = 1e-5
    clip: float = 1.0
    output_dim: int = 64
    dropout: float = 0.1
    use_small: bool = False
    mixed_precision: bool = True


def build_model(cfg: ClassifierTrainConfig) -> Classifier:
    dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
    return Classifier(output_dim=cfg.output_dim, dropout=cfg.dropout,
                      use_small=cfg.use_small, dtype=dtype)


def init_state(cfg: ClassifierTrainConfig, seed: int = 0,
               device="cuda") -> TrainState:
    """A classifier with the reference's random init drawn from ``seed``,
    on ``device``, and its optimizer at step 0."""
    model = build_model(cfg)
    init_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(resolve_device(device))
    opt = make_optimizer(model.parameters(), cfg.lr, cfg.num_steps,
                         cfg.wdecay, clip=cfg.clip, anneal_strategy="cos")
    return TrainState(model, opt, 0)


def _metrics(logits: torch.Tensor, label: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    loss = classifier_loss(logits, label)
    acc = (logits.argmax(-1) == label.argmax(-1)).float().mean()
    return {"loss": loss, "accuracy": acc}


def make_train_step(cfg: ClassifierTrainConfig) -> Callable:
    """Returns ``train_step(state, batch, generator) -> (state,
    metrics)``; it updates ``state`` in place. batch: ``flow`` ``[B, 2, H,
    W]`` and ``label`` ``[B, 4]`` on the model's device (as
    ``data.loader.to_device`` makes them); ``generator`` draws the
    dropout masks. The metrics (``loss``, ``accuracy``) are 0-d tensors."""
    del cfg

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        logits = state.model(batch["flow"], train=True, generator=generator)
        metrics = _metrics(logits, batch["label"])
        state.optimizer.zero_grad()
        metrics["loss"].backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(cfg: ClassifierTrainConfig) -> Callable:
    """Returns ``eval_step(state, batch) -> {"accuracy", "loss"}``: the
    classifier in inference mode (running BatchNorm statistics, no
    dropout)."""
    del cfg

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        return _metrics(state.model(batch["flow"], train=False),
                        batch["label"])

    return eval_step
