"""RAFT training step (port of
``opticalflowfromdepth_tpu/train/raft_train.py``).

One step of the reference recipe (`adjusted_RAFT/train.py:140-271`):
the gamma-weighted sequence loss, optional Gaussian image noise with
stdv ~ U[0, 5] (`train.py:188-191`), the frozen classifier's
cross-entropy on the final prediction with a linearly annealed, clamped
weight (`train.py:196-203`), a global-norm clip and AdamW with the
OneCycle-linear schedule. ``freeze_bn`` makes the context encoder's
BatchNorm use its running statistics (`train.py:152-153`). Where JAX
takes a key, the step takes a ``torch.Generator`` (noise and dropout).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.classifier import Classifier
from ..models.raft import RAFT
from ..utils.device import resolve_device
from .loss import classifier_loss, sequence_loss
from .optim import make_optimizer
from .state import TrainState


@dataclass(frozen=True)
class RAFTTrainConfig:
    lr: float = 2.5e-4
    num_steps: int = 100000
    batch_size: int = 6
    image_size: Tuple[int, int] = (368, 496)
    iters: int = 12
    wdecay: float = 5e-5
    epsilon: float = 1e-8
    clip: float = 1.0
    gamma: float = 0.8
    dropout: float = 0.0
    small: bool = False
    mixed_precision: bool = True
    add_noise: bool = False
    freeze_bn: bool = False          # set for non-first stages
    # classifier-regularizer schedule (`train.py:299-305`)
    add_classifier: bool = False
    classify_loss_weight_init: float = 1.0
    classify_loss_weight_increase: float = -2e-5
    max_classify_loss_weight: float = 1.0
    min_classify_loss_weight: float = 0.0
    # "none" or "full" (models/raft.py:RAFT.remat); "dots" is not ported
    remat: str = "none"
    # the JAX scan's unroll factor; the eager loop runs one iteration at a
    # time, so only 1 is accepted
    unroll: int = 1
    # "fused": the CUDA lookup and its backward on the card
    corr_impl: str = "fused"
    # not ported: supervision in the blocked layout
    blocked_supervision: bool = False


def build_model(cfg: RAFTTrainConfig,
                generator: Optional[torch.Generator] = None) -> RAFT:
    if cfg.blocked_supervision:
        raise ValueError("blocked_supervision is not ported; the port "
                         "supervises at full resolution")
    if cfg.unroll != 1:
        raise ValueError(f"unroll={cfg.unroll} is not ported; the GRU loop "
                         "runs one iteration at a time (unroll=1)")
    dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
    return RAFT(small=cfg.small, dropout=cfg.dropout, dtype=dtype,
                remat=cfg.remat, corr_impl=cfg.corr_impl,
                generator=generator)


def init_state(cfg: RAFTTrainConfig, seed: int = 0,
               device="cuda") -> TrainState:
    """A model with the reference's random init drawn from ``seed``, on
    ``device``, and its optimizer at step 0."""
    model = build_model(cfg, torch.Generator().manual_seed(seed))
    model = model.to(resolve_device(device))
    opt = make_optimizer(model.parameters(), cfg.lr, cfg.num_steps,
                         cfg.wdecay, cfg.epsilon, cfg.clip,
                         anneal_strategy="linear")
    return TrainState(model, opt, 0)


def classify_weight_at(cfg: RAFTTrainConfig, step: int) -> float:
    """Linearly annealed, clamped classifier-loss weight (`train.py:
    200-203`)."""
    w = cfg.classify_loss_weight_init \
        + cfg.classify_loss_weight_increase * float(step)
    return min(max(w, cfg.min_classify_loss_weight),
               cfg.max_classify_loss_weight)


def make_train_step(cfg: RAFTTrainConfig,
                    classifier: Optional[Classifier] = None, device="cuda"
                    ) -> Callable:
    """Returns ``train_step(state, batch, generator) -> (state,
    metrics)``; it updates ``state`` in place.

    batch: NCHW tensors on ``device``: image1/image2 ``[B, 3, H, W]``
    (0..255), flow ``[B, 2, H, W]``, valid ``[B, H, W]``, label ``[B, 4]``
    (``data.loader.to_device`` makes them). The metrics are 0-d tensors
    on the device. ``classifier`` is frozen: its weights get no gradient,
    and the flow gets the gradient of its loss."""
    device = resolve_device(device)
    if classifier is not None:
        classifier = classifier.to(device).eval().requires_grad_(False)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        image1, image2 = batch["image1"], batch["image2"]
        if cfg.add_noise:
            gdev = generator.device
            stdv = torch.rand((), generator=generator, device=gdev) * 5.0
            noise = [torch.randn(image1.shape, generator=generator,
                                 device=gdev) for _ in range(2)]
            image1 = torch.clamp(image1 + (stdv * noise[0]).to(device),
                                 0.0, 255.0)
            image2 = torch.clamp(image2 + (stdv * noise[1]).to(device),
                                 0.0, 255.0)

        flow_preds = state.model(image1, image2, iters=cfg.iters,
                                 train=not cfg.freeze_bn, generator=generator)
        loss, metrics = sequence_loss(flow_preds, batch["flow"],
                                      batch["valid"], cfg.gamma)
        if cfg.add_classifier and classifier is not None:
            logits = classifier(flow_preds[-1], train=False)
            c_loss = classifier_loss(logits, batch["label"])
            metrics["classify_loss"] = c_loss.detach()
            loss = loss + c_loss * classify_weight_at(cfg, state.step)
        metrics["total_loss"] = loss.detach()

        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return train_step
