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

The JAX package's scheduling options build and train as there, with
JAX's numbers: ``remat`` ("none", "dots", "full"; ``models/raft.py``),
``unroll`` (an int >= 0, 0 meaning every iteration; kept on the model,
the eager loop runs one iteration at a time) and ``blocked_supervision``
(the basic model returns its flows blocked, ``[B, 64, 2, h, w]``; the
step blocks the ground truth and the valid map once, runs the loss on the
blocked flows and hands the classifier the unblocked final flow), e.g.
``RAFTTrainConfig(remat="dots", unroll=4, blocked_supervision=True)``.

The step runs in the span ``ofd.train.step`` (``utils/profiling.
annotate``), its stages in ``ofd.train.forward``, ``.loss``, ``.backward``,
``.allreduce`` (data parallel only) and ``.optimizer``.

A ``parallel.mesh.ProcessMesh`` made over a process group makes the step
data parallel, each rank on its part of the batch, and the step what the
JAX one computes on the whole batch: the gradients averaged over the
world before the clip, the logged metrics the whole batch's, the batch
norm's statistics the whole batch's (``models.layers.BatchNorm.group``),
and the noise each rank adds its rows of the noise drawn for the whole
batch (every rank's generator is seeded alike).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.classifier import Classifier
from ..models.layers import BatchNorm
from ..models.raft import RAFT, block_pixels, unblock_pixels
from ..parallel.mesh import ProcessMesh, all_reduce_mean_
from ..utils.device import resolve_device
from ..utils.profiling import annotate, spanned
from .loss import (classifier_loss, global_metrics, sequence_loss,
                   supervised_mask)
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
    # "none", "dots" or "full" (models/raft.py:RAFT.remat)
    remat: str = "none"
    # the JAX scan's unroll factor, 0 = every iteration; the eager loop
    # runs one iteration at a time whatever it is (models/raft.py)
    unroll: int = 1
    # "fused": the CUDA lookup and its backward on the card
    corr_impl: str = "fused"
    # supervise in the blocked [B, 64, 2, h, w] layout (basic model only;
    # the ground truth blocked once a step)
    blocked_supervision: bool = False


def _blocked(cfg: RAFTTrainConfig) -> bool:
    return cfg.blocked_supervision and not cfg.small


def build_model(cfg: RAFTTrainConfig,
                generator: Optional[torch.Generator] = None,
                mesh: Optional[ProcessMesh] = None) -> RAFT:
    """The model of ``cfg``; with a ``mesh`` made over a process group its
    batch norms take the whole batch's statistics."""
    if cfg.dropout > 0 and mesh is not None and mesh.data_world > 1:
        raise ValueError("dropout with data parallelism is not ported: each "
                         "rank would draw its own mask, not its rows of the "
                         "whole batch's")
    dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
    model = RAFT(small=cfg.small, dropout=cfg.dropout, dtype=dtype,
                 remat=cfg.remat, corr_impl=cfg.corr_impl,
                 unroll=cfg.iters if cfg.unroll == 0 else cfg.unroll,
                 blocked_supervision=_blocked(cfg), generator=generator)
    if mesh is not None and mesh.distributed:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.group = torch.distributed.group.WORLD
    return model


def init_state(cfg: RAFTTrainConfig, seed: int = 0, device="cuda",
               mesh: Optional[ProcessMesh] = None) -> TrainState:
    """A model with the reference's random init drawn from ``seed`` (the
    same on every rank), on ``device``, and its optimizer at step 0."""
    model = build_model(cfg, torch.Generator().manual_seed(seed), mesh)
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
                    classifier: Optional[Classifier] = None, device="cuda",
                    mesh: Optional[ProcessMesh] = None) -> Callable:
    """Returns ``train_step(state, batch, generator) -> (state,
    metrics)``; it updates ``state`` in place.

    batch: NCHW tensors on ``device``: image1/image2 ``[B, 3, H, W]``
    (0..255), flow ``[B, 2, H, W]``, valid ``[B, H, W]``, label ``[B, 4]``
    (``data.loader.to_device`` makes them). The metrics are 0-d tensors
    on the device. ``classifier`` is frozen: its weights get no gradient,
    and the flow gets the gradient of its loss. With a ``mesh`` made over
    a process group the step is data parallel (module docstring):
    ``batch`` is this rank's part of the batch, and ``state`` comes from
    ``init_state`` with the same mesh."""
    device = resolve_device(device)
    if classifier is not None:
        classifier = classifier.to(device).eval().requires_grad_(False)
    data_parallel = mesh is not None and mesh.distributed
    rank, world = (mesh.data_rank, mesh.data_world) if data_parallel \
        else (0, 1)

    @spanned("ofd.train.step")
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        image1, image2 = batch["image1"], batch["image2"]
        if cfg.add_noise:
            gdev = generator.device
            stdv = torch.rand((), generator=generator, device=gdev) * 5.0
            b = image1.shape[0]
            whole = (b * world,) + tuple(image1.shape[1:])
            noise = [torch.randn(whole, generator=generator,
                                 device=gdev)[rank * b:(rank + 1) * b]
                     for _ in range(2)]
            image1 = torch.clamp(image1 + (stdv * noise[0]).to(device),
                                 0.0, 255.0)
            image2 = torch.clamp(image2 + (stdv * noise[1]).to(device),
                                 0.0, 255.0)

        with annotate("ofd.train.forward"):
            flow_preds = state.model(image1, image2, iters=cfg.iters,
                                     train=not cfg.freeze_bn,
                                     generator=generator)
        with annotate("ofd.train.loss"):
            flow_gt, valid = batch["flow"], batch["valid"]
            if _blocked(cfg):
                flow_gt, valid = block_pixels(flow_gt), block_pixels(valid)
            loss, metrics = sequence_loss(flow_preds, flow_gt, valid,
                                          cfg.gamma)
            if cfg.add_classifier and classifier is not None:
                final = flow_preds[-1]
                if _blocked(cfg):
                    final = unblock_pixels(final)
                logits = classifier(final, train=False)
                c_loss = classifier_loss(logits, batch["label"])
                metrics["classify_loss"] = c_loss.detach()
                loss = loss + c_loss * classify_weight_at(cfg, state.step)
            metrics["total_loss"] = loss.detach()

        with annotate("ofd.train.backward"):
            state.optimizer.zero_grad()
            loss.backward()
        if data_parallel:
            with annotate("ofd.train.allreduce"):
                all_reduce_mean_(state.optimizer.grads())
                metrics = global_metrics(metrics, supervised_mask(
                    batch["flow"], batch["valid"]).sum())
        with annotate("ofd.train.optimizer"):
            state.optimizer.step()
        state.step += 1
        return state, metrics

    return train_step
