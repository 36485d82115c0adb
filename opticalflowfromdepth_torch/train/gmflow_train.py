"""GMFlow training step (port of
``opticalflowfromdepth_tpu/train/gmflow_train.py``).

One step of the reference recipe (`adjusted_gmflow/main.py:133-659`):
the gamma = 0.9 sequence loss over the per-scale predictions
(`loss.py:4-37`), the frozen classifier's cross-entropy on the final
prediction with a linearly annealed, clamped weight (`main.py:465-472`),
a global-norm clip and AdamW with the OneCycle-cosine schedule
(`main.py:230-231, 425-432, 489`), and the NaN-loss skip
(`main.py:474-478`): a step whose loss is not finite leaves the
parameters, the Adam moments and the step count as they were.

Every softmax of the model goes through ``ops.flash.flash_softmax_matmul``
and its autograd Function: on the card the forward kernel and the two
backward kernels, on the CPU their plain versions.

The step runs in the span ``ofd.train.step`` of the trace
(``utils/profiling.annotate``; its autograd graph is freed inside it), each
stage in its own: ``ofd.train.forward``, ``.loss``, ``.backward``,
``.allreduce`` (data parallel only) and ``.optimizer``, and the host's two
waits on the card, ``ofd.sync.nan_check`` and ``ofd.sync.skip_flag``.

Parallelism comes from a ``parallel.mesh.ProcessMesh`` (the JAX
``mesh``): ``model_parallel > 1`` splits matching, full attention,
propagation and the Swin windows over its model group (a process group,
or a ``LocalRing`` run in turn), and raises without one of that size. A
mesh made over a process group (``make_mesh``) makes the step data
parallel: the gradients are averaged over the world before the clip, the
logged metrics are the whole batch's, and the NaN skip is decided on the
whole batch's loss, so every rank skips or none does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..eval.infer import gmflow_infer_fn
from ..models.classifier import Classifier
from ..models.gmflow import GMFlow
from ..parallel.mesh import ProcessMesh, all_reduce_mean_
from ..utils.device import resolve_device
from ..utils.profiling import annotate, spanned
from .loss import (classifier_loss, global_metrics, sequence_loss,
                   supervised_mask)
from .optim import make_optimizer
# the classifier weight's schedule (`main.py:465-470`) is RAFT's
from .raft_train import classify_weight_at
from .state import TrainState


@dataclass(frozen=True)
class GMFlowTrainConfig:
    lr: float = 4e-4
    num_steps: int = 100000
    batch_size: int = 16
    image_size: Tuple[int, int] = (368, 560)
    wdecay: float = 1e-4
    grad_clip: float = 1.0
    gamma: float = 0.9
    # model shape (`main.py:38-52`)
    num_scales: int = 1
    feature_channels: int = 128
    upsample_factor: int = 8
    num_transformer_layers: int = 6
    ffn_dim_expansion: int = 4
    attn_splits_list: Tuple[int, ...] = (2,)
    corr_radius_list: Tuple[int, ...] = (-1,)
    prop_radius_list: Tuple[int, ...] = (-1,)
    mixed_precision: bool = True
    # sequence parallelism: > 1 splits the token axis of matching,
    # attention and propagation over the mesh's model group, which must
    # have this many ranks (build_model / init_state take the mesh)
    model_parallel: int = 1
    # classifier-regularizer schedule (`main.py:125-128`)
    add_classifier: bool = False
    classify_loss_weight_init: float = 1.0
    classify_loss_weight_increase: float = -2e-5
    max_classify_loss_weight: float = 1.0
    min_classify_loss_weight: float = 0.0


def build_model(cfg: GMFlowTrainConfig,
                generator: Optional[torch.Generator] = None,
                mesh: Optional[ProcessMesh] = None) -> GMFlow:
    """The model of ``cfg``; with ``model_parallel > 1`` split over the
    model group of ``mesh``, which must have that many ranks."""
    group = None
    if cfg.model_parallel > 1:
        have = 1 if mesh is None else mesh.model_parallel
        if have != cfg.model_parallel:
            raise ValueError(
                f"model_parallel={cfg.model_parallel} over a model group of "
                f"{have} rank(s) is not ported: pass a mesh whose model "
                f"group has {cfg.model_parallel} (parallel.mesh.make_mesh "
                f"over a process group, or ProcessMesh.local)")
        group = mesh.model_group
    dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
    return GMFlow(num_scales=cfg.num_scales,
                  upsample_factor=cfg.upsample_factor,
                  feature_channels=cfg.feature_channels,
                  num_transformer_layers=cfg.num_transformer_layers,
                  ffn_dim_expansion=cfg.ffn_dim_expansion, dtype=dtype,
                  generator=generator, group=group)


def init_state(cfg: GMFlowTrainConfig, seed: int = 0, device="cuda",
               mesh: Optional[ProcessMesh] = None) -> TrainState:
    """A model with the reference's random init drawn from ``seed`` (the
    same on every rank), on ``device``, and its optimizer at step 0
    (AdamW + OneCycle-cosine, ``wdecay``, clip ``grad_clip``; `cli.py:
    149-150` of the JAX package)."""
    model = build_model(cfg, torch.Generator().manual_seed(seed), mesh)
    model = model.to(resolve_device(device))
    opt = make_optimizer(model.parameters(), cfg.lr, cfg.num_steps,
                         cfg.wdecay, clip=cfg.grad_clip,
                         anneal_strategy="cos")
    return TrainState(model, opt, 0)


def make_train_step(cfg: GMFlowTrainConfig,
                    classifier: Optional[Classifier] = None, device="cuda",
                    mesh: Optional[ProcessMesh] = None) -> Callable:
    """Returns ``train_step(state, batch, generator) -> (state,
    metrics)``; it updates ``state`` in place. ``generator`` is taken for
    the runner's signature and not drawn from: the GMFlow recipe has no
    noise or dropout.

    batch: NCHW tensors on ``device`` as ``data.loader.to_device`` makes
    them. The metrics are 0-d tensors on the device, ``skipped_nan`` among
    them (1.0 when the step was skipped). ``classifier`` is frozen: its
    weights get no gradient, and the flow gets the gradient of its loss.
    With a ``mesh`` made over a process group the step is data parallel
    (module docstring): ``batch`` is this rank's part of the batch.

    The NaN skip reads the loss on the host (one sync per step, after the
    backward has been queued): with ``Optimizer.step`` not called, nothing
    is updated, which keeps the moments, the schedule's count and the
    parameters exactly as they were. An on-device select over every
    parameter and moment (the JAX form) would avoid the sync but run an
    extra pass over the whole state each step, and the runner already
    waits for the metrics every step when it logs them."""
    device = resolve_device(device)
    if classifier is not None:
        classifier = classifier.to(device).eval().requires_grad_(False)
    data_parallel = mesh is not None and mesh.distributed
    recipe = dict(attn_splits_list=tuple(cfg.attn_splits_list),
                  corr_radius_list=tuple(cfg.corr_radius_list),
                  prop_radius_list=tuple(cfg.prop_radius_list))

    @spanned("ofd.train.step")
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        del generator
        with annotate("ofd.train.forward"):
            preds = state.model(batch["image1"], batch["image2"], **recipe,
                                training=True)["flow_preds"]
        with annotate("ofd.train.loss"):
            loss, metrics = sequence_loss(preds, batch["flow"],
                                          batch["valid"], cfg.gamma)
            if cfg.add_classifier and classifier is not None:
                logits = classifier(preds[-1], train=False)
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
        with annotate("ofd.sync.nan_check"):
            ok = bool(torch.isfinite(metrics["total_loss"]))
        with annotate("ofd.train.optimizer"):
            if ok:
                state.optimizer.step()
                state.step += 1
            else:
                state.optimizer.zero_grad()
        # a blocking upload: the host waits here for the optimizer's kernels
        with annotate("ofd.sync.skip_flag"):
            metrics["skipped_nan"] = torch.tensor(0.0 if ok else 1.0,
                                                  device=loss.device)
        return state, metrics

    return train_step


def infer_fn_factory(cfg: GMFlowTrainConfig, device="cuda") -> Callable:
    """``state -> infer`` for ``TrainRunner(infer_fn_factory=...)``: the
    trained weights served through ``gmflow_infer_fn`` with the config's
    recipe (the JAX training CLI's factory)."""
    def factory(state: TrainState) -> Callable:
        return gmflow_infer_fn(state.model, cfg.attn_splits_list,
                               cfg.corr_radius_list, cfg.prop_radius_list,
                               device=device)
    return factory
