"""Training losses and metrics (port of
``opticalflowfromdepth_tpu/train/loss.py``).

:func:`sequence_loss` is the gamma-weighted L1 over the per-iteration
predictions with valid and max-flow masking (`adjusted_RAFT/train.py:
51-76`), with the same metric names as the JAX package: the EPE and both
the accuracy (``kpx_acc``, epe < k) and the outlier rate (``kpx_out``,
epe > k). :func:`classifier_loss` is the cross-entropy of the frozen
classifier on the final prediction (`train.py:196-203`).
:func:`epe_metric` and :func:`fl_all_metric` are the eval metrics (EPE
and KITTI Fl-all over valid pixels). Flows are NCHW ``[B, 2, H, W]``
(the supervision also takes the blocked ``[B, 64, 2, h, w]`` with valid
maps ``[B, 64, h, w]``, ``models/raft.py:block_pixels``: the flow's two
channels are the third axis from the end); every result is an f32 0-d
tensor. :func:`global_metrics` turns one process's metrics into the
whole batch's under data parallelism.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

MAX_FLOW = 400.0  # `train.py:46`
# the metrics that are means over the supervised pixels
MASKED = ("epe", "1px_acc", "3px_acc", "5px_acc", "1px_out", "3px_out",
          "5px_out")


def supervised_mask(flow_gt: torch.Tensor, valid: torch.Tensor,
                    max_flow: float = MAX_FLOW) -> torch.Tensor:
    """``[B, H, W]`` (blocked: ``[B, 64, h, w]``): the pixels the loss
    supervises (valid >= 0.5 and |flow| < max_flow)."""
    mag = torch.sqrt(torch.sum(flow_gt.float() ** 2, dim=flow_gt.dim() - 3))
    return (valid >= 0.5) & (mag < max_flow)


def sequence_loss(flow_preds: Sequence[torch.Tensor], flow_gt: torch.Tensor,
                  valid: torch.Tensor, gamma: float = 0.8,
                  max_flow: float = MAX_FLOW
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """flow_preds: list of ``[B, 2, H, W]``; flow_gt ``[B, 2, H, W]``;
    valid ``[B, H, W]`` (>= 0.5 means supervised); or all three blocked
    (``[B, 64, 2, h, w]``, ``[B, 64, h, w]``)."""
    n = len(flow_preds)
    flow_gt = flow_gt.float()
    cdim = flow_gt.dim() - 3                                 # the channels
    mask = supervised_mask(flow_gt, valid, max_flow)         # [B, H, W]
    maskf = mask.unsqueeze(cdim).float()

    flow_loss = torch.zeros((), device=flow_gt.device)
    for i, pred in enumerate(flow_preds):
        w = gamma ** (n - i - 1)
        flow_loss = flow_loss + w * torch.mean(
            maskf * torch.abs(pred.float() - flow_gt))

    epe_map = torch.sqrt(torch.sum((flow_preds[-1].float() - flow_gt) ** 2,
                                   dim=cdim))
    denom = torch.clamp(mask.float().sum(), min=1.0)

    def masked_mean(x: torch.Tensor) -> torch.Tensor:
        return torch.where(mask, x, torch.zeros((), device=x.device)
                           ).sum() / denom

    epe_map = epe_map.detach()
    metrics = {"epe": masked_mean(epe_map)}
    for k in (1, 3, 5):
        metrics[f"{k}px_acc"] = masked_mean((epe_map < k).float())
    for k in (1, 3, 5):
        metrics[f"{k}px_out"] = masked_mean((epe_map > k).float())
    return flow_loss, metrics


def global_metrics(metrics: Dict[str, torch.Tensor], supervised: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """This process's metrics -> the whole batch's, over the world (one
    all-reduce): the :data:`MASKED` ones as their sums over the summed
    count of supervised pixels (``supervised``, this process's count), the
    rest (the losses, means over equal batches) as means."""
    keys = sorted(metrics)
    count = supervised.float()
    vals = torch.stack([metrics[k].float() * torch.clamp(count, min=1.0)
                        if k in MASKED else metrics[k].float()
                        for k in keys] + [count])
    dist.all_reduce(vals)
    world = dist.get_world_size()
    total = torch.clamp(vals[-1], min=1.0)
    return {k: vals[i] / total if k in MASKED else vals[i] / world
            for i, k in enumerate(keys)}


def classifier_loss(logits: torch.Tensor, label_onehot: torch.Tensor
                    ) -> torch.Tensor:
    """CrossEntropyLoss over soft or one-hot targets (`train.py:168,199`)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(label_onehot * logp, dim=-1))


def _valid_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` where valid > 0.5, over ``max(sum(valid), 1)``."""
    denom = torch.clamp(valid.float().sum(), min=1.0)
    return torch.where(valid > 0.5, x.float(),
                       torch.zeros((), device=x.device)).sum() / denom


def epe_metric(flow_pred: torch.Tensor, flow_gt: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Mean end-point error over valid pixels (eval metric); flows ``[B,
    2, H, W]``, valid ``[B, H, W]``."""
    epe = torch.sqrt(torch.sum((flow_pred.float() - flow_gt.float()) ** 2,
                               dim=1))
    return _valid_mean(epe, valid)


def fl_all_metric(flow_pred: torch.Tensor, flow_gt: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """KITTI Fl-all: 100 * mean(epe > 3 and epe / |gt| > 0.05) over valid
    pixels (`adjusted_RAFT/evaluate.py:152-191`); flows ``[B, 2, H, W]``,
    valid ``[B, H, W]``."""
    flow_gt = flow_gt.float()
    epe = torch.sqrt(torch.sum((flow_pred.float() - flow_gt) ** 2, dim=1))
    mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=1))
    out = (epe > 3.0) & (epe / torch.clamp(mag, min=1e-9) > 0.05)
    return 100.0 * _valid_mean(out, valid)
