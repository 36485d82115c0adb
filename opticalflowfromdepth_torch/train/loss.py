"""Training losses and metrics (port of
``opticalflowfromdepth_tpu/train/loss.py``).

:func:`sequence_loss` is the gamma-weighted L1 over the per-iteration
predictions with valid and max-flow masking (`adjusted_RAFT/train.py:
51-76`), with the same metric names as the JAX package: the EPE and both
the accuracy (``kpx_acc``, epe < k) and the outlier rate (``kpx_out``,
epe > k). :func:`classifier_loss` is the cross-entropy of the frozen
classifier on the final prediction (`train.py:196-203`). Flows are NCHW
``[B, 2, H, W]``; every result is an f32 0-d tensor.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

MAX_FLOW = 400.0  # `train.py:46`


def sequence_loss(flow_preds: Sequence[torch.Tensor], flow_gt: torch.Tensor,
                  valid: torch.Tensor, gamma: float = 0.8,
                  max_flow: float = MAX_FLOW
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """flow_preds: list of ``[B, 2, H, W]``; flow_gt ``[B, 2, H, W]``;
    valid ``[B, H, W]`` (>= 0.5 means supervised)."""
    n = len(flow_preds)
    flow_gt = flow_gt.float()
    mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=1))
    mask = (valid >= 0.5) & (mag < max_flow)                 # [B, H, W]
    maskf = mask[:, None].float()

    flow_loss = torch.zeros((), device=flow_gt.device)
    for i, pred in enumerate(flow_preds):
        w = gamma ** (n - i - 1)
        flow_loss = flow_loss + w * torch.mean(
            maskf * torch.abs(pred.float() - flow_gt))

    epe_map = torch.sqrt(torch.sum((flow_preds[-1].float() - flow_gt) ** 2,
                                   dim=1))
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


def classifier_loss(logits: torch.Tensor, label_onehot: torch.Tensor
                    ) -> torch.Tensor:
    """CrossEntropyLoss over soft or one-hot targets (`train.py:168,199`)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(label_onehot * logp, dim=-1))
