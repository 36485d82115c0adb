"""Forward-backward flow consistency occlusion check (port of
``opticalflowfromdepth_tpu/eval/occlusion.py``; reference
`adjusted_gmflow/gmflow/geometry.py:75-96`, UnFlow thresholds alpha=0.01,
beta=0.5)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.sampling import flow_warp


def forward_backward_consistency_check(
        fwd_flow: torch.Tensor, bwd_flow: torch.Tensor, alpha: float = 0.01,
        beta: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """fwd/bwd flow ``[B, H, W, 2]`` -> (fwd_occ, bwd_occ) ``[B, H, W]``
    f32, 1 where a pixel fails the check."""
    mag = fwd_flow.norm(dim=-1) + bwd_flow.norm(dim=-1)

    def warp(feat, flow):
        return flow_warp(feat.permute(0, 3, 1, 2),
                         flow.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    diff_fwd = (fwd_flow + warp(bwd_flow, fwd_flow)).norm(dim=-1)
    diff_bwd = (bwd_flow + warp(fwd_flow, bwd_flow)).norm(dim=-1)
    threshold = alpha * mag + beta
    return (diff_fwd > threshold).float(), (diff_bwd > threshold).float()
