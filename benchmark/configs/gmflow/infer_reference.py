"""Plain float32 GMFlow (one scale) as inference cells run it: the forward
of ``reference.py`` from NHWC images to the final flow, with what each
stage made kept for the checks that follow the program stage by stage.
No departure from ``reference.py``, whose docstring names the published
code."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from harness import cell

base = cell.sibling(__file__, "reference")
param_spec = base.param_spec
matching = base.matching
propagation = base.propagation


def final_flow(P, W, cfg: dict, flow: torch.Tensor,
               f0: torch.Tensor) -> torch.Tensor:
    """The propagated flow ``[B, h, w, 2]`` and first features ``[B, h, w,
    C]`` -> the flow at full resolution ``[B, H, W, 2]`` by the learned
    convex mask (``gmflow.py:164-166``)."""
    flow = flow.permute(0, 3, 1, 2)
    feat = torch.cat([flow, f0.permute(0, 3, 1, 2)], 1)
    mask = F.relu(P.conv2d(feat, W["upsampler.0.weight"],
                           W["upsampler.0.bias"], 1, 1))
    mask = P.conv2d(mask, W["upsampler.2.weight"], W["upsampler.2.bias"])
    return base._convex_upsample(flow, mask, cfg["upsample_factor"]) \
        .permute(0, 2, 3, 1)


def infer(P, W, cfg: dict, image1: torch.Tensor, image2: torch.Tensor,
          probe: dict = None) -> torch.Tensor:
    """NHWC images ``[B, H, W, 3]`` in [0, 255] -> the final flow ``[B, H,
    W, 2]``. ``probe`` gets one entry a scale under ``features`` (the
    transformer's output, ``[2B, h, w, C]``), ``matching`` (the matching
    flow that propagation takes) and ``propagated`` (its output)."""
    box = {}
    flow = base.forward(P, W, cfg, image1.permute(0, 3, 1, 2),
                        image2.permute(0, 3, 1, 2), box)[-1]
    if probe is not None:
        probe.update((k, [box[k]]) for k in
                     ("features", "matching", "propagated"))
    return flow.permute(0, 2, 3, 1)
