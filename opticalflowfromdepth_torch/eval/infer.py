"""Inference functions for the eval plane (port of
``opticalflowfromdepth_tpu/eval/infer.py:raft_infer_fn``)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device with no card raises
    (the port never carries on on the CPU unless asked to)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for but no CUDA device "
                           "is available; pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return device


def raft_infer_fn(model, iters: int = 24, with_low_res: bool = False,
                  device="cuda") -> Callable:
    """RAFT eval forward (`adjusted_RAFT/evaluate.py:106-113`: iters=24,
    test_mode). The returned ``infer(image1, image2, flow_init=None)``
    takes NHWC ``[B, H, W, 3]`` arrays in [0, 255] (H, W divisible by 8)
    and returns NHWC f32 numpy flow ``[B, H, W, 2]``; with
    ``with_low_res`` the pair (1/8-res flow, flow) for warm starts.
    ``model`` is moved to ``device`` and put in eval mode."""
    device = _resolve_device(device)
    model = model.to(device).eval()

    def _nchw(a) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        return t.to(device).permute(0, 3, 1, 2)

    def infer(image1, image2, flow_init=None):
        with torch.inference_mode():
            fi = None if flow_init is None else _nchw(flow_init)
            low, up = model(_nchw(image1), _nchw(image2), iters=iters,
                            flow_init=fi, test_mode=True)
            up = up.permute(0, 2, 3, 1).cpu().numpy()
            if with_low_res:
                return low.permute(0, 2, 3, 1).cpu().numpy(), up
            return up

    return infer
