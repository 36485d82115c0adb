"""Inference functions for the eval plane (port of
``opticalflowfromdepth_tpu/eval/infer.py``): ``raft_infer_fn`` and
``gmflow_infer_fn``. A call runs in the span ``ofd.infer.call`` of the
trace (``utils/profiling.annotate``), in three stages: ``ofd.infer.upload``
(the images to the card), ``ofd.infer.model`` and ``ofd.sync.download``
(the flow back, which waits for the model's kernels)."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import annotate, spanned


def _to_nchw(a, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(device).permute(0, 3, 1, 2)


def raft_infer_fn(model, iters: int = 24, with_low_res: bool = False,
                  device="cuda") -> Callable:
    """RAFT eval forward (`adjusted_RAFT/evaluate.py:106-113`: iters=24,
    test_mode). The returned ``infer(image1, image2, flow_init=None)``
    takes NHWC ``[B, H, W, 3]`` arrays in [0, 255] (H, W divisible by 8)
    and returns NHWC f32 numpy flow ``[B, H, W, 2]``; with
    ``with_low_res`` the pair (1/8-res flow, flow) for warm starts.
    ``model`` is moved to ``device`` and put in eval mode."""
    device = resolve_device(device)
    model = model.to(device).eval()

    @spanned("ofd.infer.call")
    def infer(image1, image2, flow_init=None):
        with torch.inference_mode():
            with annotate("ofd.infer.upload"):
                fi = None if flow_init is None \
                    else _to_nchw(flow_init, device)
                i1, i2 = _to_nchw(image1, device), _to_nchw(image2, device)
            with annotate("ofd.infer.model"):
                low, up = model(i1, i2, iters=iters, flow_init=fi,
                                test_mode=True)
            with annotate("ofd.sync.download"):
                up = up.permute(0, 2, 3, 1).cpu().numpy()
                if with_low_res:
                    return low.permute(0, 2, 3, 1).cpu().numpy(), up
            return up

    return infer


def gmflow_infer_fn(model, attn_splits_list: Sequence[int] = (2,),
                    corr_radius_list: Sequence[int] = (-1,),
                    prop_radius_list: Sequence[int] = (-1,),
                    pred_bidir_flow: bool = False, device="cuda") -> Callable:
    """GMFlow eval forward (`adjusted_gmflow/evaluate.py` model calls). The
    returned ``infer(image1, image2)`` takes NHWC ``[B, H, W, 3]`` arrays
    in [0, 255] (H/8 and W/8 divisible by the attention splits; pad with
    ``InputPadder``) and returns the final flow as NHWC f32 numpy ``[B, H,
    W, 2]``, ``[2B, ...]`` (forward, then backward) with
    ``pred_bidir_flow``. ``model`` is moved to ``device`` and put in eval
    mode."""
    device = resolve_device(device)
    model = model.to(device).eval()

    @spanned("ofd.infer.call")
    def infer(image1, image2):
        with torch.inference_mode():
            with annotate("ofd.infer.upload"):
                i1, i2 = _to_nchw(image1, device), _to_nchw(image2, device)
            with annotate("ofd.infer.model"):
                out = model(i1, i2, attn_splits_list=tuple(attn_splits_list),
                            corr_radius_list=tuple(corr_radius_list),
                            prop_radius_list=tuple(prop_radius_list),
                            pred_bidir_flow=pred_bidir_flow, training=False)
            with annotate("ofd.sync.download"):
                return out["flow_preds"][-1].permute(0, 2, 3, 1).cpu() \
                    .numpy()

    return infer
