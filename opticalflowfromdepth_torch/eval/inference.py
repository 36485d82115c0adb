"""Directory inference: glob frames -> flow pngs (+ optional ``.flo``,
backward flow and forward-backward occlusion masks).

Port of ``opticalflowfromdepth_tpu/eval/inference.py:inference_on_dir``
(reference `adjusted_gmflow/evaluate.py:835-954`).
"""

from __future__ import annotations

import glob
import os
from typing import Callable

import numpy as np
import torch

from ..data import frame_io
from ..utils.flow_viz import flow_to_color
from .occlusion import forward_backward_consistency_check
from .padder import InputPadder


def inference_on_dir(infer_fn: Callable, inference_dir: str,
                     output_path: str = "output",
                     padding_factor: int = 8,
                     paired_data: bool = False,
                     save_flo_flow: bool = False,
                     pred_bidir_flow: bool = False,
                     fwd_bwd_consistency_check: bool = False) -> int:
    """Run ``infer_fn(image1, image2) -> flow [B, H, W, 2]`` over the
    sorted frames of ``inference_dir`` (consecutive frames, or disjoint
    pairs with ``paired_data``). With ``pred_bidir_flow`` the flow holds
    2B rows (forward, backward; `gmflow.py:115-117`) and the backward flow
    is written too, and with ``fwd_bwd_consistency_check`` both occlusion
    masks. Returns the number of pairs written."""
    if fwd_bwd_consistency_check and not pred_bidir_flow:
        raise ValueError("fwd_bwd_consistency_check needs pred_bidir_flow")
    os.makedirs(output_path, exist_ok=True)
    filenames = sorted(glob.glob(os.path.join(inference_dir, "*.png")) +
                       glob.glob(os.path.join(inference_dir, "*.jpg")))
    if paired_data and len(filenames) % 2:
        raise ValueError(f"paired_data needs an even number of frames, got "
                         f"{len(filenames)} in {inference_dir}")
    stride = 2 if paired_data else 1

    count = 0
    for test_id in range(0, len(filenames) - 1, stride):
        image1 = frame_io.read_image(filenames[test_id])
        image2 = frame_io.read_image(filenames[test_id + 1])
        padder = InputPadder(image1.shape, padding_factor=padding_factor)
        im1, im2 = padder.pad(image1[None], image2[None])
        flow = padder.unpad(np.asarray(infer_fn(im1, im2)))

        base = os.path.join(
            output_path,
            os.path.splitext(os.path.basename(filenames[test_id]))[0])
        _save_png(base + "_flow.png", flow_to_color(flow[0]))
        if save_flo_flow:
            frame_io.write_flo(base + "_pred.flo", flow[0])
        if pred_bidir_flow:
            _save_png(base + "_flow_bwd.png", flow_to_color(flow[1]))
            if fwd_bwd_consistency_check:
                fwd_occ, bwd_occ = forward_backward_consistency_check(
                    torch.from_numpy(np.ascontiguousarray(flow[0:1])),
                    torch.from_numpy(np.ascontiguousarray(flow[1:2])))
                _save_png(base + "_occ.png",
                          (fwd_occ[0].numpy() * 255).astype(np.uint8))
                _save_png(base + "_occ_bwd.png",
                          (bwd_occ[0].numpy() * 255).astype(np.uint8))
        count += 1
    return count


def _save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(arr).save(path)
