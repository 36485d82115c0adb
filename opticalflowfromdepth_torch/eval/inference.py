"""Directory inference: glob frames -> flow pngs (+ optional ``.flo``).

Port of ``opticalflowfromdepth_tpu/eval/inference.py:inference_on_dir``
(reference `adjusted_gmflow/evaluate.py:835-954`) without the
bidirectional / occlusion branch, which only GMFlow uses.
"""

from __future__ import annotations

import glob
import os
from typing import Callable

import numpy as np

from ..data import frame_io
from ..utils.flow_viz import flow_to_color
from .padder import InputPadder


def inference_on_dir(infer_fn: Callable, inference_dir: str,
                     output_path: str = "output",
                     padding_factor: int = 8,
                     paired_data: bool = False,
                     save_flo_flow: bool = False) -> int:
    """Run ``infer_fn(image1, image2) -> flow [B, H, W, 2]`` over the
    sorted frames of ``inference_dir`` (consecutive frames, or disjoint
    pairs with ``paired_data``). Returns the number of pairs written."""
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
        count += 1
    return count


def _save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(arr).save(path)
