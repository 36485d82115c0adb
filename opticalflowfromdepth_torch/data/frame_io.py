"""Image and flow file IO for inference: the port's own copies of
``read_image`` and ``write_flo`` from ``opticalflowfromdepth_tpu/data/
frame_io.py`` (numpy + PIL, channel-last float32 arrays)."""

from __future__ import annotations

import numpy as np

TAG_CHAR = np.array([202021.25], np.float32)  # `frame_utils.py:16`


def read_image(path: str) -> np.ndarray:
    """RGB image -> [H, W, 3] float32 in [0, 255] (`utils.py:17-24`)."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32)


def write_flo(path: str, flow: np.ndarray) -> None:
    """[H, W, 2] float32 -> Middlebury .flo (`frame_utils.py:45-65`)."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"write_flo takes [H, W, 2] flow, got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        TAG_CHAR.tofile(f)
        np.asarray([w], np.int32).tofile(f)
        np.asarray([h], np.int32).tofile(f)
        flow.tofile(f)
