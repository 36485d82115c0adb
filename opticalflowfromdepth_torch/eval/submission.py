"""Benchmark submission writers and warm-start interpolation (port of
``opticalflowfromdepth_tpu/eval/submission.py``).

  * :func:`forward_interpolate`: forward-splat the previous frame's flow
    as the next frame's start (scipy ``griddata``, nearest, on the host),
    for RAFT's warm-started Sintel submission
    (`adjusted_RAFT/core/utils/utils.py:26-54`);
  * :func:`create_sintel_submission` (`adjusted_RAFT/evaluate.py:19-50`);
  * :func:`create_kitti_submission` (`adjusted_RAFT/evaluate.py:53-74`).

Both writers take an infer function that returns the flow, or a tuple
whose last entry is the flow. With ``warm_start`` the Sintel writer needs
``(low-res flow, flow)`` and a ``flow_init`` keyword, as RAFT's
``raft_infer_fn(with_low_res=True)`` gives, and refuses a function
without the low-res flow. (The JAX writer unpacks ``(low-res flow,
flow)`` always, so it fails on GMFlow's single output.)
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from ..data import datasets as D
from ..data import frame_io
from .padder import InputPadder


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """[H, W, 2] flow -> the forward-splatted dense flow for a warm
    start."""
    from scipy import interpolate

    dx, dy = flow[..., 0], flow[..., 1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf, dyf = dx.reshape(-1), dy.reshape(-1)
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    if valid.sum() < 4:
        return np.zeros_like(flow)
    pts = (x1[valid], y1[valid])
    flow_x = interpolate.griddata(pts, dxf[valid], (x0, y0),
                                  method="nearest", fill_value=0)
    flow_y = interpolate.griddata(pts, dyf[valid], (x0, y0),
                                  method="nearest", fill_value=0)
    return np.stack([flow_x, flow_y], axis=-1).astype(np.float32)


def create_sintel_submission(infer_fn: Callable, root: str = "datasets",
                             output_path: str = "sintel_submission",
                             warm_start: bool = False,
                             padding_factor: int = 8) -> None:
    """Writes ``<output_path>/<clean|final>/<scene>/frame%04d.flo``, one per
    pair of the test split (`evaluate.py:19-50`). With ``warm_start``
    every frame of a scene after the first starts from the forward-splat
    of the previous pair's low-res flow; a function that returns no
    low-res flow raises ``ValueError``."""
    for dstype in ("clean", "final"):
        ds = D.MpiSintel(split="test", dstype=dstype, root=f"{root}/Sintel")
        flow_prev, sequence_prev = None, None
        for i in range(len(ds)):
            s = ds[i]
            sequence, frame = s["extra_info"]
            if sequence != sequence_prev:
                flow_prev = None
            padder = InputPadder(s["image1"].shape,
                                 padding_factor=padding_factor)
            im1, im2 = padder.pad(s["image1"][None], s["image2"][None])
            kwargs = {}
            if warm_start and flow_prev is not None:
                kwargs["flow_init"] = flow_prev[None]
            out = infer_fn(im1, im2, **kwargs)
            if warm_start and not (isinstance(out, tuple) and len(out) == 2):
                raise ValueError(
                    "warm_start needs an infer function that returns (low-res "
                    "flow, flow), as raft_infer_fn(with_low_res=True) does; "
                    "this one returns no low-res flow")
            flow = out[-1] if isinstance(out, tuple) else out
            flow = padder.unpad(np.asarray(flow))[0]
            if warm_start:
                flow_prev = forward_interpolate(np.asarray(out[0])[0])
            out_dir = os.path.join(output_path, dstype, sequence)
            os.makedirs(out_dir, exist_ok=True)
            frame_io.write_flo(
                os.path.join(out_dir, f"frame{frame + 1:04d}.flo"), flow)
            sequence_prev = sequence


def create_kitti_submission(infer_fn: Callable, root: str = "datasets",
                            output_path: str = "kitti_submission",
                            padding_factor: int = 8) -> None:
    """Writes ``<output_path>/<frame id>.png``, KITTI 16-bit flow for every
    pair of the testing split (`evaluate.py:53-74`)."""
    ds = D.KITTI(split="testing", root=f"{root}/KITTI")
    os.makedirs(output_path, exist_ok=True)
    for i in range(len(ds)):
        s = ds[i]
        (frame_id,) = s["extra_info"]
        padder = InputPadder(s["image1"].shape, mode="kitti",
                             padding_factor=padding_factor)
        im1, im2 = padder.pad(s["image1"][None], s["image2"][None])
        out = infer_fn(im1, im2)
        flow = out[-1] if isinstance(out, tuple) else out
        flow = padder.unpad(np.asarray(flow))[0]
        frame_io.write_flow_kitti(os.path.join(output_path, frame_id), flow)
