"""Validation suites (port of ``opticalflowfromdepth_tpu/eval/
validators.py``): chairs, things, sintel, kitti, kitti12, finetunekitti15.

Model-agnostic: every validator takes ``infer_fn(image1, image2) -> flow``
on NHWC ``[1, H, W, 3]`` float32 arrays (0..255) returning ``[1, H, W,
2]`` float32; ``eval/infer.py``'s ``raft_infer_fn`` and
``gmflow_infer_fn`` are such functions (they run the model on the card
and return host numpy). The metrics are computed on the host in numpy,
as in the JAX package:

  * EPE and the 1 / 3 / 5 px outlier rates (`adjusted_RAFT/evaluate.py:
    117-121`);
  * KITTI Fl-all = 100 * mean(epe > 3 and epe / |gt| > 0.05) over valid
    pixels (`adjusted_RAFT/evaluate.py:152-191`);
  * speed buckets s0-10 / s10-40 / s40+ (`adjusted_gmflow/evaluate.py:
    147-184`);
  * matched / unmatched EPE from Sintel's occlusion maps
    (`adjusted_gmflow/evaluate.py:362-367, 418-426`);
  * inference time: 5 warm-up and ``timing_runs`` timed passes
    (`adjusted_gmflow/evaluate.py:300-352`).
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Dict

import numpy as np

from ..data import datasets as D
from .padder import InputPadder

InferFn = Callable[[np.ndarray, np.ndarray], np.ndarray]


def _epe_map(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    return np.sqrt(np.sum((pred - gt) ** 2, axis=-1))


def _run_padded(infer_fn: InferFn, image1: np.ndarray, image2: np.ndarray,
                mode: str, padding_factor: int) -> np.ndarray:
    padder = InputPadder(image1.shape, mode=mode,
                         padding_factor=padding_factor)
    im1, im2 = padder.pad(image1[None], image2[None])
    flow = np.asarray(infer_fn(im1, im2))
    return padder.unpad(flow)[0]


def in_boundary_mask(flow: np.ndarray) -> np.ndarray:
    """[H, W] mask of gt-flow correspondences landing inside the frame
    (`adjusted_gmflow/utils/utils.py:36-54`). flow: [H, W, 2] (x, y)."""
    h, w = flow.shape[:2]
    xs = np.arange(w, dtype=np.float32)[None, :] + flow[..., 0]
    ys = np.arange(h, dtype=np.float32)[:, None] + flow[..., 1]
    inb = (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
    sane = (np.abs(flow[..., 0]) <= w - 1) & (np.abs(flow[..., 1]) <= h - 1)
    return (inb & sane).astype(np.float32)


def validate_chairs(infer_fn: InferFn, root: str = "datasets",
                    padding_factor: int = 8) -> Dict[str, float]:
    """`adjusted_RAFT/evaluate.py:77-97`."""
    ds = D.FlyingChairs(split="validation",
                        root=f"{root}/FlyingChairs_release/data")
    epes = []
    for i in range(len(ds)):
        s = ds[i]
        flow = _run_padded(infer_fn, s["image1"], s["image2"], "sintel",
                           padding_factor)
        epes.append(_epe_map(flow, s["flow"]).reshape(-1))
    return {"chairs_epe": float(np.mean(np.concatenate(epes)))}


def validate_things(infer_fn: InferFn, root: str = "datasets",
                    dstype: str = "frames_cleanpass",
                    max_samples: int = 1024,
                    padding_factor: int = 8) -> Dict[str, float]:
    """Things TEST subset of 1024 (`adjusted_gmflow/evaluate.py:18-66`,
    the subset sampler `data/datasets.py:219-228`); samples with a flow
    over 400 px are skipped, as the reference does."""
    ds = D.FlyingThings3D(root=f"{root}/FlyingThings3D", dstype=dstype,
                          test_set=True)
    n = len(ds)
    idxs = (np.arange(n) if n <= max_samples else
            np.linspace(0, n - 1, max_samples).astype(int))
    epes = []
    for i in idxs:
        s = ds[int(i)]
        if np.max(np.abs(s["flow"])) > 400:
            continue
        flow = _run_padded(infer_fn, s["image1"], s["image2"], "sintel",
                           padding_factor)
        epes.append(float(_epe_map(flow, s["flow"]).mean()))
    key = "things_clean_epe" if "clean" in dstype else "things_final_epe"
    return {key: float(np.mean(epes))}


def validate_sintel(infer_fn: InferFn, root: str = "datasets",
                    dstype: str = "clean", padding_factor: int = 8,
                    with_speed_metric: bool = False,
                    count_time: bool = False,
                    evaluate_matched_unmatched: bool = False,
                    timing_runs: int = 100) -> Dict[str, float]:
    """`adjusted_RAFT/evaluate.py:100-130`, with the speed buckets and the
    timing of `adjusted_gmflow/evaluate.py:287-430`, and matched /
    unmatched EPE (matched = not occluded and landing inside the frame,
    `adjusted_gmflow/evaluate.py:306, 362-367, 418-426`).

    ``count_time`` runs the first pair 5 times to warm up, then
    ``timing_runs`` times on the host clock: ``inference_time_ms`` is the
    mean, padding and unpadding included. The port's infer functions
    return host numpy, so each timed pass ends in the device-to-host copy
    of its flow, which waits for the card."""
    ds = D.MpiSintel(split="training", dstype=dstype, root=f"{root}/Sintel",
                     load_occlusion=evaluate_matched_unmatched)
    epes = []
    matched, unmatched = [], []
    buckets = {"s0_10": [], "s10_40": [], "s40+": []}
    results: Dict[str, float] = {}

    if count_time and len(ds) > 0:
        s = ds[0]
        for _ in range(5):
            _run_padded(infer_fn, s["image1"], s["image2"], "sintel",
                        padding_factor)
        t0 = time.perf_counter()
        for _ in range(timing_runs):
            _run_padded(infer_fn, s["image1"], s["image2"], "sintel",
                        padding_factor)
        results["inference_time_ms"] = (
            (time.perf_counter() - t0) / timing_runs * 1000.0)

    for i in range(len(ds)):
        s = ds[i]
        flow = _run_padded(infer_fn, s["image1"], s["image2"], "sintel",
                           padding_factor)
        em = _epe_map(flow, s["flow"])
        epes.append(em.reshape(-1))
        if evaluate_matched_unmatched and "occlusion" in s:
            noc_valid = 1.0 - s["occlusion"]  # 1 = not occluded
            m = (noc_valid > 0.5) & (in_boundary_mask(s["flow"]) > 0.5)
            if m.max() > 0:
                matched.append(em[m])
                unmatched.append(em[~m])
        if with_speed_metric:
            mag = np.sqrt(np.sum(s["flow"] ** 2, axis=-1))
            buckets["s0_10"].append(em[mag < 10])
            buckets["s10_40"].append(em[(mag >= 10) & (mag <= 40)])
            buckets["s40+"].append(em[mag > 40])

    all_epe = np.concatenate(epes)
    results[f"sintel_{dstype}_epe"] = float(all_epe.mean())
    results[f"sintel_{dstype}_1px"] = float((all_epe > 1).mean())
    results[f"sintel_{dstype}_3px"] = float((all_epe > 3).mean())
    results[f"sintel_{dstype}_5px"] = float((all_epe > 5).mean())
    if with_speed_metric:
        for k, v in buckets.items():
            vv = np.concatenate(v) if v else np.zeros(0)
            results[f"sintel_{dstype}_{k}"] = (
                float(vv.mean()) if vv.size else 0.0)
    if evaluate_matched_unmatched:
        if matched:
            results[f"sintel_{dstype}_matched"] = float(
                np.concatenate(matched).mean())
            results[f"sintel_{dstype}_unmatched"] = float(
                np.concatenate(unmatched).mean())
        else:
            warnings.warn(
                "evaluate_matched_unmatched requested but no occlusion "
                "data was available; matched/unmatched EPE omitted")
    return results


def _validate_kitti_family(infer_fn: InferFn, ds, prefix: str,
                           padding_factor: int) -> Dict[str, float]:
    """The KITTI metric loop (`adjusted_RAFT/evaluate.py:133-192`): EPE
    over valid pixels averaged per image, Fl-all over all valid pixels."""
    epe_list, out_list = [], []
    for i in range(len(ds)):
        s = ds[i]
        flow = _run_padded(infer_fn, s["image1"], s["image2"], "kitti",
                           padding_factor)
        em = _epe_map(flow, s["flow"])
        mag = np.sqrt(np.sum(s["flow"] ** 2, axis=-1))
        val = s["valid"] >= 0.5
        out = (em > 3.0) & ((em / np.maximum(mag, 1e-9)) > 0.05)
        epe_list.append(em[val].mean())
        out_list.append(out[val])
    epe = float(np.mean(epe_list))
    f1 = 100.0 * float(np.concatenate(out_list).mean())
    return {f"{prefix}_epe": epe, f"{prefix}_f1": f1}


def validate_kitti(infer_fn: InferFn, root: str = "datasets",
                   padding_factor: int = 8) -> Dict[str, float]:
    return _validate_kitti_family(
        infer_fn, D.KITTI(split="training", root=f"{root}/KITTI"),
        "kitti", padding_factor)


def validate_kitti12(infer_fn: InferFn, root: str = "datasets",
                     padding_factor: int = 8) -> Dict[str, float]:
    return _validate_kitti_family(
        infer_fn, D.KITTI12(split="training", root=f"{root}/KITTI12"),
        "kitti12", padding_factor)


def validate_finetunekitti15(infer_fn: InferFn, root: str = "datasets",
                             padding_factor: int = 8) -> Dict[str, float]:
    """The held-out 40 of the 160/40 split (`datasets.py:201-228`)."""
    return _validate_kitti_family(
        infer_fn,
        D.FineTuneKITTI15(split="validation", root=f"{root}/KITTI"),
        "finetunekitti15", padding_factor)


VALIDATORS = {
    "chairs": validate_chairs,
    "things": validate_things,
    "sintel": validate_sintel,
    "kitti": validate_kitti,
    "kitti12": validate_kitti12,
    "finetunekitti15": validate_finetunekitti15,
}
