"""The general generator of inputs: what a traffic file describes, made
on the device from the run's seed.

Pairs are smooth random images in [0, 255] (a coarse random field
resized to the frame, plus a finer one), the second image the first one
warped by a smooth random flow of up to ``motion_px`` pixels, so a pair
holds motion that its flow describes. A training batch adds that flow as
the ground truth, a valid map with ``invalid_share`` of its pixels off,
and a one-hot label over ``classes``. The same seed gives the same pool.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F


def _field(gen, n, ch, h, w, cell, device) -> torch.Tensor:
    """``[n, ch, h, w]`` in [0, 1): uniform noise on a grid of ``cell``
    pixels, resized bilinearly to the frame."""
    coarse = torch.rand(n, ch, h // cell + 2, w // cell + 2, generator=gen,
                        device=device)
    return F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=True)


def pairs(gen: torch.Generator, n: int, h: int, w: int, motion_px: float,
          device) -> Dict[str, torch.Tensor]:
    """``n`` pairs: image1, image2 ``[n, 3, h, w]`` f32 in [0, 255] and the
    flow ``[n, 2, h, w]`` that carries image1 onto image2."""
    img = 0.7 * _field(gen, n, 3, h, w, 32, device) \
        + 0.3 * _field(gen, n, 3, h, w, 4, device)
    flow = (_field(gen, n, 2, h, w, 64, device) * 2.0 - 1.0) * motion_px
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32),
                            indexing="ij")
    # image2(x + flow(x)) ~ image1(x): sample image1 at x - flow
    gx = 2.0 * (xs - flow[:, 0]) / (w - 1) - 1.0
    gy = 2.0 * (ys - flow[:, 1]) / (h - 1) - 1.0
    img2 = F.grid_sample(img, torch.stack([gx, gy], -1), mode="bilinear",
                         padding_mode="border", align_corners=True)
    return dict(image1=img * 255.0, image2=img2 * 255.0, flow=flow)


def train_pool(traffic: dict, gen: torch.Generator,
               device) -> List[Dict[str, torch.Tensor]]:
    """``traffic["pool"]`` training batches on the device, NCHW as the
    train steps take them (image1, image2, flow, valid, label)."""
    b, h, w = traffic["batch"], traffic["height"], traffic["width"]
    out = []
    for _ in range(traffic["pool"]):
        batch = pairs(gen, b, h, w, traffic["motion_px"], device)
        batch["valid"] = (torch.rand(b, h, w, generator=gen, device=device)
                          >= traffic["invalid_share"]).float()
        cls = torch.randint(traffic["classes"], (b,), generator=gen,
                            device=device)
        batch["label"] = F.one_hot(cls, traffic["classes"]).float()
        out.append(batch)
    return out


def sintel_pad(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Edge-replicate NHWC frames to a multiple of ``factor``, the padding
    centred (the evaluation's Sintel mode)."""
    h, w = x.shape[1:3]
    ph = (((h // factor) + 1) * factor - h) % factor
    pw = (((w // factor) + 1) * factor - w) % factor
    x = x.permute(0, 3, 1, 2)
    x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
              mode="replicate")
    return x.permute(0, 2, 3, 1)


def infer_pool(traffic: dict, gen: torch.Generator, device) -> List[tuple]:
    """``traffic["pool"]`` calls' inputs as the caller holds them: NHWC
    f32 numpy pairs on the host, padded for the model."""
    b, h, w = traffic["batch"], traffic["height"], traffic["width"]
    out = []
    for _ in range(traffic["pool"]):
        p = pairs(gen, b, h, w, traffic["motion_px"], device)
        i1, i2 = (sintel_pad(p[k].permute(0, 2, 3, 1), traffic["pad_factor"])
                  .contiguous().cpu().numpy() for k in ("image1", "image2"))
        out.append((i1, i2))
    return out
