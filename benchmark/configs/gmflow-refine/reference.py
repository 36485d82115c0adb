"""Plain float32 GMFlow with refinement: two scales, global matching and
propagation over Swin windows of 2x2 at 1/8, then local matching and
propagation over windows of 8x8 at 1/4 on the second frame's features
warped by the flow so far, and the convex upsampler at factor 4.

Written from the published code, ``haofeixu/gmflow``: ``gmflow/gmflow.py``
(the forward, lines 92-170), ``backbone.py`` (a stride-1 ``layer3`` when
there are two scales), ``trident_conv.py`` (one 3x3 kernel at strides 1 and
2), ``matching.py:39-83`` (local matching), ``transformer.py:325-409``
(local propagation) and ``geometry.py`` (``flow_warp``). The position
embedding, the window split and merge, the transformer, global matching
and propagation and the convex upsampler are ``configs/gmflow/
reference.py``'s (the last through ``infer_reference.py:final_flow``).
Plain PyTorch, no program code.

Departures from the published code, none of which changes the function:

- local matching takes the window of the second features by zero-padded
  shifts (``F.unfold``) where upstream samples it with ``grid_sample`` at
  integer offsets (the same values), and forms the flow as the softmax's
  expectation of the window's offsets where upstream takes that of the
  sample coordinates and subtracts the pixel grid (the same sum, since the
  probabilities add up to 1, without rounding coordinates of up to 255 in
  a low precision);
- both local passes run one batch entry at a time, so the windows of a
  Sintel-size batch fit on the card;
- the trident kernel is drawn He-normal (fan-out), as the program's
  initialiser draws it, where upstream draws it He-uniform: the same
  variance.

``cfg`` is the configuration file's dict; ``W`` maps the published
``state_dict`` names to tensors; ``P`` is a precision
(``harness/precision.py``).
"""

from __future__ import annotations

import pathlib

import torch
import torch.nn.functional as F

from harness import cell, refs

GMFLOW = pathlib.Path(__file__).resolve().parent.parent / "gmflow"
base = cell.load_module(GMFLOW / "reference.py", "bench_gmflow_reference")
matching = base.matching
propagation = base.propagation
# the learned convex upsampling of the last scale's flow
final_flow = cell.load_module(GMFLOW / "infer_reference.py",
                              "bench_gmflow_infer_reference").final_flow


def param_spec(cfg: dict) -> refs.Spec:
    """One-scale GMFlow's list with the trident kernel after the backbone's
    last conv (the upsampler's outputs follow ``upsample_factor``)."""
    spec = base.param_spec(cfg)
    c = cfg["feature_channels"]
    at = [n for n, _, _ in spec].index("backbone.conv2.bias") + 1
    return spec[:at] + [("backbone.trident_conv.weight", (c, c, 3, 3),
                         "he_normal")] + spec[at:]


def backbone(P, W, cfg: dict, x: torch.Tensor) -> list:
    """NCHW images -> NCHW features, one per scale from low to high
    resolution: ``layer3`` keeps 1/4 with two scales, the trident kernel
    then gives 1/4 (stride 1) and 1/8 (stride 2)."""
    two = cfg["num_scales"] > 1
    x = F.relu(refs._norm(W, "backbone.norm1",
                          refs._conv(P, W, "backbone.conv1", x, 2),
                          "instance"))
    for i, stride in enumerate((1, 2, 1 if two else 2)):
        for j in (0, 1):
            x = refs._block(P, W, f"backbone.layer{i + 1}.{j}", x,
                            "instance", stride if j == 0 else 1)
    x = refs._conv(P, W, "backbone.conv2", x)
    if not two:
        return [x]
    k = W["backbone.trident_conv.weight"]
    return [P.conv2d(x, k, None, s, 1) for s in (2, 1)]


def add_position(f0: torch.Tensor, f1: torch.Tensor, splits: int):
    """The sine position of each window added to NHWC features
    (``utils.py:feature_add_position``)."""
    _, h, w, c = f0.shape
    pos = base._position(h // splits, w // splits, c, f0.device)
    return tuple(base._merge(base._split(f, splits) + pos, splits)
                 for f in (f0, f1))


def upsample_flow(flow: torch.Tensor) -> torch.Tensor:
    """``[B, h, w, 2]`` -> ``[B, 2h, 2w, 2]``: bilinear, corners aligned,
    times 2 (``gmflow.py:111-112``)."""
    up = F.interpolate(flow.permute(0, 3, 1, 2), scale_factor=2,
                       mode="bilinear", align_corners=True) * 2
    return up.permute(0, 2, 3, 1)


def flow_warp(feature: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """NHWC ``feature`` sampled at (pixel + flow): bilinear, zero outside,
    corners aligned (``geometry.py:flow_warp``)."""
    b, h, w, _ = feature.shape
    grid = base._grid(h, w, feature.device).reshape(1, h, w, 2) + flow
    norm = torch.stack([2 * grid[..., 0] / (w - 1) - 1,
                        2 * grid[..., 1] / (h - 1) - 1], -1)
    return F.grid_sample(feature.permute(0, 3, 1, 2), norm, mode="bilinear",
                         padding_mode="zeros", align_corners=True
                         ).permute(0, 2, 3, 1)


def _windows(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC ``[1, h, w, C]`` -> ``[h*w, (2r+1)^2, C]``: each pixel's window,
    zero past the image, taps in (dy, dx) raster order."""
    _, h, w, c = x.shape
    k = 2 * r + 1
    cols = F.unfold(x.permute(0, 3, 1, 2), k, padding=r)   # [1, C k^2, hw]
    return cols.reshape(c, k * k, h * w).permute(2, 1, 0)


def _offsets(r: int, device) -> torch.Tensor:
    """``[(2r+1)^2, 2]`` (dx, dy) of the window's taps, raster order."""
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)


def local_matching(P, f0: torch.Tensor, f1: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """Matching inside a window of ``radius``: ``softmax(f0 . window(f1) /
    sqrt(C))`` with taps outside the image at -1e9, the flow ``[B, h, w,
    2]`` the expectation of the taps' offsets."""
    b, h, w, c = f0.shape
    off = _offsets(radius, f0.device)
    inside = base._grid(h, w, f0.device)[:, None] + off          # [hw, k2, 2]
    inside = (inside[..., 0] >= 0) & (inside[..., 0] < w) \
        & (inside[..., 1] >= 0) & (inside[..., 1] < h)
    out = []
    for i in range(b):
        win = _windows(f1[i:i + 1], radius)                       # [hw, k2, C]
        q = f0[i].reshape(h * w, 1, c)
        corr = P.matmul(q, win.transpose(1, 2))[:, 0] / c ** 0.5  # [hw, k2]
        corr = torch.where(inside, corr, torch.full_like(corr, -1e9))
        prob = torch.softmax(corr, dim=-1)
        out.append(P.matmul(prob, off).reshape(h, w, 2))
    return torch.stack(out)


def local_propagation(P, W, f0: torch.Tensor, flow: torch.Tensor,
                      radius: int) -> torch.Tensor:
    """Propagation inside a window of ``radius``: the query a projection of
    ``f0``, the keys another projection of ``f0`` over the window, keys and
    flow zero past the image (``transformer.py:368-409``); the flow ``[B,
    h, w, 2]``."""
    b, h, w, c = f0.shape
    x = f0.reshape(b, h * w, c)
    q = P.linear(x, W["feature_flow_attn.q_proj.weight"],
                 W["feature_flow_attn.q_proj.bias"])
    k = P.linear(x, W["feature_flow_attn.k_proj.weight"],
                 W["feature_flow_attn.k_proj.bias"]).reshape(b, h, w, c)
    out = []
    for i in range(b):
        keys = _windows(k[i:i + 1], radius)                       # [hw, k2, C]
        vals = _windows(flow[i:i + 1], radius)                    # [hw, k2, 2]
        s = P.matmul(q[i].reshape(h * w, 1, c), keys.transpose(1, 2))
        prob = torch.softmax(s / c ** 0.5, dim=-1)                # [hw, 1, k2]
        out.append(P.matmul(prob, vals).reshape(h, w, 2))
    return torch.stack(out)


def scale_features(P, W, cfg: dict, f0: torch.Tensor, f1: torch.Tensor,
                   flow, scale: int):
    """One scale's transformer over its backbone features (NHWC), the
    second frame's warped by the flow so far (already at this scale;
    None at the first): the pair ``[B, h, w, C]`` that matching reads."""
    if flow is not None:
        f1 = flow_warp(f1, flow)
    splits = cfg["attn_splits_list"][scale]
    f0, f1 = add_position(f0, f1, splits)
    return base._transformer(P, W, cfg, f0, f1, splits)


def infer(P, W, cfg: dict, image1: torch.Tensor, image2: torch.Tensor,
          probe: dict = None) -> torch.Tensor:
    """NHWC images ``[B, H, W, 3]`` in [0, 255] -> the final flow ``[B, H,
    W, 2]``. ``probe`` gets, per scale from low resolution: ``backbone``
    (the pair's features, NHWC ``[2B, h, w, C]``), ``features`` (the
    transformer's output, ``[2B, h, w, C]``), ``matching`` (the flow that
    propagation takes) and ``propagated`` (its output)."""
    img0 = base._normalize(image1.permute(0, 3, 1, 2))
    img1 = base._normalize(image2.permute(0, 3, 1, 2))
    feats = backbone(P, W, cfg, torch.cat([img0, img1], 0))
    probe = {} if probe is None else probe
    for key in ("backbone", "features", "matching", "propagated"):
        probe[key] = []
    flow = None
    for s, x in enumerate(feats):
        x = x.permute(0, 2, 3, 1)
        probe["backbone"].append(x)
        f0, f1 = x.chunk(2, 0)
        if flow is not None:
            flow = upsample_flow(flow)
        f0, f1 = scale_features(P, W, cfg, f0, f1, flow, s)
        probe["features"].append(torch.cat([f0, f1], 0))
        radius = cfg["corr_radius_list"][s]
        pred = matching(P, f0, f1) if radius == -1 \
            else local_matching(P, f0, f1, radius)
        flow = pred if flow is None else flow + pred
        probe["matching"].append(flow)
        radius = cfg["prop_radius_list"][s]
        flow = propagation(P, W, f0, flow) if radius == -1 \
            else local_propagation(P, W, f0, flow, radius)
        probe["propagated"].append(flow)
    return final_flow(P, W, cfg, flow, f0)
