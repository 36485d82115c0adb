"""Plain float32 RAFT (the basic model) in its inference form.

Written from the published code, ``princeton-vl/RAFT``: ``core/raft.py``
(the forward, ``upsample_flow``), ``core/update.py`` (the motion encoder,
the separable ConvGRU, the flow and mask heads), ``core/extractor.py``
(the encoders: instance norm for the feature encoder, BatchNorm for the
context encoder) and ``core/corr.py`` (the all-pairs volume over
``sqrt(C)``, its 2x2 average-pooled pyramid, and the lookup by
``F.grid_sample`` over a (2r+1)^2 window at each level). Plain PyTorch,
no kernel, no program code.

``cfg`` is the configuration file's dict; ``W`` maps the published
``state_dict`` names to tensors; ``P`` is a precision
(``harness/precision.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from harness import refs


def param_spec(cfg: dict) -> refs.Spec:
    hidden, context = cfg["hidden_dim"], cfg["context_dim"]
    spec = refs.encoder_spec("fnet", 3, cfg["fnet_dim"], "instance")
    spec += refs.encoder_spec("cnet", 3, hidden + context, "batch")
    planes = cfg["corr_levels"] * (2 * cfg["corr_radius"] + 1) ** 2
    u = "update_block"
    spec += refs.conv_spec(f"{u}.encoder.convc1", planes, 256, 1, "uniform")
    spec += refs.conv_spec(f"{u}.encoder.convc2", 256, 192, 3, "uniform")
    spec += refs.conv_spec(f"{u}.encoder.convf1", 2, 128, 7, "uniform")
    spec += refs.conv_spec(f"{u}.encoder.convf2", 128, 64, 3, "uniform")
    spec += refs.conv_spec(f"{u}.encoder.conv", 64 + 192, 128 - 2, 3,
                           "uniform")
    cin = hidden + context + 128
    for i, kernel in ((1, (1, 5)), (2, (5, 1))):
        for g in "zrq":
            spec += refs.conv_spec(f"{u}.gru.conv{g}{i}", cin, hidden,
                                   kernel, "uniform")
    spec += refs.conv_spec(f"{u}.flow_head.conv1", hidden, 256, 3, "uniform")
    spec += refs.conv_spec(f"{u}.flow_head.conv2", 256, 2, 3, "uniform")
    spec += refs.conv_spec(f"{u}.mask.0", hidden, 256, 3, "uniform")
    spec += refs.conv_spec(f"{u}.mask.2", 256, 64 * 9, 1, "uniform")
    return spec


def _conv(P, W, name, x):
    w = W[f"{name}.weight"]
    kh, kw = w.shape[-2:]
    return P.conv2d(x, w, W[f"{name}.bias"], 1, ((kh - 1) // 2,
                                                 (kw - 1) // 2))


def _pyramid(P, f1: torch.Tensor, f2: torch.Tensor, levels: int):
    """``[B, C, H, W]`` maps -> ``levels`` volumes ``[B*H*W, 1, h_l, w_l]``
    (``corr.py:CorrBlock``)."""
    b, c, h, w = f1.shape
    corr = P.matmul(f1.reshape(b, c, h * w).transpose(1, 2),
                    f2.reshape(b, c, h * w)) / math.sqrt(c)
    corr = corr.reshape(b * h * w, 1, h, w)
    out = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        out.append(corr)
    return out


def _lookup(pyramid, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """coords ``[B, 2, H, W]`` -> ``[B, L*(2r+1)^2, H, W]``: each level's
    volume bilinearly sampled (zero outside, ``align_corners=True``) on the
    window around coords / 2^l, x-major (``corr.py:CorrBlock.__call__``)."""
    b, _, h, w = coords.shape
    xy = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 1, 2)
    d = torch.linspace(-radius, radius, 2 * radius + 1, device=coords.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([dy, dx], -1).reshape(1, 2 * radius + 1,
                                              2 * radius + 1, 2)
    out = []
    for i, corr in enumerate(pyramid):
        pts = xy / 2 ** i + delta
        hl, wl = corr.shape[-2:]
        grid = torch.cat([2 * pts[..., :1] / (wl - 1) - 1,
                          2 * pts[..., 1:] / (hl - 1) - 1], -1)
        out.append(F.grid_sample(corr, grid, align_corners=True)
                   .reshape(b, h, w, -1))
    return torch.cat(out, -1).permute(0, 3, 1, 2)


def _gru(P, W, h, x):
    for i in (1, 2):
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(_conv(P, W, f"update_block.gru.convz{i}", hx))
        r = torch.sigmoid(_conv(P, W, f"update_block.gru.convr{i}", hx))
        q = torch.tanh(_conv(P, W, f"update_block.gru.convq{i}",
                             torch.cat([r * h, x], 1)))
        h = (1 - z) * h + z * q
    return h


def _update(P, W, net, inp, corr, flow):
    e = "update_block.encoder"
    cor = F.relu(_conv(P, W, f"{e}.convc2",
                       F.relu(_conv(P, W, f"{e}.convc1", corr))))
    flo = F.relu(_conv(P, W, f"{e}.convf2",
                       F.relu(_conv(P, W, f"{e}.convf1", flow))))
    motion = torch.cat([F.relu(_conv(P, W, f"{e}.conv",
                                     torch.cat([cor, flo], 1))), flow], 1)
    net = _gru(P, W, net, torch.cat([inp, motion], 1))
    delta = _conv(P, W, "update_block.flow_head.conv2", F.relu(
        _conv(P, W, "update_block.flow_head.conv1", net)))
    mask = 0.25 * _conv(P, W, "update_block.mask.2", F.relu(
        _conv(P, W, "update_block.mask.0", net)))
    return net, mask, delta


def _upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``raft.py:upsample_flow``: [B, 2, H, W] -> [B, 2, 8H, 8W]."""
    b, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).reshape(b, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, 2, 8 * h, 8 * w)


def forward(P, W, cfg: dict, image1, image2, iters: int) -> torch.Tensor:
    """NCHW [0, 255] images -> the final upsampled flow ``[B, 2, H, W]``
    (``raft.py:RAFT.forward`` in test mode)."""
    hidden = cfg["hidden_dim"]
    image1 = 2 * (image1 / 255.0) - 1.0
    image2 = 2 * (image2 / 255.0) - 1.0
    fmaps = refs.encoder(P, W, "fnet", torch.cat([image1, image2], 0),
                         "instance")
    f1, f2 = fmaps.chunk(2, 0)
    pyramid = _pyramid(P, f1, f2, cfg["corr_levels"])
    cnet = refs.encoder(P, W, "cnet", image1, "batch")
    net = torch.tanh(cnet[:, :hidden])
    inp = F.relu(cnet[:, hidden:])
    b, _, h, w = f1.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=f1.device,
                                         dtype=torch.float32),
                            torch.arange(w, device=f1.device,
                                         dtype=torch.float32), indexing="ij")
    coords0 = torch.stack([xs, ys], 0)[None].expand(b, 2, h, w)
    coords1 = coords0.clone()
    mask = None
    for _ in range(iters):
        corr = _lookup(pyramid, coords1, cfg["corr_radius"])
        net, mask, delta = _update(P, W, net, inp, corr, coords1 - coords0)
        coords1 = coords1 + delta
    return _upsample(coords1 - coords0, mask)


def infer(P, W, cfg: dict, image1, image2) -> torch.Tensor:
    """NHWC [0, 255] pairs -> NHWC flow ``[B, H, W, 2]``."""
    with torch.no_grad():
        flow = forward(P, W, cfg, image1.permute(0, 3, 1, 2),
                       image2.permute(0, 3, 1, 2), cfg["iters"])
    return flow.permute(0, 2, 3, 1)
