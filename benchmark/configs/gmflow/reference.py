"""Plain float32 GMFlow (one scale) and its training step with the frozen
augmentation classifier.

Written from the published code, ``haofeixu/gmflow``: ``gmflow/gmflow.py``
(the forward), ``backbone.py``, ``transformer.py`` (Swin windows, shifted
every other block, single-head attention, the FFN), ``matching.py``
(global matching), ``position.py``, ``utils.py`` and ``loss.py``, with
the classifier term of the adjusted trainer. Plain PyTorch on NCHW / NHWC
tensors; no kernel, no fused op, no program code. The attention is the
dense ``softmax(q k^T / sqrt(C)) v``.

``cfg`` is the configuration file's dict; ``W`` maps the published
``state_dict`` names to tensors; ``P`` is a precision
(``harness/precision.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from harness import refs


def param_spec(cfg: dict) -> refs.Spec:
    c = cfg["feature_channels"]
    spec = refs.encoder_spec("backbone", 3, c, "instance", conv_bias=False)
    hidden = 2 * c * cfg["ffn_dim_expansion"]
    for i in range(cfg["num_transformer_layers"]):
        for part in ("self_attn", "cross_attn_ffn"):
            p = f"transformer.layers.{i}.{part}"
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                spec.append((f"{p}.{proj}.weight", (c, c), "xavier"))
            spec += [(f"{p}.norm1.weight", (c,), "ones"),
                     (f"{p}.norm1.bias", (c,), "zeros")]
            if part == "cross_attn_ffn":
                spec += [(f"{p}.mlp.0.weight", (hidden, 2 * c), "xavier"),
                         (f"{p}.mlp.2.weight", (c, hidden), "xavier"),
                         (f"{p}.norm2.weight", (c,), "ones"),
                         (f"{p}.norm2.bias", (c,), "zeros")]
    for proj in ("q_proj", "k_proj"):
        spec += [(f"feature_flow_attn.{proj}.weight", (c, c), "xavier"),
                 (f"feature_flow_attn.{proj}.bias", (c,), "uniform")]
    up = cfg["upsample_factor"]
    spec += refs.conv_spec("upsampler.0", 2 + c, 256, 3, "uniform")
    spec += refs.conv_spec("upsampler.2", 256, up * up * 9, 1, "uniform")
    return spec


def aux_spec(cfg: dict) -> refs.Spec:
    return refs.classifier_spec(cfg["classifier"]["output_dim"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _normalize(img: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor([0.485, 0.456, 0.406], device=img.device)
    std = torch.tensor([0.229, 0.224, 0.225], device=img.device)
    return (img / 255.0 - mean[:, None, None]) / std[:, None, None]


def _split(x: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B*k*k, H/k, W/k, C]``, windows in [b, wy, wx]
    order (``utils.py:split_feature``)."""
    b, h, w, c = x.shape
    x = x.reshape(b, k, h // k, k, w // k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, h // k, w // k, c)


def _merge(x: torch.Tensor, k: int) -> torch.Tensor:
    bk, hk, wk, c = x.shape
    x = x.reshape(bk // (k * k), k, k, hk, wk, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(bk // (k * k), k * hk, k * wk, c)


def _position(h: int, w: int, channels: int, device) -> torch.Tensor:
    """``[H, W, C]`` normalized sine embedding (``position.py``)."""
    feats = channels // 2
    ones = torch.ones(h, w, device=device)
    y = torch.cumsum(ones, 0)
    x = torch.cumsum(ones, 1)
    y = y / (y[-1:, :] + 1e-6) * 2 * math.pi
    x = x / (x[:, -1:] + 1e-6) * 2 * math.pi
    dim_t = torch.arange(feats, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                        / feats)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = torch.stack([px[:, :, 0::2].sin(), px[:, :, 1::2].cos()],
                     dim=3).flatten(2)
    py = torch.stack([py[:, :, 0::2].sin(), py[:, :, 1::2].cos()],
                     dim=3).flatten(2)
    return torch.cat([py, px], dim=-1)


def _shift_mask(h: int, w: int, k: int, device) -> torch.Tensor:
    """``[k*k, L, L]`` Swin mask: -100 between tokens of different regions
    of the shifted image (``utils.py:generate_shift_window_attn_mask``)."""
    wh, ww, sh, sw = h // k, w // k, h // k // 2, w // k // 2
    img = torch.zeros(1, h, w, 1, device=device)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for ws in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = _split(img, k).reshape(-1, wh * ww)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def _attention(P, q, k, v, mask=None):
    scores = P.matmul(q, k.transpose(1, 2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + mask
    return P.matmul(torch.softmax(scores, dim=-1), v)


def _window_attention(P, q, k, v, splits, shift, h, w, mask):
    b, _, c = q.shape
    wh, ww = h // splits, w // splits
    q, k, v = (t.reshape(b, h, w, c) for t in (q, k, v))
    if shift:
        q, k, v = (torch.roll(t, (-(wh // 2), -(ww // 2)), (1, 2))
                   for t in (q, k, v))
    q, k, v = (_split(t, splits).reshape(-1, wh * ww, c) for t in (q, k, v))
    out = _attention(P, q, k, v,
                     mask.repeat(b, 1, 1) if shift else None)
    out = _merge(out.reshape(-1, wh, ww, c), splits)
    if shift:
        out = torch.roll(out, (wh // 2, ww // 2), (1, 2))
    return out.reshape(b, h * w, c)


def _layer(P, W, p, source, target, h, w, splits, shift, mask, ffn):
    q = P.linear(source, W[f"{p}.q_proj.weight"])
    k = P.linear(target, W[f"{p}.k_proj.weight"])
    v = P.linear(target, W[f"{p}.v_proj.weight"])
    if splits > 1:
        msg = _window_attention(P, q, k, v, splits, shift, h, w, mask)
    else:
        msg = _attention(P, q, k, v)
    c = source.shape[-1]
    msg = F.layer_norm(P.linear(msg, W[f"{p}.merge.weight"]), (c,),
                       W[f"{p}.norm1.weight"], W[f"{p}.norm1.bias"], 1e-5)
    if ffn:
        y = F.gelu(P.linear(torch.cat([source, msg], dim=-1),
                            W[f"{p}.mlp.0.weight"]))
        msg = F.layer_norm(P.linear(y, W[f"{p}.mlp.2.weight"]), (c,),
                           W[f"{p}.norm2.weight"], W[f"{p}.norm2.bias"],
                           1e-5)
    return source + msg


def _transformer(P, W, cfg, f0, f1, splits):
    """``[B, H, W, C]`` pair -> the pair after the blocks of self and cross
    attention, over the concatenated batch ``[f0; f1]``."""
    b, h, w, c = f0.shape
    mask = _shift_mask(h, w, splits, f0.device) if splits > 1 else None
    c0 = torch.cat([f0, f1], 0).reshape(2 * b, h * w, c)
    c1 = torch.cat([f1, f0], 0).reshape(2 * b, h * w, c)
    for i in range(cfg["num_transformer_layers"]):
        shift = i % 2 == 1
        p = f"transformer.layers.{i}"
        c0 = _layer(P, W, f"{p}.self_attn", c0, c0, h, w, splits, shift,
                    mask, False)
        c0 = _layer(P, W, f"{p}.cross_attn_ffn", c0, c1, h, w, splits,
                    shift, mask, True)
        a, z = c0.chunk(2, 0)
        c1 = torch.cat([z, a], 0)
    a, z = c0.chunk(2, 0)
    return a.reshape(b, h, w, c), z.reshape(b, h, w, c)


def _grid(h: int, w: int, device) -> torch.Tensor:
    """``[H*W, 2]`` (x, y) pixel coordinates."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32),
                            indexing="ij")
    return torch.stack([xs, ys], -1).reshape(h * w, 2)


def _convex_upsample(flow: torch.Tensor, mask: torch.Tensor, f: int):
    """``[B, 2, H, W]`` flow, ``[B, 9*f*f, H, W]`` mask -> ``[B, 2, fH,
    fW]`` (``gmflow.py:upsample_flow``)."""
    b, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(b, 1, 9, f, f, h, w), dim=2)
    up = F.unfold(f * flow, [3, 3], padding=1).reshape(b, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, 2, f * h, f * w)


def matching(P, f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """Global matching of NHWC features ``[B, h, w, C]``: ``softmax(f0
    f1^T / sqrt(C)) @ grid - grid``, the flow ``[B, h, w, 2]`` in cells."""
    b, h, w, c = f0.shape
    grid = _grid(h, w, f0.device)
    prob = torch.softmax(P.matmul(f0.reshape(b, h * w, c),
                                  f1.reshape(b, h * w, c).transpose(1, 2))
                         / math.sqrt(c), dim=-1)
    flow = P.matmul(prob, grid.expand(b, h * w, 2)) - grid
    return flow.reshape(b, h, w, 2)


def propagation(P, W, f0: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Flow propagation: attention with the query and the key (a
    projection of the query, as published) from ``f0`` ``[B, h, w, C]``
    over the flow ``[B, h, w, 2]``; the flow ``[B, h, w, 2]``."""
    b, h, w, c = f0.shape
    query = P.linear(f0.reshape(b, h * w, c),
                     W["feature_flow_attn.q_proj.weight"],
                     W["feature_flow_attn.q_proj.bias"])
    key = P.linear(query, W["feature_flow_attn.k_proj.weight"],
                   W["feature_flow_attn.k_proj.bias"])
    return _attention(P, query, key, flow.reshape(b, h * w, 2)) \
        .reshape(b, h, w, 2)


def forward(P, W, cfg: dict, img0: torch.Tensor, img1: torch.Tensor,
            probe: dict = None) -> List[torch.Tensor]:
    """NCHW [0, 255] images -> the flow predictions of training ``[B, 2,
    H, W]``: the matching flow upsampled bilinearly, then the propagated
    flow upsampled by the learned convex mask. ``probe``: the
    transformer's output (``features``, ``[2B, h, w, C]``), the matching
    flow and the propagated flow (``matching``, ``propagated``, ``[B, h,
    w, 2]``)."""
    if cfg["num_scales"] != 1:
        raise ValueError("the reference covers one scale")
    splits = cfg["attn_splits_list"][0]
    if cfg["corr_radius_list"][0] != -1 or cfg["prop_radius_list"][0] != -1:
        raise ValueError("the reference covers global matching and "
                         "propagation")
    c = cfg["feature_channels"]
    up = cfg["upsample_factor"]
    x = refs.encoder(P, W, "backbone",
                     torch.cat([_normalize(img0), _normalize(img1)], 0),
                     "instance")
    f0, f1 = x.permute(0, 2, 3, 1).chunk(2, 0)
    b, h, w, _ = f0.shape
    if splits > 1:
        pos = _position(h // splits, w // splits, c, f0.device)
        f0 = _merge(_split(f0, splits) + pos, splits)
        f1 = _merge(_split(f1, splits) + pos, splits)
    else:
        pos = _position(h, w, c, f0.device)
        f0, f1 = f0 + pos, f1 + pos
    f0, f1 = _transformer(P, W, cfg, f0, f1, splits)
    if probe is not None:
        probe["features"] = torch.cat([f0, f1], 0).detach()

    flow = matching(P, f0, f1)
    preds = [F.interpolate(flow.permute(0, 3, 1, 2), scale_factor=up,
                           mode="bilinear", align_corners=True) * up]
    if probe is not None:
        probe["matching"] = flow.detach()
    flow = propagation(P, W, f0, flow.detach())
    if probe is not None:
        probe["propagated"] = flow.detach()
    flow = flow.permute(0, 3, 1, 2)
    feat = torch.cat([flow, f0.permute(0, 3, 1, 2)], 1)
    mask = F.relu(P.conv2d(feat, W["upsampler.0.weight"],
                           W["upsampler.0.bias"], 1, 1))
    mask = P.conv2d(mask, W["upsampler.2.weight"], W["upsampler.2.bias"])
    preds.append(_convex_upsample(flow, mask, up))
    return preds


# ---------------------------------------------------------------------------
# what the cells run
# ---------------------------------------------------------------------------

def recipe_loss(P, cfg: dict, aux: Dict[str, torch.Tensor], preds, batch,
                step: int, extras: dict) -> torch.Tensor:
    """The recipe's loss of the flow predictions: the sequence loss, plus
    the frozen classifier's cross-entropy on the last one at its
    scheduled weight (``extras["classify_loss"]``)."""
    train = cfg["train"]
    loss = refs.sequence_loss(preds, batch["flow"], batch["valid"],
                              train["gamma"])
    if train["add_classifier"]:
        logits = refs.classifier(P, aux, preds[-1])
        c_loss = refs.classifier_loss(logits, batch["label"])
        loss = loss + c_loss * refs.classify_weight(train, step)
        extras["classify_loss"] = c_loss.detach()
    return loss


def train_loss(P, cfg: dict, aux: Dict[str, torch.Tensor]):
    """``loss_fn(W, batch, step) -> (loss, extras)`` of the recipe
    (``recipe_loss`` of ``forward``)."""
    def loss_fn(W, batch, step):
        extras = {}
        preds = forward(P, W, cfg, batch["image1"], batch["image2"], extras)
        loss = recipe_loss(P, cfg, aux, preds, batch, step, extras)
        extras["flow"] = preds[-1].detach()
        return loss, extras

    return loss_fn
