"""Carry the JAX package's RAFT, classifier and GMFlow variables into the
port's ``state_dict``s.

The inverses of ``opticalflowfromdepth_tpu/tools/port_torch_weights.py:
port_raft``, ``port_classifier`` and ``port_gmflow``: the flax ``params``
and ``batch_stats`` (nested dicts of arrays) become a torch ``state_dict``
with the reference's key names, which the port's ``RAFT``,
``Classifier`` and ``GMFlow`` load with ``strict=True``. Every flax leaf
must be used exactly once.

Layout transforms: conv kernels ``[kh, kw, I, O]`` -> ``[O, I, kh, kw]``;
dense kernels ``[I, O]`` -> ``[O, I]``; BatchNorm and LayerNorm
scale/bias -> weight/bias, batch_stats mean/var -> running statistics.
The reference registers a strided block's skip norm twice (``norm3`` and
``downsample.1``), so those tensors appear under both keys.
"""

from __future__ import annotations

from collections import OrderedDict
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

Flat = Dict[Tuple[str, ...], np.ndarray]


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Flat:
    out: Flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def _encoder_pairs(dst: str, src: str, norm: str, small: bool
                   ) -> Iterator[tuple]:
    """(kind, flax path, torch prefix[, alias]) for one encoder, in the
    order and naming of ``port_torch_weights._port_*_encoder``."""
    yield ("conv", f"{dst}/Conv_0", f"{src}.conv1")
    if norm == "batch":
        yield ("bn", f"{dst}/BatchNorm_0", f"{src}.norm1", None)
    block, nconv = ("BottleneckBlock", 3) if small else ("ResidualBlock", 2)
    for i in range(6):
        layer, sub = 1 + i // 2, i % 2
        tsrc = f"{src}.layer{layer}.{sub}"
        tdst = f"{dst}/{block}_{i}"
        for j in range(nconv):
            yield ("conv", f"{tdst}/Conv_{j}", f"{tsrc}.conv{j + 1}")
            if norm == "batch":
                yield ("bn", f"{tdst}/BatchNorm_{j}", f"{tsrc}.norm{j + 1}",
                       None)
        if sub == 0 and layer > 1:
            yield ("conv", f"{tdst}/Conv_{nconv}", f"{tsrc}.downsample.0")
            if norm == "batch":
                yield ("bn", f"{tdst}/BatchNorm_{nconv}",
                       f"{tsrc}.norm{nconv + 1}", f"{tsrc}.downsample.1")
    yield ("conv", f"{dst}/Conv_1", f"{src}.conv2")


def _raft_pairs(small: bool) -> Iterator[tuple]:
    yield from _encoder_pairs("fnet", "fnet", "instance", small)
    yield from _encoder_pairs("cnet", "cnet", "none" if small else "batch",
                              small)
    ub = "update_block"
    if small:
        enc, gru, names = "SmallMotionEncoder_0", "ConvGRU_0", (
            "convc1", "convf1", "convf2", "conv")
        gru_names = ("convz", "convr", "convq")
    else:
        enc, gru, names = "BasicMotionEncoder_0", "SepConvGRU_0", (
            "convc1", "convc2", "convf1", "convf2", "conv")
        gru_names = ("convz1", "convr1", "convq1", "convz2", "convr2",
                     "convq2")
    for j, name in enumerate(names):
        yield ("conv", f"{ub}/{enc}/Conv_{j}", f"{ub}.encoder.{name}")
    for j, name in enumerate(gru_names):
        yield ("conv", f"{ub}/{gru}/Conv_{j}", f"{ub}.gru.{name}")
    yield ("conv", f"{ub}/FlowHead_0/Conv_0", f"{ub}.flow_head.conv1")
    yield ("conv", f"{ub}/FlowHead_0/Conv_1", f"{ub}.flow_head.conv2")
    if not small:
        # flax creates the mask head outer-then-inner: Conv_0 is mask.2
        yield ("conv", f"{ub}/Conv_0", f"{ub}.mask.2")
        yield ("conv", f"{ub}/Conv_1", f"{ub}.mask.0")


def _state_dict_from_flax(pairs: Iterator[tuple], params: Mapping,
                          batch_stats: Optional[Mapping]
                          ) -> "OrderedDict[str, torch.Tensor]":
    p = _flatten(params)
    s = _flatten(batch_stats or {})

    def take(tree: Flat, path: str, *leaf: str) -> torch.Tensor:
        key = tuple(path.split("/")) + leaf
        if key not in tree:
            raise KeyError(f"flax leaf missing or already used: "
                           f"{'/'.join(key)}")
        return torch.from_numpy(np.array(tree.pop(key), np.float32))

    sd: "OrderedDict[str, Any]" = OrderedDict()
    for kind, dst, src, *alias in pairs:
        if kind in ("conv", "conv_nobias"):
            sd[f"{src}.weight"] = take(p, dst, "Conv_0", "kernel").permute(
                3, 2, 0, 1).contiguous()
            if kind == "conv":
                sd[f"{src}.bias"] = take(p, dst, "Conv_0", "bias")
            continue
        if kind == "kernel":                    # a bare conv kernel param
            sd[src] = take(p, dst).permute(3, 2, 0, 1).contiguous()
            continue
        if kind in ("dense", "dense_nobias"):
            sd[f"{src}.weight"] = take(p, dst, "kernel").t().contiguous()
            if kind == "dense":
                sd[f"{src}.bias"] = take(p, dst, "bias")
            continue
        if kind == "ln":
            sd[f"{src}.weight"] = take(p, dst, "scale")
            sd[f"{src}.bias"] = take(p, dst, "bias")
            continue
        bn = {"weight": take(p, dst, "scale"), "bias": take(p, dst, "bias"),
              "running_mean": take(s, dst, "mean"),
              "running_var": take(s, dst, "var"),
              "num_batches_tracked": torch.tensor(0, dtype=torch.long)}
        for name in (src,) + tuple(a for a in alias if a):
            for suf, val in bn.items():
                sd[f"{name}.{suf}"] = val.clone()
    if p or s:
        left = sorted("/".join(k) for k in list(p) + list(s))
        raise ValueError(f"{len(left)} flax leaves were not used, e.g. "
                         f"{left[:6]}")
    return sd


def raft_state_dict_from_flax(params: Mapping,
                              batch_stats: Optional[Mapping] = None,
                              small: bool = False
                              ) -> "OrderedDict[str, torch.Tensor]":
    """JAX RAFT ``params`` / ``batch_stats`` -> the port's ``state_dict``."""
    return _state_dict_from_flax(_raft_pairs(small), params, batch_stats)


def classifier_state_dict_from_flax(params: Mapping,
                                    batch_stats: Optional[Mapping] = None,
                                    use_small: bool = False,
                                    use_dropout_in_classify: bool = False
                                    ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``Classifier`` ``params`` / ``batch_stats`` -> the port's
    ``state_dict`` (``port_classifier``'s inverse)."""
    def pairs():
        yield from _encoder_pairs("encoder", "encoder", "batch", use_small)
        yield ("dense", "Dense_0",
               f"classify.{4 if use_dropout_in_classify else 3}")
    return _state_dict_from_flax(pairs(), params, batch_stats)


def _gmflow_pairs(num_scales: int) -> Iterator[tuple]:
    """``port_gmflow``'s map, flax path -> torch prefix."""
    yield ("conv_nobias", "backbone/Conv_0", "backbone.conv1")
    for i in range(6):
        layer, sub = 1 + i // 2, i % 2
        tsrc, tdst = f"backbone.layer{layer}.{sub}", f"backbone/_ResBlock_{i}"
        yield ("conv_nobias", f"{tdst}/Conv_0", f"{tsrc}.conv1")
        yield ("conv_nobias", f"{tdst}/Conv_1", f"{tsrc}.conv2")
        if sub == 0 and layer > 1:              # in_planes != planes
            yield ("conv", f"{tdst}/Conv_2", f"{tsrc}.downsample.0")
    yield ("conv", "backbone/Conv_1", "backbone.conv2")
    if num_scales > 1:
        yield ("kernel", "backbone/trident_kernel",
               "backbone.trident_conv.weight")
    for i in range(6):
        for attn in ("self_attn", "cross_attn_ffn"):
            src = f"transformer.layers.{i}.{attn}"
            dst = f"transformer/block_{i}/{attn}"
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                yield ("dense_nobias", f"{dst}/{proj}", f"{src}.{proj}")
            yield ("ln", f"{dst}/norm1", f"{src}.norm1")
            if attn == "cross_attn_ffn":
                yield ("dense_nobias", f"{dst}/Dense_0", f"{src}.mlp.0")
                yield ("dense_nobias", f"{dst}/Dense_1", f"{src}.mlp.2")
                yield ("ln", f"{dst}/norm2", f"{src}.norm2")
    yield ("dense", "feature_flow_attn/q_proj", "feature_flow_attn.q_proj")
    yield ("dense", "feature_flow_attn/k_proj", "feature_flow_attn.k_proj")
    yield ("conv", "Conv_0", "upsampler.0")
    yield ("conv", "Conv_1", "upsampler.2")


def gmflow_state_dict_from_flax(params: Mapping, num_scales: int = 1
                                ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``GMFlow`` ``params`` (6 transformer blocks) -> the port's
    ``state_dict`` (``port_gmflow``'s inverse; GMFlow has no batch
    statistics)."""
    return _state_dict_from_flax(_gmflow_pairs(num_scales), params, None)
