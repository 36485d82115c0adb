"""Carry the JAX package's RAFT variables into the port's ``state_dict``.

The inverse of ``opticalflowfromdepth_tpu/tools/port_torch_weights.py:
port_raft``: the flax ``params`` and ``batch_stats`` (nested dicts of
arrays) become a torch ``state_dict`` with the reference's key names,
which the port's :class:`~opticalflowfromdepth_torch.models.raft.RAFT`
loads with ``strict=True``. Every flax leaf must be used exactly once.

Layout transforms: conv kernels ``[kh, kw, I, O]`` -> ``[O, I, kh, kw]``;
BatchNorm scale/bias -> weight/bias, batch_stats mean/var -> running
statistics. The reference registers a strided block's skip norm twice
(``norm3`` and ``downsample.1``), so those tensors appear under both keys.
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


def raft_state_dict_from_flax(params: Mapping,
                              batch_stats: Optional[Mapping] = None,
                              small: bool = False
                              ) -> "OrderedDict[str, torch.Tensor]":
    """JAX RAFT ``params`` / ``batch_stats`` -> the port's ``state_dict``."""
    p = _flatten(params)
    s = _flatten(batch_stats or {})

    def take(tree: Flat, path: str, *leaf: str) -> torch.Tensor:
        key = tuple(path.split("/")) + leaf
        if key not in tree:
            raise KeyError(f"flax leaf missing or already used: "
                           f"{'/'.join(key)}")
        return torch.from_numpy(np.array(tree.pop(key), np.float32))

    sd: "OrderedDict[str, Any]" = OrderedDict()
    for kind, dst, src, *alias in _raft_pairs(small):
        if kind == "conv":
            sd[f"{src}.weight"] = take(p, dst, "Conv_0", "kernel").permute(
                3, 2, 0, 1).contiguous()
            sd[f"{src}.bias"] = take(p, dst, "Conv_0", "bias")
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
