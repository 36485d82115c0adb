"""RAFT-basic in inference cells: the program's inference function built
from the benchmark's weights, and the work one call does."""

from __future__ import annotations

import torch

from harness import bounds, cell, counts

reference = cell.sibling(__file__, "reference")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the port's CUDA sources this mode runs, built at set-up in parallel
KERNELS = ("fused_corr", "instance_norm")


def build(device) -> None:
    if torch.device(device).type == "cuda":
        from opticalflowfromdepth_torch import _build
        _build.build(KERNELS)


def program(cfg: dict, W: dict, device):
    """``raft_infer_fn(model, iters)`` of the program's RAFT, its weights
    the benchmark's."""
    from opticalflowfromdepth_torch.eval.infer import raft_infer_fn
    from opticalflowfromdepth_torch.models.raft import RAFT
    build(device)
    with torch.device("meta"):
        model = RAFT(small=False, corr_levels=cfg["corr_levels"],
                     corr_impl=cfg["corr_impl"], dtype=DTYPES[cfg["dtype"]])
    model = model.to_empty(device=device)
    model.load_state_dict(W, strict=True)
    return raft_infer_fn(model, iters=cfg["iters"], device=device)


def padded(traffic: dict):
    f = traffic["pad_factor"]
    return tuple(-(-traffic[k] // f) * f for k in ("height", "width"))


def work(cfg: dict, traffic: dict) -> dict:
    """One call's model FLOPs (the forward) and the least time of each
    kernel's op: a lookup an iteration, the feature encoder's 15 instance
    norms over both frames."""
    b = traffic["batch"]
    h, w = padded(traffic)
    flops = counts.infer_flops(
        reference.param_spec(cfg),
        lambda P, W, i1, i2: reference.infer(P, W, cfg, i1, i2),
        (b, h, w, 3), (b, h, w, 3))
    h8, w8 = counts.stride_out(h, 8), counts.stride_out(w, 8)
    rows, hl, wl = 0, h8, w8
    for _ in range(cfg["corr_levels"]):
        rows += hl * wl
        hl, wl = hl // 2, wl // 2
    lookup = bounds.corr_lookup(b, h8 * w8, cfg["fnet_dim"], rows,
                                cfg["corr_levels"], cfg["corr_radius"])
    return {"flops": flops, "bounds": {
        "corr_lookup": cfg["iters"] * lookup,
        "instance_norm": sum(bounds.instance_norm(n) for n in
                             counts.encoder_norms(2 * b, h, w))}}
