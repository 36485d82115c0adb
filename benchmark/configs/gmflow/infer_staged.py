"""GMFlow in inference cells: the program's serving entry
(``eval/infer.py:gmflow_infer_fn``) over ``GMFlow`` with the benchmark's
weights, what each of its stages makes, the checks that follow those
stages with the plain reference, and the work one call does. The
functions take any scale count; ``configs/gmflow-refine/infer_staged.py``
gives them its own reference."""

from __future__ import annotations

import contextlib
import math

import torch

from harness import bounds, cell, compare, counts, precision, refs

reference = cell.sibling(__file__, "infer_reference")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the port's CUDA sources this mode runs, built at set-up in parallel
KERNELS = ("flash", "instance_norm")
# a flow this far (in cells of its scale: 8 px at 1/8, 4 px at 1/4) from
# the reference's is another match, not a rounding of the same one
FAR_CELLS = 1.0
# the final flow, in pixels: the planted one-pixel shift lies 1.41 px off
FAR_PX = 1.0


def build(device) -> None:
    if torch.device(device).type == "cuda":
        from opticalflowfromdepth_torch import _build
        _build.build(KERNELS)


class Program:
    """``gmflow_infer_fn`` over the program's ``GMFlow``, its weights the
    benchmark's (``infer(image1, image2)``, host NHWC arrays to host
    flow)."""

    def __init__(self, cfg: dict, W: dict, device) -> None:
        from opticalflowfromdepth_torch.eval.infer import gmflow_infer_fn
        from opticalflowfromdepth_torch.models.gmflow import GMFlow
        build(device)
        with torch.device("meta"):
            model = GMFlow(num_scales=cfg["num_scales"],
                           upsample_factor=cfg["upsample_factor"],
                           feature_channels=cfg["feature_channels"],
                           num_transformer_layers=cfg[
                               "num_transformer_layers"],
                           ffn_dim_expansion=cfg["ffn_dim_expansion"],
                           dtype=DTYPES[cfg["dtype"]])
        self.model = model.to_empty(device=device)
        self.model.load_state_dict(W, strict=True)
        self.infer = gmflow_infer_fn(
            self.model, attn_splits_list=tuple(cfg["attn_splits_list"]),
            corr_radius_list=tuple(cfg["corr_radius_list"]),
            prop_radius_list=tuple(cfg["prop_radius_list"]), device=device)

    def __call__(self, image1, image2):
        return self.infer(image1, image2)

    @contextlib.contextmanager
    def capture(self):
        """What the call made in the block, a list a scale from low
        resolution: ``features`` (the transformer's output, both frames,
        ``[2B, h, w, C]``), ``matching`` (the flow that propagation takes)
        and ``propagated`` (its output), ``[B, h, w, 2]``, in f32."""
        box = {"features": [], "matching": [], "propagated": []}

        def features(_module, _inputs, out):
            box["features"].append(torch.cat(out, 0).float())

        def propagation(_module, inputs, out):
            box["matching"].append(inputs[1].float().clone())
            box["propagated"].append(out.float())

        handles = [
            self.model.transformer.register_forward_hook(features),
            self.model.feature_flow_attn.register_forward_hook(propagation)]
        try:
            yield box
        finally:
            for h in handles:
                h.remove()


def program(cfg: dict, W: dict, device) -> Program:
    return Program(cfg, W, device)


def padded(traffic: dict):
    f = traffic["pad_factor"]
    return tuple(-(-traffic[k] // f) * f for k in ("height", "width"))


def flash_calls(cfg: dict, traffic: dict) -> list:
    """Each flash forward of a call as ``(B, Lq, Lk, C, D)``: a scale's
    window attention twice a block over both frames' windows, then global
    matching and global propagation where the scale takes them (at 1/8,
    then 1/4)."""
    b = traffic["batch"]
    h, w = padded(traffic)
    c = cfg["feature_channels"]
    calls = []
    for s in range(cfg["num_scales"]):
        hs, ws = counts.stride_out(h, 8 >> s), counts.stride_out(w, 8 >> s)
        k = cfg["attn_splits_list"][s]
        win = (hs // k) * (ws // k)
        calls += [(2 * b * k * k, win, win, c, c)] \
            * (2 * cfg["num_transformer_layers"])
        for radii in (cfg["corr_radius_list"], cfg["prop_radius_list"]):
            if radii[s] == -1:
                calls.append((b, hs * ws, hs * ws, c, 2))
    return calls


def norm_sizes(cfg: dict, images: int, h: int, w: int) -> list:
    """The sizes of the backbone's 15 instance norms over ``images``
    (``counts.encoder_norms``), ``layer3``'s five at 1/4 where two scales
    keep it there."""
    out = counts.encoder_norms(images, h, w)
    if cfg["num_scales"] > 1:
        out[10:] = [images * refs.ENCODER_DIMS[2] * counts.stride_out(h, 4)
                    * counts.stride_out(w, 4)] * 5
    return out


def gmflow_work(ref, cfg: dict, traffic: dict) -> dict:
    """One call's model FLOPs (``ref``'s forward) and the least time of
    each kernel's op."""
    b = traffic["batch"]
    h, w = padded(traffic)
    flops = counts.infer_flops(
        ref.param_spec(cfg),
        lambda P, W, i1, i2: ref.infer(P, W, cfg, i1, i2),
        (b, h, w, 3), (b, h, w, 3))
    return {"flops": flops, "bounds": {
        "flash_fwd": sum(bounds.flash_fwd(*s)
                         for s in flash_calls(cfg, traffic)),
        "instance_norm": sum(bounds.instance_norm(n) for n in
                             norm_sizes(cfg, 2 * b, h, w))}}


def work(cfg: dict, traffic: dict) -> dict:
    return gmflow_work(reference, cfg, traffic)


def stage_names(cfg: dict) -> list:
    """The numbers ``gmflow_stage_checks`` gives for ``cfg``."""
    names = ["flow_gap", "flow_ratio", "feature_gap", "final_far_share",
             "final_gap"]
    if cfg["num_scales"] > 1:
        names.append("refine_feature_gap")
    for kind, radii in (("matching", cfg["corr_radius_list"]),
                        ("propagation", cfg["prop_radius_list"])):
        for r in set(radii):
            stage = kind if r == -1 else f"local_{kind}"
            names += [f"{stage}_far_share", f"{stage}_gap"]
    return names


def gmflow_stage_checks(ref, cfg: dict, W: dict, pair, box: dict,
                        answer, device) -> dict:
    """The numbers that follow the program from its own state (``box``:
    ``Program.capture`` of the call that returned ``answer``; ``pair``:
    its host inputs), each stage fed what the program made before it:

    - ``feature_gap``: the first scale's transformer output against the
      reference's from the images (the backbone and the transformer),
      relative L2, worst image;
    - ``refine_feature_gap``: each later scale's, from the reference's
      backbone features, the second frame's warped by the program's flow
      so far upsampled 2x (the upsampling, the warp, the transformer);
    - ``matching_*``, ``local_matching_*``: the flow (the residual after
      the first scale) from the program's features;
    - ``propagation_*``, ``local_propagation_*``: the propagated flow from
      those features and the program's matched flow;
    - ``final_*``: the window's answer against the convex upsampling of
      the program's last flow over its last features;

    each as ``_far_share`` (the worst image's share of cells over
    ``FAR_CELLS``, pixels over ``FAR_PX`` for the final flow) and ``_gap``
    (relative L2, worst pair); and the whole-model ``flow_gap`` and
    ``flow_ratio`` of ``modes/infer.py:checks``."""
    P = precision.F32()
    got = torch.from_numpy(answer)
    i1, i2 = (torch.from_numpy(x).to(device) for x in pair)
    ns = cfg["num_scales"]
    rbox = {}
    with precision.true_f32(), torch.no_grad():
        flow = ref.infer(P, W, cfg, i1, i2, rbox)
        bf16 = ref.infer(precision.BF16(), W, cfg, i1, i2)
        out = {"flow_gap": compare.entry_gap(got, flow),
               "flow_ratio": compare.gap_ratio(got, bf16, flow)}
        del flow, bf16
        if any(len(box.get(k, ())) != ns for k in
               ("features", "matching", "propagated")):
            return dict({n: math.inf for n in stage_names(cfg)}, **out)

        def put(stage, got_, ref_, far):
            for name, value in ((f"{stage}_far_share",
                                 compare.far_share(got_, ref_, far)),
                                (f"{stage}_gap",
                                 compare.entry_gap(got_, ref_))):
                out[name] = max(out.get(name, 0.0), value)

        out["feature_gap"] = compare.entry_gap(box["features"][0],
                                               rbox["features"][0])
        prev = None
        for s in range(ns):
            f0, f1 = box["features"][s].chunk(2, 0)
            if s:
                prev = ref.upsample_flow(box["propagated"][s - 1])
                b0, b1 = rbox["backbone"][s].chunk(2, 0)
                out["refine_feature_gap"] = max(
                    out.get("refine_feature_gap", 0.0), compare.entry_gap(
                        box["features"][s], torch.cat(ref.scale_features(
                            P, W, cfg, b0, b1, prev, s), 0)))
            residual = box["matching"][s] - (0 if prev is None else prev)
            r = cfg["corr_radius_list"][s]
            if r == -1:
                put("matching", residual, ref.matching(P, f0, f1), FAR_CELLS)
            else:
                put("local_matching", residual,
                    ref.local_matching(P, f0, f1, r), FAR_CELLS)
            r = cfg["prop_radius_list"][s]
            if r == -1:
                put("propagation", box["propagated"][s],
                    ref.propagation(P, W, f0, box["matching"][s]), FAR_CELLS)
            else:
                put("local_propagation", box["propagated"][s],
                    ref.local_propagation(P, W, f0, box["matching"][s], r),
                    FAR_CELLS)
        put("final", got, ref.final_flow(P, W, cfg, box["propagated"][-1],
                                         f0), FAR_PX)
    return out


def stage_checks(cfg: dict, W: dict, pair, box: dict, answer,
                 device) -> dict:
    return gmflow_stage_checks(reference, cfg, W, pair, box, answer, device)
