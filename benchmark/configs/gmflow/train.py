"""GMFlow in training cells: the program's train step built from the
benchmark's weights, the reference's loss, and the work one step does."""

from __future__ import annotations

import contextlib
import functools
import math
import statistics

import torch

from harness import bounds, cell, compare, counts, precision

reference = cell.sibling(__file__, "reference")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the port's CUDA sources this mode runs, built at set-up in parallel
KERNELS = ("flash", "flash_bwd", "instance_norm")


def build(device) -> None:
    if torch.device(device).type == "cuda":
        from opticalflowfromdepth_torch import _build
        _build.build(KERNELS)


def train_config(cfg: dict):
    """The program's ``GMFlowTrainConfig`` for this configuration."""
    from opticalflowfromdepth_torch.train.gmflow_train import \
        GMFlowTrainConfig
    t = cfg["train"]
    return GMFlowTrainConfig(
        lr=t["lr"], num_steps=t["num_steps"], wdecay=t["wdecay"],
        grad_clip=t["grad_clip"], gamma=t["gamma"],
        num_scales=cfg["num_scales"],
        feature_channels=cfg["feature_channels"],
        upsample_factor=cfg["upsample_factor"],
        num_transformer_layers=cfg["num_transformer_layers"],
        ffn_dim_expansion=cfg["ffn_dim_expansion"],
        attn_splits_list=tuple(cfg["attn_splits_list"]),
        corr_radius_list=tuple(cfg["corr_radius_list"]),
        prop_radius_list=tuple(cfg["prop_radius_list"]),
        mixed_precision=cfg["dtype"] == "bfloat16",
        add_classifier=t["add_classifier"],
        classify_loss_weight_init=t["classify_loss_weight_init"],
        classify_loss_weight_increase=t["classify_loss_weight_increase"],
        max_classify_loss_weight=t["max_classify_loss_weight"],
        min_classify_loss_weight=t["min_classify_loss_weight"])


class Program:
    """The program's state (``init_state``, then the benchmark's weights)
    and its ``make_train_step`` with the frozen classifier."""

    def __init__(self, cfg: dict, W: dict, A: dict, device) -> None:
        from opticalflowfromdepth_torch.models.classifier import Classifier
        from opticalflowfromdepth_torch.train import gmflow_train
        build(device)
        tc = train_config(cfg)
        self.state = gmflow_train.init_state(tc, seed=0, device=device)
        self.state.model.load_state_dict(W, strict=True)
        classifier = None
        if tc.add_classifier:
            c = cfg["classifier"]
            classifier = Classifier(output_dim=c["output_dim"],
                                    dtype=DTYPES[c["dtype"]])
            classifier.load_state_dict(A, strict=True)
        self.step_fn = gmflow_train.make_train_step(tc, classifier,
                                                    device=device)

    def step(self, batch: dict) -> dict:
        return self.step_fn(self.state, batch)[1]

    def params(self) -> dict:
        return dict(self.state.model.named_parameters())

    def module(self) -> torch.nn.Module:
        """The model, whose forward returns ``{"flow_preds": [...]}``."""
        return self.state.model

    def first_grads(self) -> dict:
        """Each gradient as AdamW took it, from its first moment after one
        update (``(1 - beta1) * g``)."""
        adamw = self.state.optimizer.adamw
        beta1 = adamw.param_groups[0]["betas"][0]
        return {n: adamw.state[p]["exp_avg"] / (1.0 - beta1)
                for n, p in self.state.model.named_parameters()}

    @contextlib.contextmanager
    def capture(self):
        """What the step run in the block makes, read as it passes:
        ``preds`` (the flow predictions as the model returns them, before
        any other hook), ``pred_grads`` (the gradient the loss sends each
        back), ``flow`` (the last), ``features`` (the transformer's output
        ``[2B, h, w, C]``, the first images' features, then the second's),
        ``matching`` (the matching flow that propagation takes) and
        ``propagated`` (its output), both ``[B, h, w, 2]``."""
        box = {}

        def keep_grad(i, grad):
            box["pred_grads"][i] = grad.detach().float().clone()

        def preds(_module, _inputs, out):
            flows = out["flow_preds"]
            box["preds"] = [f.detach().float().clone() for f in flows]
            box["pred_grads"] = [None] * len(flows)
            box["flow"] = box["preds"][-1]
            for i, f in enumerate(flows):
                if f.requires_grad:
                    f.register_hook(functools.partial(keep_grad, i))

        def features(_module, _inputs, out):
            box["features"] = torch.cat(out, 0).detach().float()

        def propagation(_module, inputs, out):
            box["matching"] = inputs[1].detach().float().clone()
            box["propagated"] = out.detach().float()

        model = self.state.model
        handles = [model.register_forward_hook(preds, prepend=True),
                   model.transformer.register_forward_hook(features),
                   model.feature_flow_attn.register_forward_hook(propagation)]
        try:
            yield box
        finally:
            for h in handles:
                h.remove()


def program(cfg: dict, W: dict, A: dict, device) -> Program:
    return Program(cfg, W, A, device)


def work(cfg: dict, traffic: dict) -> dict:
    """One step's model FLOPs (forward and backward of GMFlow, the frozen
    classifier's forward and input gradient) and the least time of each
    kernel's op."""
    b, h, w = traffic["batch"], traffic["height"], traffic["width"]
    batch = {"image1": (b, 3, h, w), "image2": (b, 3, h, w),
             "flow": (b, 2, h, w), "valid": (b, h, w), "label": (b, 4)}
    aux = reference.aux_spec(cfg) if cfg["train"]["add_classifier"] else []
    flops = counts.train_flops(reference.param_spec(cfg), aux, batch,
                               lambda P, A: reference.train_loss(P, cfg, A))
    c, k = cfg["feature_channels"], cfg["attn_splits_list"][0]
    h8, w8 = counts.stride_out(h, 8), counts.stride_out(w, 8)
    win = (h8 // k) * (w8 // k)
    layers = 2 * cfg["num_transformer_layers"]
    fwd, bwd = bounds.flash_fwd, bounds.flash_bwd
    return {"flops": flops, "bounds": {
        "flash_fwd": layers * fwd(2 * b * k * k, win, win, c, c)
        + 2 * fwd(b, h8 * w8, h8 * w8, c, 2),
        "flash_bwd": layers * bwd(2 * b * k * k, win, win, c, c)
        + 2 * bwd(b, h8 * w8, h8 * w8, c, 2),
        "instance_norm": sum(bounds.instance_norm(n) for n in
                             counts.encoder_norms(2 * b, h, w))}}


# a flow this far (in cells at 1/8 resolution, 8 px) from the reference is a
# different match, not a rounding of the same one
FAR_CELLS = 1.0


def stage_checks(cfg: dict, W: dict, A: dict, batch: dict, box: dict
                 ) -> dict:
    """The numbers that follow the program from its own state at the first
    step (``box``: ``Program.capture``), each stage fed what the program
    fed it: the worst image's share of 1/8-resolution cells whose matching
    flow (from the program's transformer output) and whose propagated flow
    (from those features and the program's matching flow) lie more than
    ``FAR_CELLS`` from the reference's (``matching_far_share``,
    ``propagation_far_share``), and each row's relative gap between the
    gradient the program's loss sent back to its predictions and the
    reference recipe's loss gradient at those predictions, at the worst
    row and the median row (``loss_grad_gap``, ``loss_grad_gap_median``:
    the frozen classifier's TF32 convolutions move single rows, a loss
    over half the rows moves every row)."""
    P = precision.F32()
    feats = box["features"]
    b = feats.shape[0] // 2
    with precision.true_f32(), torch.no_grad():
        matching = reference.matching(P, feats[:b], feats[b:])
        propagated = reference.propagation(P, W, feats[:b], box["matching"])
    out = {"matching_far_share": compare.far_share(box["matching"], matching,
                                                   FAR_CELLS),
           "propagation_far_share": compare.far_share(
               box["propagated"], propagated, FAR_CELLS),
           "loss_grad_gap": math.inf, "loss_grad_gap_median": math.inf}
    if box.get("pred_grads"):
        preds = [f.clone().requires_grad_(True) for f in box["preds"]]
        with precision.true_f32():
            loss = reference.recipe_loss(P, cfg, A, preds, batch, 0, {})
            grads = torch.autograd.grad(loss, preds)
        rows = compare.row_gaps(box["pred_grads"], grads)
        out["loss_grad_gap"] = max(rows)
        out["loss_grad_gap_median"] = statistics.median(rows)
    return out
