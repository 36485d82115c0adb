"""Evaluation CLI of the port: validation, benchmark submissions and
inference on a frame directory, for RAFT or GMFlow (the
`adjusted_RAFT/evaluate.py` / `adjusted_gmflow` eval entry point).

    # validation: prints the metrics as JSON
    python -m opticalflowfromdepth_torch.eval.cli --model raft \
        --ckpt raft-things.pth --val sintel kitti --data_root datasets \
        [--sintel_dstype final] [--with_speed_metric] [--count_time] \
        [--evaluate_matched_unmatched]

    # submissions
    python -m opticalflowfromdepth_torch.eval.cli --model raft --ckpt ... \
        --submission sintel --warm_start --output_path sintel_submission
    python -m opticalflowfromdepth_torch.eval.cli --model gmflow --ckpt ... \
        --padding_factor 16 --submission kitti --output_path kitti_submission

    # inference on a frame directory
    python -m opticalflowfromdepth_torch.eval.cli --model gmflow \
        --ckpt gmflow_things.pth --inference_dir path/to/frames \
        --padding_factor 16 --pred_bidir_flow --fwd_bwd_consistency_check

    # GMFlow with refinement
    ... --model gmflow --num_scales 2 --upsample_factor 4 \
        --attn_splits_list 2 8 --corr_radius_list -1 4 \
        --prop_radius_list -1 1 --padding_factor 32

``--ckpt`` is a torch ``state_dict`` with the reference's key names (a
released reference ``.pth``, a ``{'model': state_dict}`` file, or a
DataParallel ``module.``-prefixed one). The model runs in bf16 like the
JAX CLI; the final upsample is f32. ``--device`` is ``cuda`` unless
``cpu`` is asked for; without a card ``cuda`` raises. ``--val`` takes
chairs, things, sintel, kitti, kitti12 and finetunekitti15; the datasets
are read under ``--data_root`` in the reference's layout (``Sintel/``,
``KITTI/``, ...).
"""

from __future__ import annotations

import argparse
import json


def load_state_dict(path: str):
    """A torch checkpoint -> state_dict without a ``module.`` prefix."""
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in ckpt.items()}


def main(argv=None) -> dict:
    """Runs what the arguments ask for; returns the validation metrics
    (empty without ``--val``)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", choices=("raft", "gmflow"), required=True)
    p.add_argument("--ckpt", required=True,
                   help="torch state_dict (.pth) with the reference's names")
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--val", nargs="*", default=[])
    p.add_argument("--sintel_dstype", default="clean")
    p.add_argument("--with_speed_metric", action="store_true")
    p.add_argument("--count_time", action="store_true")
    p.add_argument("--evaluate_matched_unmatched", action="store_true",
                   help="matched/unmatched EPE via Sintel occlusion maps")
    p.add_argument("--iters", type=int, default=24)
    p.add_argument("--small", action="store_true")
    p.add_argument("--corr_impl", choices=("pyramid", "fused"),
                   default="fused",
                   help="'fused' (the CUDA lookup kernel on the card) or "
                        "'pyramid' (dense volume, plain PyTorch)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    p.add_argument("--num_scales", type=int, default=1)
    p.add_argument("--upsample_factor", type=int, default=8)
    p.add_argument("--attn_splits_list", type=int, nargs="+", default=[2])
    p.add_argument("--corr_radius_list", type=int, nargs="+", default=[-1])
    p.add_argument("--prop_radius_list", type=int, nargs="+", default=[-1])
    p.add_argument("--pred_bidir_flow", action="store_true")
    p.add_argument("--fwd_bwd_consistency_check", action="store_true")
    p.add_argument("--padding_factor", type=int, default=8)
    p.add_argument("--inference_dir", default=None)
    p.add_argument("--output_path", default="output")
    p.add_argument("--paired_data", action="store_true")
    p.add_argument("--save_flo_flow", action="store_true")
    p.add_argument("--submission", choices=("sintel", "kitti"), default=None)
    p.add_argument("--warm_start", action="store_true")
    args = p.parse_args(argv)
    if args.warm_start and args.model != "raft":
        p.error("--warm_start starts each Sintel frame from the previous "
                "pair's low-res flow, which only RAFT returns")

    import torch

    from . import validators as V
    from .infer import gmflow_infer_fn, raft_infer_fn
    from .inference import inference_on_dir
    from .submission import create_kitti_submission, create_sintel_submission

    if args.model == "raft":
        from ..models.raft import RAFT
        model = RAFT(small=args.small, corr_impl=args.corr_impl,
                     dtype=torch.bfloat16)
        model.load_state_dict(load_state_dict(args.ckpt), strict=True)
        infer_fn = raft_infer_fn(model, iters=args.iters, device=args.device)
        warm_fn = raft_infer_fn(model, iters=args.iters, with_low_res=True,
                                device=args.device)
    else:
        from ..models.gmflow import GMFlow
        model = GMFlow(num_scales=args.num_scales,
                       upsample_factor=args.upsample_factor,
                       dtype=torch.bfloat16)
        model.load_state_dict(load_state_dict(args.ckpt), strict=True)
        lists = dict(attn_splits_list=args.attn_splits_list,
                     corr_radius_list=args.corr_radius_list,
                     prop_radius_list=args.prop_radius_list,
                     device=args.device)
        infer_fn = gmflow_infer_fn(model, **lists)
        warm_fn = infer_fn          # the Sintel writer takes its one output
        if args.pred_bidir_flow:
            infer_fn = gmflow_infer_fn(model, pred_bidir_flow=True, **lists)

    results = {}
    for name in args.val:
        kwargs = dict(root=args.data_root,
                      padding_factor=args.padding_factor)
        if name == "sintel":
            kwargs.update(dstype=args.sintel_dstype,
                          with_speed_metric=args.with_speed_metric,
                          count_time=args.count_time,
                          evaluate_matched_unmatched=(
                              args.evaluate_matched_unmatched))
        results.update(V.VALIDATORS[name](infer_fn, **kwargs))
    if results:
        print(json.dumps(results, indent=2))

    if args.inference_dir:
        n = inference_on_dir(infer_fn, args.inference_dir,
                             output_path=args.output_path,
                             padding_factor=args.padding_factor,
                             paired_data=args.paired_data,
                             save_flo_flow=args.save_flo_flow,
                             pred_bidir_flow=args.pred_bidir_flow,
                             fwd_bwd_consistency_check=(
                                 args.fwd_bwd_consistency_check))
        print(f"inference of {n} pairs written to {args.output_path}")

    if args.submission == "sintel":
        create_sintel_submission(warm_fn, root=args.data_root,
                                 output_path=args.output_path,
                                 warm_start=args.warm_start,
                                 padding_factor=args.padding_factor)
    elif args.submission == "kitti":
        create_kitti_submission(infer_fn, root=args.data_root,
                                output_path=args.output_path,
                                padding_factor=args.padding_factor)
    return results


if __name__ == "__main__":
    main()
