"""Evaluation CLI of the port: RAFT or GMFlow inference on a frame
directory.

    python -m opticalflowfromdepth_torch.eval.cli --model raft \
        --ckpt raft-things.pth --inference_dir path/to/frames \
        --output_path output [--save_flo_flow]

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
JAX CLI; the final upsample is f32. Validators and submissions are not
ported yet.
"""

from __future__ import annotations

import argparse


def load_state_dict(path: str):
    """A torch checkpoint -> state_dict without a ``module.`` prefix."""
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in ckpt.items()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", choices=("raft", "gmflow"), required=True)
    p.add_argument("--ckpt", required=True,
                   help="torch state_dict (.pth) with the reference's names")
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
    p.add_argument("--inference_dir", required=True)
    p.add_argument("--output_path", default="output")
    p.add_argument("--paired_data", action="store_true")
    p.add_argument("--save_flo_flow", action="store_true")
    args = p.parse_args(argv)

    import torch

    from .infer import gmflow_infer_fn, raft_infer_fn
    from .inference import inference_on_dir

    if args.model == "raft":
        from ..models.raft import RAFT
        model = RAFT(small=args.small, corr_impl=args.corr_impl,
                     dtype=torch.bfloat16)
        model.load_state_dict(load_state_dict(args.ckpt), strict=True)
        infer_fn = raft_infer_fn(model, iters=args.iters, device=args.device)
    else:
        from ..models.gmflow import GMFlow
        model = GMFlow(num_scales=args.num_scales,
                       upsample_factor=args.upsample_factor,
                       dtype=torch.bfloat16)
        model.load_state_dict(load_state_dict(args.ckpt), strict=True)
        infer_fn = gmflow_infer_fn(
            model, attn_splits_list=args.attn_splits_list,
            corr_radius_list=args.corr_radius_list,
            prop_radius_list=args.prop_radius_list,
            pred_bidir_flow=args.pred_bidir_flow, device=args.device)
    n = inference_on_dir(infer_fn, args.inference_dir,
                         output_path=args.output_path,
                         padding_factor=args.padding_factor,
                         paired_data=args.paired_data,
                         save_flo_flow=args.save_flo_flow,
                         pred_bidir_flow=args.pred_bidir_flow,
                         fwd_bwd_consistency_check=(
                             args.fwd_bwd_consistency_check))
    print(f"inference of {n} pairs written to {args.output_path}")


if __name__ == "__main__":
    main()
