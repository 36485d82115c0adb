"""Training CLI of the port (the `adjusted_RAFT/train.py` /
`adjusted_gmflow/main.py` entry point; port of
``opticalflowfromdepth_tpu/train/cli.py``).

    python -m opticalflowfromdepth_torch.train.cli --model raft \\
        --stage mixed --redweb_shards synth/redweb --diml_shards synth/diml \\
        --num_steps 120000 --batch_size 8 --lr 2.5e-4 \\
        --add_classifier --classifier_ckpt classifier.pth \\
        --val kitti --log_dir runs/raft_mixed

The reference's recipes (`README.md:109-130`): stage-keyed data through
``data.datasets.fetch_train_dataset`` (``mixed``: the ReDWeb and DIML
shards, re-augmented), the frozen classifier's annealed cross-entropy,
periodic validation, the ``latest`` and ``step_<n>_weights``
checkpoints, resume. RAFT defaults to batch 8 of 368x496, 12 iterations,
bf16 and OneCycle-linear; GMFlow (``--model gmflow``) to full width, batch
16 of 368x560, 1 scale and OneCycle-cosine, both over ``num_steps + 100``.

``--classifier_ckpt`` and ``--restore_weights`` take torch ``state_dict``
files under the reference's names (the classifier's as
``train/classifier_train.py`` writes it, or the reference's released
``.pth``); ``--resume`` takes this CLI's ``checkpoints/latest.pth``.
``--device`` is ``cuda`` unless ``cpu`` is asked for; without a card
``cuda`` raises. The CLI is one process on one card: training over
several cards is not ported yet.
"""

from __future__ import annotations

import argparse
import os


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", choices=("raft", "gmflow"), required=True)
    p.add_argument("--stage", default="mixed",
                   help="chairs|things|sintel|kitti|finetunekitti15|"
                        "augmentedredweb|augmenteddiml|mixed|depthtoflow")
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--redweb_shards", default=None)
    p.add_argument("--diml_shards", default=None)
    p.add_argument("--log_dir", default="runs/default")
    p.add_argument("--num_steps", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--image_size", type=int, nargs=2, default=None)
    p.add_argument("--iters", type=int, default=12, help="RAFT GRU iters")
    p.add_argument("--small", action="store_true")
    p.add_argument("--no_mixed_precision", action="store_true")
    p.add_argument("--freeze_bn", action="store_true")
    p.add_argument("--add_noise", action="store_true")
    p.add_argument("--num_scales", type=int, default=1)
    p.add_argument("--upsample_factor", type=int, default=8)
    p.add_argument("--attn_splits_list", type=int, nargs="+", default=[2])
    p.add_argument("--corr_radius_list", type=int, nargs="+", default=[-1])
    p.add_argument("--prop_radius_list", type=int, nargs="+", default=[-1])
    p.add_argument("--add_classifier", action="store_true")
    p.add_argument("--classifier_ckpt", default=None,
                   help="the frozen classifier's state_dict (.pth)")
    p.add_argument("--classify_loss_weight_init", type=float, default=1.0)
    p.add_argument("--classify_loss_weight_increase", type=float,
                   default=-2e-5)
    p.add_argument("--max_classify_loss_weight", type=float, default=1.0)
    p.add_argument("--min_classify_loss_weight", type=float, default=0.0)
    p.add_argument("--val", nargs="*", default=[],
                   help="validators: chairs things sintel kitti kitti12 "
                        "finetunekitti15")
    p.add_argument("--val_freq", type=int, default=10000)
    p.add_argument("--save_ckpt_freq", type=int, default=10000)
    p.add_argument("--save_latest_freq", type=int, default=1000)
    p.add_argument("--resume", default=None,
                   help="a latest.pth to continue from (weights, optimizer "
                        "and step)")
    p.add_argument("--restore_weights", default=None,
                   help="weights-only warm start (stage chaining)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    return p


def main(argv=None):
    """Trains as the arguments ask; returns the final ``TrainState``."""
    args = build_argparser().parse_args(argv)

    from ..data.datasets import fetch_train_dataset
    from ..data.loader import Loader
    from ..eval import validators as V
    from ..eval.cli import load_state_dict
    from ..eval.infer import raft_infer_fn
    from ..utils.device import resolve_device
    from ..utils.logging import save_args
    from .optim import one_cycle_schedule
    from .runner import RunnerConfig, TrainRunner

    device = resolve_device(args.device)
    save_args(args.log_dir, args)

    mixed_precision = not args.no_mixed_precision
    shards = {}
    if args.redweb_shards:
        shards["redweb"] = args.redweb_shards
    if args.diml_shards:
        shards["diml"] = args.diml_shards

    # the frozen classifier (`train.py:155-168`)
    classifier = None
    if args.add_classifier:
        from ..models.classifier import Classifier
        if not args.classifier_ckpt:
            raise SystemExit("--add_classifier needs --classifier_ckpt")
        classifier = Classifier()
        classifier.load_state_dict(load_state_dict(args.classifier_ckpt),
                                   strict=True)

    if args.model == "raft":
        from .raft_train import RAFTTrainConfig, init_state, make_train_step
        image_size = tuple(args.image_size or (368, 496))
        cfg = RAFTTrainConfig(
            lr=args.lr or 2.5e-4, num_steps=args.num_steps,
            batch_size=args.batch_size, image_size=image_size,
            iters=args.iters, small=args.small,
            mixed_precision=mixed_precision, add_noise=args.add_noise,
            freeze_bn=args.freeze_bn, add_classifier=args.add_classifier,
            classify_loss_weight_init=args.classify_loss_weight_init,
            classify_loss_weight_increase=args.classify_loss_weight_increase,
            max_classify_loss_weight=args.max_classify_loss_weight,
            min_classify_loss_weight=args.min_classify_loss_weight)
        schedule = one_cycle_schedule(cfg.lr, cfg.num_steps + 100,
                                      anneal_strategy="linear")

        def infer_fn_factory(state):
            return raft_infer_fn(state.model, iters=24, device=device)
    else:
        from .gmflow_train import (GMFlowTrainConfig, init_state,
                                   make_train_step)
        from .gmflow_train import infer_fn_factory as gmflow_factory
        image_size = tuple(args.image_size or (368, 560))
        cfg = GMFlowTrainConfig(
            lr=args.lr or 4e-4, num_steps=args.num_steps,
            batch_size=args.batch_size, image_size=image_size,
            num_scales=args.num_scales,
            upsample_factor=args.upsample_factor,
            attn_splits_list=tuple(args.attn_splits_list),
            corr_radius_list=tuple(args.corr_radius_list),
            prop_radius_list=tuple(args.prop_radius_list),
            mixed_precision=mixed_precision,
            add_classifier=args.add_classifier,
            classify_loss_weight_init=args.classify_loss_weight_init,
            classify_loss_weight_increase=args.classify_loss_weight_increase,
            max_classify_loss_weight=args.max_classify_loss_weight,
            min_classify_loss_weight=args.min_classify_loss_weight)
        schedule = one_cycle_schedule(cfg.lr, cfg.num_steps + 100,
                                      anneal_strategy="cos")
        infer_fn_factory = gmflow_factory(cfg, device)
    state = init_state(cfg, seed=args.seed, device=device)
    step_fn = make_train_step(cfg, classifier, device=device)

    # `{num_params}_parameters` sidecar (`adjusted_gmflow/main.py:226-228`):
    # the model's size at a glance, next to args.json
    num_params = sum(p.numel() for p in state.model.parameters())
    open(os.path.join(args.log_dir, f"{num_params}_parameters"),
         "w").close()
    print(f"model parameters: {num_params}")

    if args.restore_weights:
        state.model.load_state_dict(load_state_dict(args.restore_weights),
                                    strict=True)
        print(f"warm-started weights from {args.restore_weights}")

    dataset = fetch_train_dataset(args.stage, image_size,
                                  shards_root=shards,
                                  data_root=args.data_root,
                                  seed=args.seed)
    loader = Loader(dataset, batch_size=args.batch_size,
                    num_workers=args.num_workers, seed=args.seed)

    validators = {}
    for name in args.val:
        fn = V.VALIDATORS[name]
        validators[name] = (lambda f, _fn=fn: _fn(f, root=args.data_root))

    runner = TrainRunner(
        RunnerConfig(log_dir=args.log_dir, num_steps=args.num_steps,
                     val_freq=args.val_freq,
                     save_ckpt_freq=args.save_ckpt_freq,
                     save_latest_freq=args.save_latest_freq,
                     resume=args.resume),
        state, step_fn, loader, lr_at=schedule, validators=validators,
        infer_fn_factory=infer_fn_factory, seed=args.seed, device=device)
    try:
        return runner.run()
    finally:
        runner.batches.close()       # stops the loader's threads


if __name__ == "__main__":
    main()
