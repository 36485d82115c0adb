"""End-to-end convergence check: synthesis -> shards -> loader -> training
-> held-out EPE (port of ``opticalflowfromdepth_tpu/tools/
convergence_smoke.py``).

Every layer of the port with no external dataset: procedural images and
depths are synthesized into real npz shards (``synthesize_sample_packed``,
``ShardWriter``), streamed through ``AugmentedShards`` and ``Loader``
into RAFT-small (RAFT-basic with ``--basic``, GMFlow with ``--model
gmflow``) for a few hundred steps, and the EPE on held-out pairs
(``synthesize_group`` on other images) must drop materially.
``--with_classifier`` first trains the auxiliary classifier on the
synthesized flows, freezes it, and trains the flow model with its
annealed cross-entropy (the paper's recipe).

    python -m opticalflowfromdepth_torch.tools.convergence_smoke \
        --steps 300 --images 8

bf16 on the card, f32 on the CPU (``--device cpu``). Prints one JSON line
and exits 0 only if the final EPE is below ``epe_ratio`` times the
initial one (and, with the classifier, its held-out accuracy is above
0.5). Per image the synthesis draws come from ``torch.Generator().
manual_seed(seed + i)``, so the port's shards differ from the JAX tool's
(its draws are keyed): hold the two to the criterion, not to the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import List, Tuple

import numpy as np


def procedural_sample(rng: np.random.Generator, h: int, w: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """A textured image + smooth depth (no external data needed).

    The image mixes random low-frequency sinusoid gratings with blob noise
    so the matcher has texture to correlate; depth is a smooth surface with
    a few depth discontinuities (fronto-parallel blobs), the structure the
    virtual-stereo synthesis turns into parallax.
    """
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((3, h, w), np.float32)
    for ch in range(3):
        acc = np.zeros((h, w), np.float32)
        for _ in range(6):
            fx, fy = rng.uniform(0.02, 0.3, 2)
            ph = rng.uniform(0, 2 * np.pi)
            acc += rng.uniform(10, 40) * np.sin(fx * xx + fy * yy + ph)
        img[ch] = 128 + acc
    img += rng.uniform(-10, 10, (3, h, w))

    depth = 150 + 60 * np.sin(xx / rng.uniform(40, 90)) \
        * np.cos(yy / rng.uniform(40, 90))
    for _ in range(3):  # foreground blobs = parallax discontinuities
        cy, cx = rng.uniform(0.2, 0.8, 2) * (h, w)
        r = rng.uniform(0.1, 0.25) * min(h, w)
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < r ** 2
        depth = np.where(blob, rng.uniform(40, 80), depth)
    return np.clip(img, 0, 255), depth[None].astype(np.float32)


def _tensor(a: np.ndarray, device):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def synthesize_shards(out_dir: str, n_images: int, h: int, w: int,
                      seed: int = 0, device="cuda") -> int:
    """``n_images`` procedural images through the synthesis on ``device``
    into ``out_dir``; returns the number of files written."""
    import torch

    from ..synth.pipeline import draw_sample, synthesize_sample_packed
    from ..synth.writer import ShardWriter

    rng = np.random.default_rng(seed)
    writer = ShardWriter(out_dir, workers=4)
    for i in range(n_images):
        img, dep = procedural_sample(rng, h, w)
        draws = draw_sample(torch.Generator().manual_seed(seed + i), h, w)
        out = synthesize_sample_packed(_tensor(img, device),
                                       _tensor(dep, device), draws)
        writer.submit(f"smoke{i}", {k: v.cpu().numpy()
                                    for k, v in out.items()})
    return writer.drain()


def heldout_pairs(n: int, h: int, w: int, seed: int = 99, device="cuda"
                  ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Unaugmented (img0, img1, flow01) NHWC pairs straight off the
    synthesis group, never seen in training (other images and draws)."""
    import torch

    from ..core.rng import GroupDraws, draw_group
    from ..synth.pipeline import synthesize_group

    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        img, dep = procedural_sample(rng, h, w)
        g = draw_group(torch.Generator().manual_seed(seed + i))
        p0 = synthesize_group(_tensor(img, device), _tensor(dep, device),
                              GroupDraws(*(t.to(device) for t in g)))[0]
        pairs.append(tuple(np.moveaxis(t.cpu().numpy(), 0, -1)
                           for t in (p0.img_a, p0.img_b, p0.flow_ab)))
    return pairs


def main(argv=None) -> dict:
    """Runs the check; returns the result dict (also printed as JSON) when
    it passes, else exits with code 1."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=("raft", "gmflow"), default="raft")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--crop_h", type=int, default=96)
    ap.add_argument("--crop_w", type=int, default=128)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--epe_ratio", type=float, default=0.7,
                    help="final EPE must be < ratio * initial EPE")
    ap.add_argument("--shard_dir", default=None,
                    help="reuse/keep shards here (default: temp dir)")
    ap.add_argument("--with_classifier", action="store_true",
                    help="drive the paper's signature recipe end to end "
                         "(`adjusted_RAFT/train.py:155-168,196-203`, "
                         "README.md:109-115): train the aux classifier on "
                         "the synthesized flows, freeze it, then train the "
                         "flow model WITH the annealed classifier CE")
    ap.add_argument("--classifier_steps", type=int, default=200)
    ap.add_argument("--basic", action="store_true",
                    help="RAFT-basic instead of RAFT-small (the mixed "
                         "recipe's model, `README.md:109-115`)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain path")
    args = ap.parse_args(argv)

    import torch

    from ..data.datasets import AugmentedShards
    from ..data.loader import Loader, to_device
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    tmp = None
    shard_dir = args.shard_dir
    if shard_dir is None:
        tmp = tempfile.TemporaryDirectory()
        shard_dir = tmp.name

    t0 = time.time()
    os.makedirs(shard_dir, exist_ok=True)
    if not os.listdir(shard_dir):
        n = synthesize_shards(shard_dir, args.images, args.height,
                              args.width, device=device)
        print(f"synthesized {args.images} images -> {n} shard files "
              f"in {time.time() - t0:.1f}s", flush=True)

    crop = (args.crop_h, args.crop_w)
    loader = Loader(AugmentedShards(shard_dir, crop_size=crop, seed=0),
                    batch_size=args.batch_size, num_workers=4,
                    process_index=0, process_count=1, seed=0)
    mixed = device.type == "cuda"      # bf16 on the card, f32 on the CPU

    # ---- phase 1 (--with_classifier): train + freeze the aux classifier
    # on the synthesized ground-truth flows, the capability the reference
    # only ships weights for (`README.md:113-114`) ----------------------
    classifier = None
    cls_metrics = {}
    if args.with_classifier:
        from ..train import classifier_train as ct

        ccfg = ct.ClassifierTrainConfig(
            batch_size=args.batch_size * 2, num_steps=args.classifier_steps,
            image_size=crop, mixed_precision=mixed)
        cstate = ct.init_state(ccfg, seed=11, device=device)
        cstep = ct.make_train_step(ccfg)
        ceval = ct.make_eval_step(ccfg)
        cgen = torch.Generator(device=device).manual_seed(1000)
        cit = iter(Loader(AugmentedShards(shard_dir, crop_size=crop, seed=7),
                          batch_size=ccfg.batch_size, num_workers=4,
                          process_index=0, process_count=1, seed=7))
        eval_batches = [to_device(next(cit), device) for _ in range(4)]

        def cls_acc(s):
            return float(np.mean([float(ceval(s, b)["accuracy"])
                                  for b in eval_batches]))

        acc0 = cls_acc(cstate)
        t1 = time.time()
        for i in range(args.classifier_steps):
            cstate, m = cstep(cstate, to_device(next(cit), device), cgen)
            if (i + 1) % 50 == 0:
                print(f"classifier step {i + 1}: "
                      f"loss {float(m['loss']):.3f} "
                      f"acc {float(m['accuracy']):.3f}", flush=True)
        cit.close()
        acc1 = cls_acc(cstate)
        print(f"classifier held-batch accuracy {acc0:.3f} -> {acc1:.3f} "
              f"({time.time() - t1:.1f}s; chance = 0.25)", flush=True)
        cls_metrics = {"classifier_acc_initial": round(acc0, 3),
                       "classifier_acc_final": round(acc1, 3)}
        classifier = cstate.model      # frozen from here on

    if args.model == "raft":
        from ..eval.infer import raft_infer_fn
        from ..train.raft_train import (RAFTTrainConfig, init_state,
                                        make_train_step)
        cfg = RAFTTrainConfig(small=not args.basic, iters=args.iters,
                              lr=args.lr, num_steps=args.steps,
                              batch_size=args.batch_size, image_size=crop,
                              mixed_precision=mixed,
                              add_classifier=args.with_classifier)

        def infer_of(s):
            return raft_infer_fn(s.model, iters=args.iters, device=device)
    else:
        from ..eval.infer import gmflow_infer_fn
        from ..train.gmflow_train import (GMFlowTrainConfig, init_state,
                                          make_train_step)
        cfg = GMFlowTrainConfig(lr=args.lr, num_steps=args.steps,
                                batch_size=args.batch_size, image_size=crop,
                                mixed_precision=mixed,
                                add_classifier=args.with_classifier)

        def infer_of(s):
            return gmflow_infer_fn(s.model, (2,), (-1,), (-1,),
                                   device=device)
    state = init_state(cfg, seed=0, device=device)
    step = make_train_step(cfg, classifier, device=device)

    held = heldout_pairs(4, args.height, args.width, device=device)

    def eval_epe(s) -> float:
        infer = infer_of(s)
        epes = [float(np.linalg.norm(infer(i0[None], i1[None])[0] - gt,
                                     axis=-1).mean())
                for i0, i1, gt in held]
        return float(np.mean(epes))

    epe0 = eval_epe(state)
    print(f"initial held-out EPE: {epe0:.3f} px", flush=True)

    it = iter(loader)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.time()
    first_cls = last_cls = None
    for i in range(args.steps):
        state, metrics = step(state, to_device(next(it), device), gen)
        if "classify_loss" in metrics:
            last_cls = float(metrics["classify_loss"])
            if first_cls is None:
                first_cls = last_cls
        if (i + 1) % 50 == 0:
            extra = (f" cls {last_cls:.3f}" if last_cls is not None else "")
            print(f"step {i + 1}: loss {float(metrics['total_loss']):.3f} "
                  f"epe {float(metrics['epe']):.3f}{extra}", flush=True)
    it.close()
    dt = time.time() - t0
    fps = args.steps * args.batch_size / dt

    epe1 = eval_epe(state)
    result = {"initial_epe": round(epe0, 3), "final_epe": round(epe1, 3),
              "steps": args.steps, "train_frames_per_s": round(fps, 2),
              "ok": epe1 < args.epe_ratio * epe0}
    result.update(cls_metrics)
    if first_cls is not None:
        result["classify_loss_first"] = round(first_cls, 3)
        result["classify_loss_last"] = round(last_cls, 3)
        # the frozen classifier must have learned the flow classes; the CE
        # regularizer rides along for the whole flow training
        result["ok"] = bool(result["ok"]) and \
            cls_metrics.get("classifier_acc_final", 0.0) > 0.5
    print(json.dumps(result), flush=True)
    if tmp is not None:
        tmp.cleanup()
    if not result["ok"]:
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main()
