"""Flow-magnitude histogram of a training set (port of
``opticalflowfromdepth_tpu/tools/flow_range.py``).

The counterpart of `adjusted_gmflow/test_flow_range.py:5-26`, a dataset
statistics tool: iterates a stage's dataset and histograms the
ground-truth flow magnitudes of the valid pixels.

    python -m opticalflowfromdepth_torch.tools.flow_range \
        --stage augmentedredweb --redweb_shards synth/redweb --samples 200
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--stage", default="mixed")
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--redweb_shards", default=None)
    p.add_argument("--diml_shards", default=None)
    p.add_argument("--crop_size", type=int, nargs=2, default=(368, 496))
    p.add_argument("--samples", type=int, default=100)
    p.add_argument("--bins", type=int, nargs="+",
                   default=[0, 1, 5, 10, 20, 40, 80, 160, 400, 1000])
    args = p.parse_args(argv)

    from ..data.datasets import fetch_train_dataset

    shards = {}
    if args.redweb_shards:
        shards["redweb"] = args.redweb_shards
    if args.diml_shards:
        shards["diml"] = args.diml_shards
    ds = fetch_train_dataset(args.stage, tuple(args.crop_size),
                             shards_root=shards, data_root=args.data_root)

    mags = []
    n = min(args.samples, len(ds))
    for i in range(n):
        s = ds[i * max(len(ds) // n, 1) % len(ds)]
        flow, valid = s["flow"], s["valid"]
        mag = np.sqrt((flow ** 2).sum(-1))[valid >= 0.5]
        mags.append(mag)
    mag = np.concatenate(mags)
    hist, edges = np.histogram(mag, bins=args.bins)
    total = max(mag.size, 1)
    print(f"samples={n} pixels={mag.size} "
          f"mean={mag.mean():.2f} max={mag.max():.2f}")
    for lo, hi, c in zip(edges[:-1], edges[1:], hist):
        print(f"  [{lo:7.1f}, {hi:7.1f}): {c / total * 100:6.2f}%")


if __name__ == "__main__":
    main()
