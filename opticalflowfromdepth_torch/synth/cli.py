"""Synthesis CLI: depth datasets -> npz training shards (port of
``opticalflowfromdepth_tpu/synth/cli.py``; the reference's
`preprocess.py:508-561`).

    python -m opticalflowfromdepth_torch.synth.cli --dataset DIML \\
        --data_root datasets/DIML --list_file DIML_list.txt \\
        --out synth_out/diml --split 4 --split_id 0 --epochs 2

Each image is resized to ``--height`` x ``--width`` (default 384x512)
and synthesized on ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions). Per image the draws come from a CPU generator seeded with
``--seed + idx + epoch * len`` (the reference's ``set_seed(12345 + idx +
epoch * len)``), so they do not depend on ``--split`` nor on the device.
While the card synthesizes image i, image i-1 is copied to the host on a
stream of its own and handed to the writer's threads.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def _to_host(out: Dict[str, torch.Tensor], done: Optional[torch.cuda.Event],
             stream) -> Dict[str, np.ndarray]:
    """The packed sample on the host. On the card: copies into pinned
    buffers on ``stream`` once the image's work (``done``) has run, so
    they overlap the next image's synthesis."""
    if stream is None:
        return {k: v.numpy() for k, v in out.items()}
    host = {}
    stream.wait_event(done)
    with torch.cuda.stream(stream):
        for k, v in out.items():
            if v.device.type == "cpu":
                host[k] = v.numpy()
                continue
            buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            buf.copy_(v, non_blocking=True)
            host[k] = buf.numpy()
    stream.synchronize()
    return host


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Runs the CLI; returns what it did: ``images``, ``files``,
    ``seconds`` (host clock), ``device``, and per image ``synth_ms`` (on
    the card: CUDA events around its synthesis), ``d2h_ms`` (host clock of
    its copy to the host); ``write_s`` (the writer's seconds, summed over
    its threads) and ``write_wait_s`` (the seconds this thread waited for
    the writer)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--dataset", choices=("ReDWeb", "DIML"), required=True)
    p.add_argument("--data_root", default=None,
                   help="dataset dir (default: datasets/<name>)")
    p.add_argument("--list_file", default=None,
                   help="image list (default: <dataset>_list.txt)")
    p.add_argument("--out", required=True, help="output shard dir")
    p.add_argument("--split", type=int, default=1,
                   help="number of index shards (`preprocess.py:543-547`)")
    p.add_argument("--split_id", type=int, default=0)
    p.add_argument("--epochs", type=int, default=2,
                   help="synthesis epochs over the list (`preprocess.py:552`)")
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--limit", type=int, default=None,
                   help="stop after N images (smoke runs)")
    p.add_argument("--write_workers", type=int, default=4,
                   help="npz writer threads (compression releases the GIL)")
    p.add_argument("--deflate_floats", action="store_true",
                   help="deflate f16/int16 tensors too (stored raw by "
                        "default: their bits barely compress)")
    p.add_argument("--flow_int16", action="store_true",
                   help="store flows as int16 fixed point (1/64 px, the "
                        "KITTI encoding), +-511.98 px; larger flows clip "
                        "with a warning")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..data.source import SOURCES, _resize_chw
    from ..utils.device import resolve_device
    from .pipeline import draw_sample, synthesize_sample_packed
    from .writer import ShardWriter

    device = resolve_device(args.device)
    kwargs = {}
    if args.data_root:
        kwargs["dataset_dir"] = args.data_root
    if args.list_file:
        kwargs["list_file"] = args.list_file
    ds = SOURCES[args.dataset](**kwargs)
    n = len(ds)
    lo = n * args.split_id // args.split
    hi = n * (args.split_id + 1) // args.split
    print(f"{args.dataset}: {n} images, shard [{lo}, {hi}) "
          f"({args.split_id + 1}/{args.split}) on {device}", flush=True)

    h, w = args.height, args.width
    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None
    writer = ShardWriter(args.out, workers=args.write_workers,
                         flow_int16=args.flow_int16,
                         store_floats=not args.deflate_floats)
    stats = {"synth_ms": [], "d2h_ms": []}
    events = []
    pending = None      # (stem, device outputs, done event)

    def flush(item):
        stem, out, done = item
        t = time.perf_counter()
        host = _to_host(out, done, copy_stream)
        stats["d2h_ms"].append((time.perf_counter() - t) * 1e3)
        writer.submit(stem, host)

    def as_input(arr):
        x = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        return x.pin_memory().to(device, non_blocking=True) if on_card else x

    done = 0
    t_start = time.perf_counter()
    for epoch in range(args.epochs):
        for idx in range(lo, hi):
            if args.limit is not None and done >= args.limit:
                break
            s = ds[idx]
            img = as_input(_resize_chw(s.img0, (h, w)))
            dep = as_input(_resize_chw(s.depth_or_disp, (h, w)))
            gen = torch.Generator().manual_seed(args.seed + idx + epoch * n)
            draws = draw_sample(gen, h, w)
            t0 = time.perf_counter()
            if on_card:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            out = synthesize_sample_packed(img, dep, draws,
                                           is_stereo=s.is_stereo)
            if on_card:
                end.record()
                events.append((start, end))
            else:
                stats["synth_ms"].append((time.perf_counter() - t0) * 1e3)
            # image i is enqueued: fetch image i-1 while the card works
            if pending is not None:
                flush(pending)
            pending = (f"{s.name}_e{epoch}", out, end if on_card else None)
            done += 1
            print(f"[{done}] {s.name} epoch {epoch}: enqueued in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
        if args.limit is not None and done >= args.limit:
            break
    if pending is not None:
        flush(pending)
    nfiles = writer.drain()
    dt = time.perf_counter() - t_start
    if on_card:
        torch.cuda.synchronize(device)
        stats["synth_ms"] = [a.elapsed_time(b) for a, b in events]
    print(f"done: {done} images ({nfiles} files) in {dt:.1f}s "
          f"({done / max(dt, 1e-9):.2f} img/s)", flush=True)
    return {"images": done, "files": nfiles, "seconds": dt,
            "device": str(device), "write_s": writer.write_s,
            "write_wait_s": writer.wait_s, **stats}


if __name__ == "__main__":
    main()
