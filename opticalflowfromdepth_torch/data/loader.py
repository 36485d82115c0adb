"""Input pipeline: shuffling, batching, prefetch, per-rank sharding, and
the host-to-device copy (port of ``opticalflowfromdepth_tpu/data/
loader.py``).

* :class:`Loader`: an infinite shuffled batch iterator over a dataset of
  dict-of-numpy samples, with a thread pool (numpy and zlib release the
  GIL) and a bounded prefetch queue. Each rank reads indices
  ``rank::world_size`` of every epoch's permutation, the
  DistributedSampler equivalent (epoch-seeded like ``set_epoch``). Rank
  and world size are the arguments (a ``parallel.mesh.ProcessMesh``'s
  data rank and data world: under model parallelism the processes of a
  model group read the same batch), else ``torch.distributed``'s when it
  is initialized, else 0 and 1.
* :func:`to_device`: the NHWC numpy batch -> the NCHW tensors the train
  step takes, copied from pinned host memory.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def collate(samples) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys
            if not isinstance(samples[0][k], (str, tuple, list))}


def _rank_and_world(rank: Optional[int], world: Optional[int]):
    if rank is not None and world is not None:
        return rank, world
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return (0 if rank is None else rank), (1 if world is None else world)


class Loader:
    """Infinite shuffled loader; one epoch = one seeded permutation."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.pi, self.pc = _rank_and_world(process_index, process_count)
        if batch_size % self.pc:
            raise ValueError(f"batch_size {batch_size} is not a multiple of "
                             f"the world size {self.pc}")
        self.local_batch = batch_size // self.pc
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch

    def _index_stream(self) -> Iterator[int]:
        epoch = 0
        n = len(self.dataset)
        while True:
            if self.shuffle:
                # every rank draws the same permutation and takes a
                # disjoint stride
                order = np.random.default_rng(
                    self.seed + epoch).permutation(n)
            else:
                order = np.arange(n)
            yield from order[self.pi::self.pc]
            epoch += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx_stream = self._index_stream()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> None:
            # a put with a stop check: a plain q.put would block forever
            # once the consumer abandons the generator
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    while not stop.is_set():
                        idxs = [next(idx_stream)
                                for _ in range(self.local_batch)]
                        put(collate(list(pool.map(
                            lambda i: self.dataset[int(i)], idxs))))
            except Exception as e:  # noqa: BLE001 - handed to the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            try:                      # unblock a producer mid-put
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)


STEP_KEYS = ("image1", "image2", "flow", "valid", "label")


def to_device(batch: Dict[str, np.ndarray], device
              ) -> Dict[str, torch.Tensor]:
    """The train step's tensors from a collated NHWC batch: image1/image2
    ``[B, 3, H, W]``, flow ``[B, 2, H, W]``, valid ``[B, H, W]``, label
    ``[B, 4]``, all f32 on ``device``. For a CUDA device the arrays go
    through pinned host memory and are copied without blocking."""
    device = torch.device(device)
    pin = device.type == "cuda"
    out = {}
    for k in STEP_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
        if pin:
            t = t.pin_memory()
        t = t.to(device, non_blocking=pin)
        if t.dim() == 4:
            t = t.permute(0, 3, 1, 2).contiguous()
        out[k] = t
    return out
