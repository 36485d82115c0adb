"""Training driver: loop, logging, validation, checkpoints (port of
``opticalflowfromdepth_tpu/train/runner.py``).

The shared skeleton of the reference's trainers
(`adjusted_RAFT/train.py:140-271`, `adjusted_gmflow/main.py:133-659`):

* each step copies a host batch to the device (``data.loader.to_device``)
  and calls the train step with the runner's ``torch.Generator``;
* running-mean logging on rank 0;
* periodic validation through pluggable validator callables;
* two checkpoints: numbered weights-only ``step_<n>_weights`` every
  ``save_ckpt_freq`` steps and the full ``latest`` every
  ``save_latest_freq`` (`main.py:502-518`), and resume from ``latest``
  (`main.py:236-253`).

The global rank (``torch.distributed``'s when it is initialized, else 0)
decides who writes logs and checkpoints: rank 0 alone. It is not the data
rank: under model parallelism every process of a model group has data
rank 0, and all of them would write the same files. Every rank trains and
validates (a model group's ranks must run the same collectives); pass
``device`` as ``parallel.mesh.init_distributed`` returns it
(``cuda:LOCAL_RANK``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import torch

from ..data.loader import to_device
from ..utils.device import resolve_device
from ..utils.logging import Logger, append_val_results
from .state import TrainState, load_checkpoint, save_checkpoint, save_weights


@dataclass
class RunnerConfig:
    log_dir: str = "runs/default"
    num_steps: int = 100000
    val_freq: int = 10000
    save_ckpt_freq: int = 10000
    save_latest_freq: int = 1000
    resume: Optional[str] = None


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class TrainRunner:
    def __init__(self, cfg: RunnerConfig, state: TrainState,
                 train_step: Callable, batches: Iterable,
                 lr_at: Optional[Callable[[int], float]] = None,
                 validators: Optional[Dict[str, Callable]] = None,
                 infer_fn_factory: Optional[Callable] = None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.state = state
        self.device = resolve_device(device)
        self.train_step = train_step
        self.batches = iter(batches)
        self.lr_at = lr_at
        self.validators = validators or {}
        self.infer_fn_factory = infer_fn_factory
        self.rank = _rank()
        self.logger = Logger(cfg.log_dir, enabled=self.rank == 0)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if cfg.resume:
            self.state = load_checkpoint(cfg.resume, self.state)
            print(f"resumed from {cfg.resume} at step {self.state.step}")

    def validate(self, step: int) -> Dict[str, float]:
        results: Dict[str, float] = {}
        if self.infer_fn_factory is None:
            return results
        infer_fn = self.infer_fn_factory(self.state)
        for name, fn in self.validators.items():
            try:
                results.update(fn(infer_fn))
            except Exception as e:  # noqa: BLE001 - a validation must never
                # end a long run: a missing or partly written dataset
                # surfaces as many kinds of error; log it and go on, like
                # the reference's corrupt-sample skip (`dataloader.py:81-91`)
                print(f"validator {name} skipped "
                      f"({type(e).__name__}): {e}")
        if results and self.rank == 0:
            self.logger.write_dict(step, results)
            append_val_results(self.cfg.log_dir, step, results)
            print(f"[val {step}] " + ", ".join(
                f"{k}={v:.4f}" for k, v in sorted(results.items())))
        return results

    def run(self) -> TrainState:
        cfg = self.cfg
        ckpt_dir = os.path.join(cfg.log_dir, "checkpoints")
        start = self.state.step
        t0 = time.time()
        for step in range(start, cfg.num_steps):
            batch = to_device(next(self.batches), self.device)
            self.state, metrics = self.train_step(self.state, batch,
                                                  self.generator)
            lr = self.lr_at(step) if self.lr_at else None
            self.logger.push(step, {k: float(v) for k, v in metrics.items()},
                             lr)

            nxt = step + 1
            if nxt % cfg.save_latest_freq == 0 and self.rank == 0:
                save_checkpoint(ckpt_dir, self.state, "latest")
            if nxt % cfg.save_ckpt_freq == 0 and self.rank == 0:
                save_weights(ckpt_dir, self.state.model,
                             name=f"step_{nxt}_weights")
            if nxt % cfg.val_freq == 0:
                self.validate(nxt)
        dt = time.time() - t0
        steps = cfg.num_steps - start
        if steps > 0:
            print(f"trained {steps} steps in {dt:.1f}s "
                  f"({steps / dt:.2f} it/s)")
        return self.state
