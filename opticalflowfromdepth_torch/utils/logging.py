"""Training logs and sidecar files (port of
``opticalflowfromdepth_tpu/utils/logging.py``).

* :class:`Logger`: running means flushed every ``SUM_FREQ`` steps with the
  learning rate (`adjusted_RAFT/train.py:93-137`), printed as one
  ``[step n] k=v, ...`` line. The JAX package writes the same scalars to
  TensorBoard; the port appends them to ``log_dir/scalars.jsonl``, one
  JSON object per flush (the values are the same, the sink differs).
* :func:`save_args`: ``args.json`` and the invoked command
  (`adjusted_gmflow/utils/misc.py:19-37`).
* :func:`append_val_results`: markdown ``val_results.txt`` rows
  (`main.py:602-650`).

Only rank 0 writes: construct the Logger with ``enabled=(rank == 0)``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

SUM_FREQ = 100  # `train.py:47`


class Logger:
    def __init__(self, log_dir: str, enabled: bool = True,
                 sum_freq: int = SUM_FREQ):
        self.enabled = enabled
        self.sum_freq = sum_freq
        self.running: Dict[str, float] = {}
        self.count = 0
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, "scalars.jsonl")
        if enabled:
            os.makedirs(log_dir, exist_ok=True)

    def _write(self, step: int, scalars: Dict[str, float]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **scalars}) + "\n")

    def push(self, step: int, metrics: Dict[str, float],
             lr: Optional[float] = None) -> None:
        if not self.enabled:
            return
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        self.count += 1
        if self.count >= self.sum_freq:
            means = {k: v / self.count for k, v in self.running.items()}
            self._write(step, dict(means, **({} if lr is None
                                             else {"lr": lr})))
            msg = ", ".join(f"{k}={v:.4f}" for k, v in sorted(means.items()))
            print(f"[step {step}] {msg}")
            self.running = {}
            self.count = 0

    def write_dict(self, step: int, results: Dict[str, float]) -> None:
        if self.enabled:
            self._write(step, {k: float(v) for k, v in results.items()})


def save_args(log_dir: str, args) -> None:
    """args.json + command sidecars (`misc.py:19-37`)."""
    os.makedirs(log_dir, exist_ok=True)
    payload = args if isinstance(args, dict) else vars(args)
    with open(os.path.join(log_dir, "args.json"), "w") as f:
        json.dump({k: v for k, v in payload.items()
                   if isinstance(v, (int, float, str, bool, list, tuple,
                                     type(None)))}, f, indent=2)
    with open(os.path.join(log_dir, "command_train.txt"), "a") as f:
        f.write(time.strftime("%Y-%m-%d %H:%M:%S") + "\n" +
                " ".join(sys.argv) + "\n")


def append_val_results(log_dir: str, step: int,
                       results: Dict[str, float]) -> None:
    """Markdown val_results.txt table rows (`main.py:602-650`)."""
    path = os.path.join(log_dir, "val_results.txt")
    new = not os.path.exists(path)
    with open(path, "a") as f:
        if new:
            f.write("| step | " + " | ".join(sorted(results)) + " |\n")
            f.write("|---" * (len(results) + 1) + "|\n")
        f.write(f"| {step} | " + " | ".join(
            f"{results[k]:.4f}" for k in sorted(results)) + " |\n")
