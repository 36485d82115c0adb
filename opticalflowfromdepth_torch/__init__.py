"""opticalflowfromdepth_torch — the PyTorch/CUDA port for NVIDIA Hopper.

The port of ``opticalflowfromdepth_tpu`` (which stays as the reference it
is tested against). This package imports ``torch`` and never JAX.

Layers mirror the JAX package:
  core/     geometry helpers
  ops/      correlation, sampling, and the hand-written Hopper kernels
            (``fused_corr`` forward and backward in CUDA C++,
            ``instance_norm`` in Triton), as autograd Functions
  models/   RAFT, its encoders and the classifier (NCHW ``nn.Module``s)
  train/    losses, optimizer and schedule, checkpoints, the RAFT train
            step and the runner
  eval/     padding, inference functions, directory inference, CLI
  data/     synthesized-shard dataset, loader, frame IO
  utils/    flow colorization, training logs, the device of entry points

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where every kernel wrapper uses its plain PyTorch version.
"""

__version__ = "0.1.0"
