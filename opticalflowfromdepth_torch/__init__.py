"""opticalflowfromdepth_torch — the PyTorch/CUDA port for NVIDIA Hopper.

The port of ``opticalflowfromdepth_tpu`` (which stays as the reference it
is tested against). This package imports ``torch`` and never JAX.

Layers mirror the JAX package:
  core/     geometry helpers
  ops/      correlation, sampling, and the hand-written Hopper kernels
            (``fused_corr`` in CUDA C++, ``instance_norm`` in Triton)
  models/   RAFT and its encoders (NCHW ``nn.Module``s)
  eval/     padding, inference functions, directory inference, CLI
  data/     frame IO
  utils/    flow colorization

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where every kernel wrapper uses its plain PyTorch version.
"""

__version__ = "0.1.0"
