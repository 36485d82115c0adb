"""Data parallelism over ``torch.distributed`` and the sequence-parallel
ring (port of ``opticalflowfromdepth_tpu/parallel/``)."""

from .mesh import (ProcessMesh, all_reduce_mean_,  # noqa: F401
                   init_distributed, make_mesh)
from .sequence import (LocalRing, group_size,  # noqa: F401
                       matching_rows, ring_softmax_matmul,
                       sharded_global_matching)
