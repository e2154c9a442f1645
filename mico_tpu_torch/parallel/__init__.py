"""Data parallelism across processes (counterpart of `mico_tpu/parallel/`):
the process mesh, the collectives on `torch.distributed` and the ZeRO-1
split. Tensor, sequence and pipeline parallelism are not ported (ROADMAP.md,
queue 1: parallelism)."""

from mico_tpu_torch.parallel.collectives import (
    all_gather_concat,
    all_gather_no_grad,
    data_axis_index,
    data_axis_size,
)
from mico_tpu_torch.parallel.mesh import create_mesh, data_parallel_mesh
from mico_tpu_torch.parallel.partition import batch_spec, zero1_split_spec
