"""Parallelism across processes (counterpart of `mico_tpu/parallel/`): the
process mesh of `data` × `model`, the collectives on `torch.distributed`,
the ZeRO-1 split, and on the model axis tensor and sequence parallelism
(`tensor_parallel`) or GPipe pipeline parallelism of the EVA tower
(`pipeline_parallel`)."""

from mico_tpu_torch.parallel.collectives import (
    all_gather_concat,
    all_gather_no_grad,
    data_axis_index,
    data_axis_size,
)
from mico_tpu_torch.parallel.mesh import create_mesh, data_parallel_mesh
from mico_tpu_torch.parallel.partition import (batch_spec, mico_param_specs,
                                               zero1_split_spec)
