"""The process layout of a run (counterpart of `mico_tpu/parallel/mesh.py`).

JAX lays its devices out as a `Mesh` with the axes `data` and `model`. The
port runs one process per card (the reference's torchrun/NCCL layout,
data/utils/initialize.py:8-36), so its mesh is the process group:
  data  — data parallel (the reference's only strategy; DDP's equivalent),
          over every process of the default group;
  model — tensor parallelism (no reference equivalent): only 1 is ported.
`mesh.group` is the handle the collectives and the train step take in
place of JAX's axis name (None on one process without a group).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from mico_tpu_torch.parallel import collectives

TENSOR_PARALLEL = ("tensor parallelism (model > 1): not ported yet "
                   "(ROADMAP.md, queue 1: parallelism)")


@dataclass(frozen=True)
class Mesh:
    """`shape` as JAX's `mesh.shape`: {"data": processes, "model": 1}."""

    shape: Dict[str, int] = field(default_factory=lambda: {"data": 1,
                                                           "model": 1})
    group: Optional[object] = None

    @property
    def rank(self) -> int:
        return collectives.data_axis_index(self.group)


def create_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The mesh over the processes of the default group (one process and
    no group when none is initialised). data = -1 takes every process."""
    if model != 1:
        raise NotImplementedError(TENSOR_PARALLEL)
    n = collectives.process_count()
    if data == -1:
        data = n
    if data != n:
        raise ValueError(f"mesh {data}x{model} != {n} processes")
    return Mesh({"data": data, "model": model}, collectives.data_group())


def data_parallel_mesh() -> Mesh:
    return create_mesh(data=-1, model=1)
