"""The process layout of a run (counterpart of `mico_tpu/parallel/mesh.py`).

JAX lays its devices out as a `Mesh` with the axes `data` and `model`
(`np.asarray(devices).reshape(data, model)`). The port runs one process per
card (the reference's torchrun/NCCL layout, data/utils/initialize.py:8-36),
so its mesh is the process group, laid out the same way: rank r has data
index r // model and model index r % model, so the ranks of a model group
are adjacent (one host, NVLink):
  data  — data parallel (the reference's only strategy; DDP's equivalent):
          `data_group`, the ranks of this rank's model index;
  model — tensor and sequence parallelism (`parallel/tensor_parallel.py`)
          or, at `pipeline_stages` > 1, the pipeline's stages
          (`parallel/pipeline_parallel.py`: stage = model index):
          `model_group`, the ranks of this rank's data index.
`mesh.group` is the data group, the handle the collectives of the loss,
the optimizer and the train step take in place of JAX's axis name (None
on one process without a group). At model 1 the data group is the default
group, as before.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch.distributed as dist

from mico_tpu_torch.parallel import collectives
from mico_tpu_torch.parallel.pipeline_parallel import StageAxis
from mico_tpu_torch.parallel.tensor_parallel import ModelAxis


@dataclass(frozen=True)
class Mesh:
    """`shape` as JAX's `mesh.shape`: {"data": d, "model": m}; `group` the
    data group, `model_group` the model group (None at model 1),
    `model_ranks` its global ranks in model-index order."""

    shape: Dict[str, int] = field(default_factory=lambda: {"data": 1,
                                                           "model": 1})
    group: Optional[object] = None
    model_group: Optional[object] = None
    model_ranks: Tuple[int, ...] = ()

    @property
    def rank(self) -> int:
        """This rank's index on the data axis (its data index)."""
        return collectives.data_axis_index(self.group)

    @property
    def model_index(self) -> int:
        return collectives.data_axis_index(self.model_group)

    @property
    def model_axis(self) -> Optional[ModelAxis]:
        """The model axis `tensor_parallel` takes (None at model 1)."""
        if self.shape["model"] == 1:
            return None
        return ModelAxis(self.model_group, self.shape["model"],
                         self.model_index)

    @property
    def stage_axis(self) -> Optional[StageAxis]:
        """The model axis as pipeline stages (None at model 1): the
        neighbours' and the last stage's global ranks are its `prev`,
        `next` and `last`."""
        if self.shape["model"] == 1:
            return None
        return StageAxis(self.model_group, self.shape["model"],
                         self.model_index, self.model_ranks)


def create_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The mesh over the processes of the default group (one process and
    no group when none is initialised). data = -1 takes every process the
    model axis leaves. Every rank calls it (the subgroups are made
    collectively)."""
    n = collectives.process_count()
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide {n} processes")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} processes")
    collectives.MODEL_PARALLEL[0] = model
    if model == 1:
        return Mesh({"data": data, "model": 1}, collectives.data_group())
    rank = dist.get_rank()
    data_group = model_group = None
    # every rank makes every subgroup, in the same order
    for j in range(model):
        g = dist.new_group([d * model + j for d in range(data)])
        if rank % model == j:
            data_group = g
    for d in range(data):
        ranks = tuple(d * model + j for j in range(model))
        g = dist.new_group(list(ranks))
        if rank // model == d:
            model_group, model_ranks = g, ranks
    return Mesh({"data": data, "model": model}, data_group, model_group,
                model_ranks)


def data_parallel_mesh() -> Mesh:
    return create_mesh(data=-1, model=1)
