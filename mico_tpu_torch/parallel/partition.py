"""Sharding rules of the data-parallel path (counterpart of
`mico_tpu/parallel/partition.py`).

Data parallelism replicates the parameters and splits the batch over the
`data` axis (the reference's DDP, data/utils/build_model.py:56-57):
`batch_spec`. ZeRO-1 splits each optimizer leaf over `data` by JAX's rule
(`zero1_split_spec`, partition.py:58-81): the first dimension the
model-parallel spec leaves free that the data axis divides; a leaf with
none stays whole on every rank. The Megatron rules of tensor parallelism
(`mico_param_specs`) wait for it (ROADMAP.md, queue 1: parallelism).

A spec is a tuple with one entry per leading dimension: an axis name or
None, trailing Nones dropped (JAX's `PartitionSpec`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


def batch_spec(data_axis: str = "data") -> Tuple[str]:
    """The leading (batch) dimension over the data axis."""
    return (data_axis,)


def zero1_split_spec(shape: Sequence[int], base_spec: Sequence = (),
                     n_data: int = 1, data_axis: str = "data") -> tuple:
    """The ZeRO-1 split of a parameter-shaped leaf: `data` on the first
    dimension `base_spec` leaves free that the data axis divides (and is
    at least as long), never on a model-sharded one."""
    axes = list(base_spec) + [None] * (len(shape) - len(base_spec))
    if n_data > 1:
        for i, d in enumerate(shape):
            if axes[i] is None and d >= n_data and d % n_data == 0:
                axes[i] = data_axis
                break
    while axes and axes[-1] is None:
        axes.pop()
    return tuple(axes)


def zero1_split_dim(shape: Sequence[int], n_data: int,
                    data_axis: str = "data") -> Optional[int]:
    """The dimension `zero1_split_spec` splits over `data`, or None when
    the leaf stays whole."""
    spec = zero1_split_spec(shape, (), n_data, data_axis)
    return spec.index(data_axis) if data_axis in spec else None
