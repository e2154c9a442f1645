"""Sharding rules of the data-parallel path (counterpart of
`mico_tpu/parallel/partition.py`).

Data parallelism replicates the parameters and splits the batch over the
`data` axis (the reference's DDP, data/utils/build_model.py:56-57):
`batch_spec`. ZeRO-1 splits each optimizer leaf over `data` by JAX's rule
(`zero1_split_spec`, partition.py:58-81): the first dimension the
model-parallel spec leaves free that the data axis divides; a leaf with
none stays whole on every rank. Tensor parallelism takes the Megatron
layout on the model axis (`mico_param_specs`, partition.py:23-55): on the
stacked EVA blocks and BERT layers, qkv_w / fc1_w / w1_w / w2_w, BERT's
q/k/v, xq/xk/xv and inter column-parallel (out dimension over `model`),
proj_w / fc2_w / w3_w, attn_out_w / x_out_w / out_w row-parallel (in
dimension over `model`), the column-parallel biases (and `ffn_ln`) with
their columns; everything else replicated. `parallel/tensor_parallel.py`
holds the port's layout of each leaf (`leaf_split`) and the collectives.
Under pipeline parallelism the model axis carries stages, and JAX's spec
is the replicated one (`mico_param_specs(..., model_axis=None)`, as JAX's
run.py:222-225 passes it): the stage's blocks are a layout of the port's
(`stage_range`, `block_stage`; `parallel/pipeline_parallel.py`), and
ZeRO-1 still splits over `data`.

A spec is a tuple with one entry per leading dimension: an axis name or
None, trailing Nones dropped (JAX's `PartitionSpec`).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

# JAX's name sets (partition.py:23-27)
COL = {"qkv_w", "fc1_w", "w1_w", "w2_w", "q_w", "k_w", "v_w", "xq_w", "xk_w",
       "xv_w", "inter_w"}
COL_BIAS = {"q_bias", "v_bias", "fc1_b", "w1_b", "w2_b", "q_b", "k_b", "v_b",
            "xq_b", "xk_b", "xv_b", "inter_b", "ffn_ln_w", "ffn_ln_b"}
ROW = {"proj_w", "fc2_w", "w3_w", "attn_out_w", "x_out_w", "out_w"}


def mico_param_specs(named_params: Iterable[Tuple[str, Sequence[int]]],
                     model_axis: Optional[str] = "model",
                     is_eva: bool = True) -> Dict[str, tuple]:
    """{port parameter name: JAX's spec of its leaf} for (name, shape)
    pairs (a model's `named_parameters()` will do): JAX's rule on the JAX
    leaf, where a block of the EVA tower or of BERT counts as the stacked
    leaf it came from, and the towers JAX keeps as lists of per-block
    dicts (CLIP's blocks, Swin, BEATs, AST) replicate by JAX's 2-D rule.
    `is_eva`: the vision tower is an EVA (its blocks stacked)."""
    from mico_tpu_torch.parallel.tensor_parallel import is_stacked, jax_spec

    return {name: jax_spec(name, tuple(getattr(p, "shape", p)), model_axis,
                           is_stacked(name, is_eva))
            for name, p in named_params}


def stage_range(layers: int, stages: int, stage: int) -> Tuple[int, int]:
    """[start, stop) of the blocks pipeline stage `stage` owns: an equal
    run of `layers` / `stages` blocks (JAX's `split_layers`,
    pipeline_parallel.py:128-134); the caller checks that they divide."""
    per = layers // stages
    return stage * per, (stage + 1) * per


def block_stage(i: int, layers: int, stages: int) -> int:
    """The pipeline stage that owns block i of `layers`."""
    return i // (layers // stages)


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
                    data_axis: str = "data",
                    base_spec: Sequence = ()) -> Optional[int]:
    """The dimension `zero1_split_spec` splits over `data`, or None when
    the leaf stays whole; `base_spec` marks the dimension the model axis
    splits, which `data` never takes."""
    spec = zero1_split_spec(shape, base_spec, n_data, data_axis)
    return spec.index(data_axis) if data_axis in spec else None
