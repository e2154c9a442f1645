"""Tensor and sequence parallelism on the `model` axis: what GSPMD inserts
for the JAX package's Megatron layout (`mico_tpu/parallel/partition.py`),
written out for one process a rank.

JAX keeps one program and lets GSPMD split it by the specs of
`mico_param_specs`; the port runs each rank's share and places the
collectives itself:
  - column-parallel input (`copy_to_model`): identity forward, sum over the
    model group backward (each rank's columns see the whole input);
  - row-parallel output (`reduce_from_model`): sum over the model group
    forward, identity backward (its consumers are replicated);
  - condition tokens sharded over the model group (`scatter_sequence`:
    this rank's block forward, all-gather backward) and gathered again at a
    cross-attention (`gather_sequence`: all-gather forward, reduce-scatter
    backward); a length the group does not divide is padded to ceil-sized
    blocks, as GSPMD pads it, and trimmed after the gather;
  - `sharded_layer_norm`: a LayerNorm over a dimension TP splits (EVA02's
    `ffn_ln` over the MLP hidden, `inner_attn_ln` over the head-sharded
    attention output), its mean and variance from sums over the group.

The port's layout of a sharded leaf (`leaf_split`) follows JAX's spec with
two differences:
  - the fused `qkv_w` (and a folded `qkv_bias`) splits by heads: each rank
    holds its heads' columns of q, of k and of v, packed [q_h | k_h | v_h],
    so that attention runs on whole local heads (JAX's spec cuts the 3W
    columns contiguously and GSPMD keeps the result right);
  - what a head-sharded input reaches is split with the heads: sub-LN's
    `inner_attn_ln` and the relative-position tables' head columns (JAX
    replicates them).
`mico_param_specs` (`parallel/partition.py`) reports JAX's spec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from mico_tpu_torch.parallel import collectives

# leaves split with the heads beyond JAX's spec: name → dimension
_HEAD_LEAVES = {"inner_attn_ln_w": 0, "inner_attn_ln_b": 0,
                "rel_pos_bias_table": 1}


@dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the model axis: the group (None on one
    process), its size and this rank's index in it."""

    group: Optional[object]
    size: int
    index: int


# ---------------------------------------------------------------------------
# splits of a dimension
# ---------------------------------------------------------------------------


def block_range(n: int, size: int, index: int) -> Tuple[int, int]:
    """[start, stop) of block `index` when n splits into `size` ceil-sized
    blocks (GSPMD's padding: the last blocks may be shorter, or empty)."""
    c = -(-n // size)
    return min(n, index * c), min(n, (index + 1) * c)


def split_block(t: torch.Tensor, dim: int, size: int,
                index: int) -> torch.Tensor:
    a, b = block_range(t.shape[dim], size, index)
    return t.narrow(dim, a, b - a)


def split_qkv(t: torch.Tensor, dim: int, size: int,
              index: int) -> torch.Tensor:
    """This rank's heads of a fused [q | k | v] dimension: its block of
    each third, packed [q_h | k_h | v_h]."""
    return torch.cat([split_block(p, dim, size, index)
                      for p in t.chunk(3, dim)], dim)


def join_qkv(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The inverse of `split_qkv` over every rank's part: [q_all | k_all |
    v_all], not the parts in rank order."""
    thirds = [p.chunk(3, dim) for p in parts]
    return torch.cat([torch.cat([t[j] for t in thirds], dim)
                      for j in range(3)], dim)


# ---------------------------------------------------------------------------
# the port's layout of a parameter
# ---------------------------------------------------------------------------


def jax_spec(name: str, shape: Sequence[int], model_axis: Optional[str],
             stacked: bool) -> tuple:
    """JAX's `_spec_for` (partition.py:34-44) on the JAX leaf of a port
    parameter: a block leaf of a stacked tower counts as the 3-D (2-D for
    a vector) leaf it came from. Trailing Nones dropped."""
    from mico_tpu_torch.parallel.partition import COL, COL_BIAS, ROW

    leaf = name.rpartition(".")[2]
    ndim = len(shape) + (1 if stacked else 0)
    if model_axis is None:
        return ()
    if leaf in COL and ndim == 3:
        return (None, None, model_axis)
    if leaf in COL_BIAS and ndim == 2:
        return (None, model_axis)
    if leaf in ROW and ndim == 3:
        return (None, model_axis)
    return ()


def is_stacked(name: str, is_eva: bool) -> bool:
    """A block of a tower JAX stacks over depth (EVA's `blocks`, BERT's
    `layers`): the towers that take the Megatron layout."""
    return name.startswith("bert.layers.") or (
        is_eva and name.startswith("vision_encoder.blocks."))


def leaf_split(name: str, shape: Sequence[int],
               is_eva: bool) -> Optional[Tuple[str, int]]:
    """How the port splits a parameter over the model axis: ("qkv", dim)
    by heads of a fused q|k|v dimension, ("block", dim) in ceil-sized
    blocks, or None (replicated)."""
    leaf = name.rpartition(".")[2]
    if is_eva and name.startswith("vision_encoder.") and (
            leaf == "rel_pos_bias_table"):
        return ("block", 1)       # per-block and the shared table
    if not is_stacked(name, is_eva):
        return None
    if leaf in ("qkv_w", "qkv_bias"):
        return ("qkv", len(shape) - 1)
    if leaf in _HEAD_LEAVES:
        return ("block", _HEAD_LEAVES[leaf])
    spec = jax_spec(name, shape, "model", True)
    if "model" not in spec:
        return None
    return ("block", spec.index("model") - 1)


def shard(t: torch.Tensor, split: Optional[Tuple[str, int]],
          axis: ModelAxis) -> torch.Tensor:
    """This rank's part of a whole leaf (a view where it can be)."""
    if split is None or axis.size == 1:
        return t
    kind, dim = split
    fn = split_qkv if kind == "qkv" else split_block
    return fn(t, dim, axis.size, axis.index)


def unshard(parts: Sequence[torch.Tensor],
            split: Optional[Tuple[str, int]]) -> torch.Tensor:
    """The whole leaf from every rank's part, in rank order."""
    if split is None or len(parts) == 1:
        return parts[0]
    kind, dim = split
    return join_qkv(parts, dim) if kind == "qkv" else torch.cat(parts, dim)


def gather_leaf(t: torch.Tensor, split: Optional[Tuple[str, int]],
                length: int, axis: Optional[ModelAxis]) -> torch.Tensor:
    """The whole leaf of this rank's part, gathered over the model group
    (collective: every rank of the group calls it). `length`: the whole
    leaf's length along a block split, whose parts may differ (an uneven
    hidden): they are padded to the longest for the gather."""
    if axis is None or axis.size == 1 or split is None:
        return t
    dim = split[1]
    n = t.shape[dim]
    lens = ([n] * axis.size if split[0] == "qkv" else
            [b - a for a, b in (block_range(length, axis.size, r)
                                for r in range(axis.size))])
    top = max(lens)
    x = t.detach().movedim(dim, 0)
    if n < top:
        x = torch.cat([x, x.new_zeros((top - n,) + tuple(x.shape[1:]))])
    whole = collectives.all_gather_tensor(x.contiguous(), axis.group)
    parts = [p[:k].movedim(0, dim) for p, k in zip(whole.split(top), lens)]
    return unshard(parts, split)


# ---------------------------------------------------------------------------
# the collectives of the forward, with their backward
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, taken in fp32 and rounded once to x's
    dtype (a bf16 gradient's partials are not rounded at each add)."""
    out = x.float().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumPartials(torch.autograd.Function):
    """A sum of partials whose result the ranks consume locally (a
    statistic of a sharded dimension): all-reduce both ways."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def copy_to_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """The input of a column-parallel layer."""
    if axis is None or axis.size == 1 or not torch.is_grad_enabled():
        return x
    return _CopyToModel.apply(x, axis.group)


def reduce_from_model(x: torch.Tensor,
                      axis: Optional[ModelAxis]) -> torch.Tensor:
    """The output of a row-parallel layer: this rank's partial summed."""
    if axis is None or axis.size == 1:
        return x
    return _ReduceFromModel.apply(x, axis.group)


def sum_partials(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _SumPartials.apply(x, axis.group)


def _pad_to(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    if x.shape[dim] == n:
        return x
    shape = list(x.shape)
    shape[dim] = n - x.shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim)


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's equal-length x concatenated along `dim`."""
    out = collectives.all_gather_tensor(x.movedim(dim, 0).contiguous(), group)
    return out.movedim(0, dim)


def _scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ranks of this rank's block along `dim`."""
    out = collectives.reduce_scatter_tensor(x.movedim(dim, 0).contiguous(),
                                            group)
    return out.movedim(0, dim)


class _ScatterSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.length = dim, axis, x.shape[dim]
        c = -(-x.shape[dim] // axis.size)
        return _pad_to(x, dim, c * axis.size).narrow(
            dim, axis.index * c, c).contiguous()

    @staticmethod
    def backward(ctx, g):
        whole = _gather_dim(g, ctx.dim, ctx.axis.group)
        return whole.narrow(ctx.dim, 0, ctx.length), None, None


class _GatherSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, length, axis):
        ctx.dim, ctx.axis, ctx.c = dim, axis, x.shape[dim]
        return _gather_dim(x, dim, axis.group).narrow(dim, 0, length)

    @staticmethod
    def backward(ctx, g):
        g = _pad_to(g, ctx.dim, ctx.c * ctx.axis.size)
        return _scatter_dim(g, ctx.dim, ctx.axis.group), None, None, None


class SequenceShard:
    """This rank's block of a token-sharded tensor (`local`, the tokens
    along `dim`) and the whole length, which the gather trims back to."""

    __slots__ = ("local", "length", "dim", "axis")

    def __init__(self, local, length: int, dim: int, axis: ModelAxis):
        self.local, self.length, self.dim, self.axis = local, length, dim, axis

    def map(self, fn) -> "SequenceShard":
        """fn on the local block (an op on the other dimensions)."""
        return SequenceShard(fn(self.local), self.length, self.dim, self.axis)

    def gather(self) -> torch.Tensor:
        return _GatherSequence.apply(self.local, self.dim, self.length,
                                     self.axis)


def scatter_sequence(x: torch.Tensor, dim: int,
                     axis: Optional[ModelAxis]):
    """x (replicated over the model group) → its token-sharded form; x
    itself at model 1."""
    if axis is None or axis.size == 1:
        return x
    return SequenceShard(_ScatterSequence.apply(x, dim, axis), x.shape[dim],
                         dim, axis)


def seq_map(fn, x):
    """fn on a tensor, or on the local block of a `SequenceShard`."""
    return x.map(fn) if isinstance(x, SequenceShard) else fn(x)


def seq_cat(xs):
    """torch.cat along the batch of tensors or of `SequenceShard`s."""
    if isinstance(xs[0], SequenceShard):
        return xs[0].map(lambda _: torch.cat([x.local for x in xs]))
    return torch.cat(xs)


# ---------------------------------------------------------------------------
# LayerNorm over a split dimension
# ---------------------------------------------------------------------------


def sharded_layer_norm(x: torch.Tensor, weight, bias, eps: float,
                       n: int, axis: Optional[ModelAxis]) -> torch.Tensor:
    """LayerNorm of x (..., n_local) over the whole dimension of n, its
    parts on the model group: fp32 statistics, the mean and then the
    (two-pass) variance from sums over the group, the affine of this
    rank's part, one rounding to x's dtype. At model 1 it is
    `ops.layers.layer_norm`."""
    from mico_tpu_torch.ops.layers import layer_norm

    if axis is None or axis.size == 1:
        return layer_norm(x, weight, bias, eps)
    xf = x.float()
    mean = sum_partials(xf.sum(-1, keepdim=True), axis) / n
    var = sum_partials((xf - mean).square().sum(-1, keepdim=True), axis) / n
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.to(x.dtype).float() + bias.to(x.dtype).float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# sharding a model
# ---------------------------------------------------------------------------


def check_heads(cfg, size: int) -> None:
    """ValueError when `size` does not divide a sharded tower's heads: a
    head cannot split in the port's kernels."""
    towers = [("bert", cfg.bert_config.num_attention_heads)]
    if cfg.is_eva:
        towers.append((f"vision_encoder ({cfg.vision_encoder_type})",
                       cfg.vision_tower_config.num_heads))
    for tower, heads in towers:
        if heads % size:
            raise ValueError(
                f"tensor parallelism: the {tower} tower's {heads} heads do "
                f"not divide over model={size} (a head cannot split)")


def model_axis_of(model: nn.Module) -> Optional[ModelAxis]:
    return getattr(model, "tp", None)


def splits_of(model: nn.Module) -> Dict[str, tuple]:
    """{parameter name: (split, the whole length along it)} of a sharded
    model ({} when whole)."""
    return getattr(model, "tp_splits", {})


def shard_module(model: nn.Module, axis: Optional[ModelAxis]) -> nn.Module:
    """In place: each sharded leaf of a whole MiCo replaced by this rank's
    part (a copy; the whole is freed), the model axis recorded on the
    model and on every module holding a sharded leaf (`tp`: the blocks
    read it), and the split of every sharded parameter (`tp_splits`). A
    no-op at model 1."""
    if axis is None or axis.size == 1:
        return model
    cfg = model.cfg
    check_heads(cfg, axis.size)
    splits = {}
    with torch.no_grad():
        for mname, mod in model.named_modules():
            for pname, p in list(mod._parameters.items()):
                full = f"{mname}.{pname}" if mname else pname
                split = leaf_split(full, p.shape, cfg.is_eva)
                if split is None:
                    continue
                part = shard(p.data, split, axis).clone()
                mod._parameters[pname] = nn.Parameter(
                    part, requires_grad=p.requires_grad)
                splits[full] = (split, p.shape[split[1]])
                mod.tp = axis
    model.tp = axis
    model.tp_splits = splits
    return model


def local_part(model: nn.Module, name: str,
               full: torch.Tensor) -> torch.Tensor:
    """This rank's part of a whole leaf of parameter `name` (a checkpoint's
    leaf, a moment): the leaf itself when the parameter is whole."""
    split = splits_of(model).get(name)
    if split is None:
        return full
    return shard(full, split[0], model_axis_of(model))


def whole_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The state_dict in JAX's full layout: every sharded leaf gathered
    over the model group (collective: every rank of the group calls it)."""
    sd = model.state_dict()
    axis = model_axis_of(model)
    splits = splits_of(model)
    if axis is None or not splits:
        return sd
    return {k: gather_leaf(v, *splits[k], axis) if k in splits else v
            for k, v in sd.items()}


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor],
                        axis: Optional[ModelAxis]) -> torch.Tensor:
    """x (..., K_local) · weight (K_local, N) on this rank's rows, summed
    over the model group in fp32, + bias once, rounded once to x's dtype
    (the whole-width `ops.layers.linear` rounds once). `linear` at model
    1."""
    from mico_tpu_torch.ops.layers import linear, matmul_f32

    if axis is None or axis.size == 1:
        return linear(x, weight, bias)
    y = matmul_f32(x.reshape(-1, x.shape[-1]), weight)
    return finish_partial(y.reshape(*x.shape[:-1], weight.shape[1]), bias,
                          axis, x.dtype)


def finish_partial(y: torch.Tensor, bias: Optional[torch.Tensor],
                   axis: Optional[ModelAxis], dtype) -> torch.Tensor:
    """An fp32 partial of a row-parallel product (a rank's share; K8's
    partial form) summed over the model group, + bias in fp32, rounded once
    to `dtype`."""
    y = reduce_from_model(y, axis)
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)
