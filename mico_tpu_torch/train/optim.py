"""AdamW with the reference's param groups (counterpart of
`mico_tpu/train/optim.py`), on `torch.optim.AdamW`.

Groups (data/utils/build_optimizer.py:11-99): basic @ learning_rate, the
vision tower @ clip_lr, `new_params_name` matches @ new_lr, each with a
no-decay twin for biases and LayerNorms; `frozen_prefixes` take no
gradient. The update follows the JAX package's optax chain, not torch's
defaults:
  - frozen parameters are left out before the global norm, so they do not
    count in it (`requires_grad` off);
  - `clip_by_global_norm`: the gradients are scaled by max / |g| only when
    |g| >= max, with no epsilon;
  - each group's learning rate is init_lr · schedule(count), the count of
    updates so far starting at 0 (the first warmup_linear update has rate
    0);
  - weight decay is decoupled and multiplied by the learning rate (AdamW's
    p ← p − lr·wd·p), and a parameter without a gradient this step is
    updated with a zero gradient, as JAX's dense gradients give it;
  - moments take the parameters' dtype: fp32 master weights, or
    `run_cfg.param_dtype`'s cast (bf16 parameters give bf16 moments, as
    optax's do);
  - `accum_steps` > 1 has `optax.MultiSteps`' semantics: the mean of k
    micro-batch gradients, one update every k-th call, and a schedule that
    counts updates.
On the card the update runs as torch's fused AdamW (one multi-tensor
kernel, the same rule).

Across processes (`group`, the data axis of `parallel.mesh`) the update is
the one-process update on the global batch (`mico_tpu/train/train_step.py`
computes the losses on the global batch, and its tests hold the
data-parallel step to the single-device one):
  - each rank's backward sums into its own gradients; at the last call of
    an accumulation window (and only there) they are averaged over the
    ranks and the window, so the inner micro-steps run no collective;
  - `zero1`: the ZeRO-1 split of `parallel.partition.zero1_split_spec`.
    Each rank owns one slice of every leaf that rule splits (the AdamW
    steps it, with its moments: 1/world of them a rank) and receives its
    gradient by reduce-scatter, not by an all-reduce and a slice (half the
    collective bytes, JAX's constraint at train_step.py:53-61), after
    which the whole gradient is freed; leaves the rule leaves whole are
    all-reduced and updated on every rank; after the update the slices
    are all-gathered into the parameters. The clip's norm is the global
    one: the squared norms of the owned slices summed over the ranks, plus
    the whole leaves'.
Under tensor parallelism (a model sharded by `parallel.tensor_parallel.
shard_module`) a sharded leaf's parameter, gradient and moments are this
rank's part of it: ZeRO-1 splits that part over `data`, never on the
dimension the model axis splits; the gradients are averaged over the data
group only (the ranks of a model group hold different parts, or equal
gradients of a replicated leaf, which need no collective); the clip's norm
sums the squared norms of the sharded leaves over the model group and
counts each replicated leaf once.
Under pipeline parallelism (a model staged by `parallel.pipeline_parallel.
stage_module`) a stage's blocks are whole on its ranks and absent
elsewhere: their moments are local (ZeRO-1 splits them over `data`), the
clip's norm sums their squared norms over the model group and counts each
replicated leaf once, and the gradients of the staged tower's leaves
upstream of the pipeline and of its shared table are summed over the model
group before the data group's average (`summed_names`: stage 0 alone, or
each stage's part, holds them); the leaves downstream of the pipeline hold
the same gradient on every stage and are not summed. `labels` also names
the other stages' blocks (`remote`), whose leaves the JAX package's
optimizer state holds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mico_tpu_torch.parallel import collectives
from mico_tpu_torch.parallel import pipeline_parallel as pp
from mico_tpu_torch.parallel.partition import zero1_split_dim
from mico_tpu_torch.parallel.tensor_parallel import model_axis_of, splits_of
from mico_tpu_torch.train.sched import lr_schedule_ratio

# elements of whole leaves one collective of the data-parallel step takes
BUCKET_ELEMENTS = 1 << 25


@dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 1e-4
    clip_lr: float = 5e-7
    new_lr: float = 1e-5
    new_params_name: Tuple[str, ...] = ()
    frozen_prefixes: Tuple[str, ...] = ()
    weight_decay: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-8
    grad_norm: float = 2.0
    scheduler: str = "warmup_linear"
    warmup_ratio: float = 0.1
    num_train_steps: int = 100000


def _is_no_decay(leaf_name: str) -> bool:
    n = leaf_name.lower()
    return ("bias" in n or n.endswith("_b") or n.startswith("ln")
            or "ln_" in n or n.startswith("norm") or "_ln_" in n)


def jax_path(name: str) -> Tuple[str, ...]:
    """A port parameter name as the JAX param path: the ModuleList index of
    the stacked `vision_encoder.blocks` and `bert.layers` dropped."""
    return tuple(part for part in name.split(".") if not part.isdigit())


def param_group_labels(model: nn.Module, new_params_name: Sequence[str] = (),
                       frozen_prefixes: Sequence[str] = ()) -> Dict[str, str]:
    """{parameter name: group label} by the rules of the JAX
    `param_group_labels`, read on the JAX path of each name."""
    labels = {}
    for name, _ in model.named_parameters():
        names = jax_path(name)
        if any(names[0] == p for p in frozen_prefixes):
            labels[name] = "frozen"
            continue
        nd = "_nd" if _is_no_decay(names[-1]) else ""
        if any(m in ".".join(names) for m in new_params_name):
            labels[name] = "new" + nd
        elif names[0] == "vision_encoder":
            labels[name] = "vision" + nd
        else:
            labels[name] = "basic" + nd
    return labels


class Optimizer:
    """The param-group AdamW of one model. `clip_()` then `step()` after
    the backward; `zero_grad()` before it. With `accum_steps` = k the
    backward of k calls sums into the gradients (`mini_step` counts them)
    and `accumulate()` updates on the k-th with their mean."""

    def __init__(self, model: nn.Module, cfg: OptimConfig = OptimConfig(),
                 accum_steps: int = 1, group=None, zero1: bool = False):
        self.cfg = cfg
        self.accum_steps = int(accum_steps)
        self.mini_step = 0
        self.group = group
        self.world = collectives.data_axis_size(group)
        self.rank = collectives.data_axis_index(group)
        self.zero1 = bool(zero1)
        self.labels = param_group_labels(model, cfg.new_params_name,
                                         cfg.frozen_prefixes)
        # every parameter's name (frozen ones too) and the model's config:
        # the leaf order of the JAX package's optimizer state
        # (`checkpoints.jax_optimizer_leaves`)
        self.model_cfg = getattr(model, "cfg", None)
        # the model axis and {name: (split, whole length)} of the sharded
        # parameters (empty on a whole model)
        self.model_axis = model_axis_of(model)
        self.tp_splits = splits_of(model)
        # pipeline stages: the stage axis, the other stages' block names
        # ({name: this stage's twin}, labelled as their twins), the
        # gradients the model group sums
        self.stage_axis = pp.stage_axis_of(model)
        self.remote = pp.remote_names(model)
        self.labels.update({n: self.labels[t] for n, t in self.remote.items()})
        self.shapes = {n: (p.shape, p.dtype)
                       for n, p in model.named_parameters()}
        self.shapes.update({n: self.shapes[t]
                            for n, t in self.remote.items()})
        self.summed_names = pp.summed_names(model)
        stage_owned = pp.owned_names(model)
        init_lr = {"basic": cfg.learning_rate, "vision": cfg.clip_lr,
                   "new": cfg.new_lr}
        groups: Dict[str, list] = {}
        names: Dict[str, list] = {}
        for name, p in model.named_parameters():
            label = self.labels[name]
            p.requires_grad_(label != "frozen")
            if label != "frozen":
                groups.setdefault(label, []).append(p)
                names.setdefault(label, []).append(name)
        # in torch's order of the state: group by group
        self.params = [p for ps in groups.values() for p in ps]
        self.names = [n for ns in names.values() for n in ns]
        # ZeRO-1: the dimension each leaf splits over the ranks (None: the
        # leaf stays whole), and the tensor the AdamW steps for it: the
        # parameter itself, or this rank's slice of it (a view into the
        # parameter where the slice is contiguous, a dimension-0 split;
        # else a contiguous copy)
        self.model_split = [n in self.tp_splits or n in stage_owned
                            for n in self.names]
        self.split_dims = [
            zero1_split_dim(p.shape, self.world, base_spec=self._base(n))
            if self.zero1 else None for n, p in zip(self.names, self.params)]
        self.owned = []
        for i, (p, d) in enumerate(zip(self.params, self.split_dims)):
            part = p if d is None else self.own(i, p.detach())
            self.owned.append(part if part.is_contiguous() else part.clone(
                memory_format=torch.contiguous_format))
        owned = iter(self.owned)
        fused = all(p.is_cuda for p in self.params)
        self.torch_optimizer = torch.optim.AdamW(
            [dict(params=[next(owned) for _ in ps], name=label, lr=0.0,
                  init_lr=init_lr[label.split("_")[0]],
                  weight_decay=0.0 if label.endswith("_nd")
                  else cfg.weight_decay)
             for label, ps in groups.items()],
            lr=0.0, betas=cfg.betas, eps=cfg.eps, fused=fused or None)
        self.count = 0

    def _base(self, name: str) -> tuple:
        """The model axis's spec of a parameter's part: "model" on the
        dimension it splits."""
        if name not in self.tp_splits:
            return ()
        dim = self.tp_splits[name][0][1]
        return (None,) * dim + ("model",)

    def own(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a tensor shaped as parameter i (a view; the
        tensor itself when the leaf stays whole)."""
        d = self.split_dims[i]
        if d is None:
            return full
        return full.chunk(self.world, d)[self.rank]

    def gather(self, i: int, part: torch.Tensor) -> torch.Tensor:
        """The whole of a tensor shaped as parameter i's owned slice, its
        slices gathered from every rank (collective under ZeRO-1)."""
        d = self.split_dims[i]
        if d is None:
            return part
        whole = collectives.all_gather_tensor(
            part.movedim(d, 0).contiguous(), self.group)
        return whole.movedim(0, d)

    def _rows(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """A tensor shaped as parameter i (or its owned slice) with the
        split dimension first: rank r's slice is its r-th block of rows."""
        return t.movedim(self.split_dims[i], 0)

    def _buckets(self, idx):
        """Runs of the parameter indices `idx`, one dtype a run, each at
        most BUCKET_ELEMENTS of whole leaves (or one larger leaf)."""
        by_dtype: Dict[torch.dtype, list] = {}
        for i in idx:
            by_dtype.setdefault(self.params[i].dtype, []).append(i)
        for ids in by_dtype.values():
            bucket, n = [], 0
            for i in ids:
                k = self.params[i].numel()
                if bucket and n + k > BUCKET_ELEMENTS:
                    yield bucket
                    bucket, n = [], 0
                bucket.append(i)
                n += k
            if bucket:
                yield bucket

    def _all_reduce(self, idx, group=None) -> None:
        """Sum the whole gradients of parameters `idx` over the ranks of
        `group` (the data group by default), a flat bucket a collective."""
        for b in self._buckets(idx):
            grads = [self.params[i].grad for i in b]
            flat = torch.cat([g.reshape(-1) for g in grads])
            torch.distributed.all_reduce(
                flat, group=self.group if group is None else group)
            torch._foreach_copy_(grads, [x.view_as(g) for x, g in zip(
                flat.split([g.numel() for g in grads]), grads)])

    def _reduce_scatter(self, idx) -> None:
        """Each split leaf's gradient summed over the ranks into this
        rank's slice (the owned tensor's `.grad`, in its layout: fused
        AdamW takes no other strides); the whole gradient is freed. A
        bucket is one (world, n) matrix whose row r holds rank r's slices."""
        for b in self._buckets(idx):
            rows = torch.cat([self._rows(i, self.params[i].grad).reshape(
                self.world, -1) for i in b], dim=1)
            part = collectives.reduce_scatter_tensor(rows.reshape(-1),
                                                     self.group)
            for i, piece in zip(b, part.split([self.owned[i].numel()
                                               for i in b])):
                o = self.owned[i]
                o.grad = piece.view(self._rows(i, o).shape).movedim(
                    0, self.split_dims[i]).contiguous()
                self.params[i].grad = None

    def _all_gather(self, idx) -> None:
        """The updated slices of split leaves `idx` gathered from every
        rank into the parameters, a flat bucket a collective."""
        for b in self._buckets(idx):
            flat = torch.cat([self._rows(i, self.owned[i]).reshape(-1)
                              for i in b])
            whole = collectives.all_gather_tensor(flat, self.group).view(
                self.world, -1)
            for i, cols in zip(b, whole.split([self.owned[i].numel()
                                                for i in b], dim=1)):
                p = self.params[i]
                p.copy_(cols.reshape(self._rows(i, p).shape).movedim(
                    0, self.split_dims[i]))

    def sync_grads(self) -> None:
        """The window's summed gradients → their mean over the window and
        the ranks, in the owned tensors' `.grad` (the parameters' own for
        whole leaves). A parameter no loss reached takes a zero gradient
        (JAX's dense gradients)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.summed_names:
            self._all_reduce([i for i, n in enumerate(self.names)
                              if n in self.summed_names],
                             self.stage_axis.group)
        scale = 1.0 / (self.accum_steps * self.world)
        if self.group is not None:
            self._all_reduce([i for i, d in enumerate(self.split_dims)
                              if d is None])
            self._reduce_scatter([i for i, d in enumerate(self.split_dims)
                                  if d is not None])
        if scale != 1.0:
            torch._foreach_mul_([o.grad for o in self.owned], scale)

    def clip_(self) -> torch.Tensor:
        """Scale the gradients to global norm `grad_norm` when they exceed
        it; returns the norm before clipping (fp32, on the device)."""
        for p in self.owned:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.owned]
        axis = self.model_axis or self.stage_axis
        if any(d is not None for d in self.split_dims) or axis is not None:
            # squared norms by (ZeRO-1 split over data, sharded over model)
            sq = {}
            for key in ((True, True), (True, False), (False, True),
                        (False, False)):
                mine = [g for g, d, m in zip(grads, self.split_dims,
                                             self.model_split)
                        if (d is not None, m) == key]
                sq[key] = (torch.nn.utils.get_total_norm(mine, 2.0).float()
                           ** 2 if mine else grads[0].new_zeros((),
                                                                dtype=torch.float32))
            over_data = collectives.all_reduce_sum(
                torch.stack([sq[True, True], sq[True, False]]), self.group)
            sharded = over_data[0] + sq[False, True]
            if axis is not None:
                sharded = collectives.all_reduce_sum(sharded, axis.group)
            norm = (sharded + over_data[1] + sq[False, False]).sqrt()
        else:
            norm = torch.nn.utils.get_total_norm(grads, 2.0)
        limit = self.cfg.grad_norm
        scale = torch.where(norm < limit, 1.0, limit / norm)
        torch._foreach_mul_(grads, scale.to(grads[0].dtype))
        return norm

    def lr_ratio(self) -> float:
        cfg = self.cfg
        return lr_schedule_ratio(self.count, cfg.num_train_steps,
                                 cfg.warmup_ratio, cfg.scheduler)

    def step(self) -> None:
        ratio = self.lr_ratio()
        for group in self.torch_optimizer.param_groups:
            group["lr"] = group["init_lr"] * ratio
        self.torch_optimizer.step()
        self.count += 1
        with torch.no_grad():
            self._all_gather([i for i, d in enumerate(self.split_dims)
                              if d is not None])

    def window_grad(self, name: str, g: Optional[torch.Tensor]
                    ) -> Optional[torch.Tensor]:
        """An open window's summed gradient of parameter `name` as this
        rank holds it: a leaf the model group sums (`sync_grads`) is held
        by stage 0 alone, the others hold zeros."""
        if g is None or name not in self.summed_names or (
                self.stage_axis.index == 0):
            return g
        return torch.zeros_like(g)

    def zero_grad(self) -> None:
        self.torch_optimizer.zero_grad(set_to_none=True)
        for p in self.params:
            p.grad = None

    def accumulate(self) -> Optional[torch.Tensor]:
        """After a backward: count it in the window; on its k-th, average
        the summed gradients over the window (and the ranks), clip, update
        and close the window (the next step's `zero_grad` clears them).
        → the norm before clipping when it updated, else None."""
        self.mini_step += 1
        if self.mini_step < self.accum_steps:
            return None
        self.sync_grads()
        norm = self.clip_()
        self.step()
        self.mini_step = 0
        return norm


def build_optimizer(model: nn.Module, cfg: OptimConfig = OptimConfig(),
                    accum_steps: int = 1, group=None,
                    zero1: bool = False) -> Optimizer:
    """The training entry: turns `requires_grad` on for every parameter
    outside `frozen_prefixes` and returns their optimizer (over the ranks
    of `group`, its state split by ZeRO-1 when `zero1`)."""
    return Optimizer(model, cfg, accum_steps, group=group, zero1=zero1)
