"""GPipe pipeline parallelism of the EVA tower over the `model` axis
(counterpart of `mico_tpu/parallel/pipeline_parallel.py`).

JAX runs one program: `pipelined` shard_maps a `lax.scan` of n_micro + S − 1
ticks over the stage axis, a `ppermute` hops the activations to the next
stage, a `psum` broadcasts the last stage's tape, and autodiff of the scan
gives GPipe's fill-drain backward. The port runs one process a stage and
writes the schedule out (`_GPipe`, one `torch.autograd.Function`):
  - forward: stage s takes microbatch m at tick m + s: it receives it from
    stage s − 1 (stage 0 takes its rows of the embedded tokens), applies
    its blocks, keeps the microbatch's graph (built under `enable_grad`
    when autograd records) and sends the result on to s + 1;
  - the last stage's microbatches, concatenated, are broadcast over the
    model group. Every rank runs what follows on the same tokens, as JAX's
    replicated program does, so every rank builds the same graph and
    enters each pipeline's backward in the same order;
  - backward: the microbatches in reverse order. Each stage receives the
    output gradient from s + 1 (the last stage takes its own copy of the
    broadcast's gradient: every rank holds the same one, and it is not
    summed), back-propagates the microbatch's saved graph and sends the
    input gradient to s − 1. Stage 0 returns the embedded tokens'
    gradient, the other stages zeros.
Under `no_grad` the forward alone runs and keeps nothing.

Layout (`stage_module`): stage s owns blocks [s·L/S, (s+1)·L/S) whole
(every head, no Megatron split), under their global names
(`vision_encoder.blocks.{i}`, which the optimizer's JAX paths, the
checkpoints and `mico_from_jax` read); another stage's block leaves an
`OtherStage` in its place, which holds nothing. Everything else is
replicated on every rank of the model group, as JAX's `model_axis=None`
leaves it. The leaves upstream of the pipeline (the patch embedding,
`cls_token`, `pos_embed`) take their gradient on stage 0 alone, and the
shared relative-position table takes a part on every stage: the optimizer
sums them over the model group (`summed_names`). The leaves downstream of
the broadcast (the final norm, BERT, the heads) hold the same gradient on
every rank and are not summed. The towers JAX does not stage (CLIP, Swin,
VideoSwin, the audio towers; mico.py:150-166) run whole on every stage.

The hops go through `collectives.send`/`recv`: the card's tensors on the
model group under NCCL, pinned host memory under gloo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mico_tpu_torch.parallel import collectives
from mico_tpu_torch.parallel.partition import block_stage, stage_range
from mico_tpu_torch.parallel.tensor_parallel import ModelAxis
from mico_tpu_torch.utils.logger import LOGGER

_BLOCKS = "vision_encoder.blocks."
# a staged tower's leaves outside its blocks whose gradient the model
# group sums: upstream of the pipeline, or shared by every stage's blocks
_SUMMED = ("patch_embed.", "cls_token", "pos_embed", "rel_pos_bias_table")


@dataclass(frozen=True)
class StageAxis(ModelAxis):
    """The model axis as pipeline stages: also the model group's global
    ranks in stage order, the ends of the hops."""

    ranks: Tuple[int, ...] = ()

    @property
    def prev(self) -> Optional[int]:
        return self.ranks[self.index - 1] if self.index > 0 else None

    @property
    def next(self) -> Optional[int]:
        return (self.ranks[self.index + 1] if self.index + 1 < self.size
                else None)

    @property
    def last(self) -> int:
        return self.ranks[-1]


# ---------------------------------------------------------------------------
# microbatches (pipeline_parallel.py:79-157)
# ---------------------------------------------------------------------------


def auto_n_micro(batch: int, n_stages: int) -> int:
    """The largest divisor of `batch` that is <= 2·n_stages: the fill-drain
    bubble (S−1)/(S+M−1) stays under about a third, and no microbatch is
    empty."""
    for m in range(min(2 * n_stages, batch), 0, -1):
        if batch % m == 0:
            return m
    return 1


def n_micro_for(n_micro: Optional[int], batch: int, n_stages: int) -> int:
    """`n_micro`, checked against the rank's batch (JAX's ValueError), or
    `auto_n_micro` for None."""
    if n_micro is None:
        return auto_n_micro(batch, n_stages)
    if n_micro > batch or batch % n_micro:
        raise ValueError(
            f"pipeline_microbatches={n_micro} must divide the per-shard "
            f"batch {batch} (and be <= it); use pipeline_microbatches=None "
            f"to auto-pick the largest divisor <= 2*stages")
    return n_micro


def bubble(n_stages: int, n_micro: int) -> float:
    """The fill-drain schedule's idle share of a stage."""
    return (n_stages - 1) / (n_stages + n_micro - 1)


@functools.lru_cache(maxsize=64)
def _log_schedule(n_stages: int, n_micro: int, batch: int) -> None:
    """The schedule's log line, once a shape (JAX logs it as it traces)."""
    LOGGER.info("pipeline: %d stages x %d microbatches of %d, bubble %.2f",
                n_stages, n_micro, batch // n_micro,
                bubble(n_stages, n_micro))


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


class _Schedule:
    """One pipelined call: the stage's layer function and blocks, the row
    arguments split with the microbatches, and the graphs the backward
    replays."""

    def __init__(self, layer_fn, blocks, rows, axis: StageAxis, n_micro: int,
                 grad: bool):
        self.layer_fn, self.blocks, self.rows = layer_fn, blocks, rows
        self.axis, self.n_micro, self.grad = axis, n_micro, grad
        self.saved = []

    def rows_of(self, m: int, mb: int) -> list:
        return [None if r is None else r[m * mb:(m + 1) * mb]
                for r in self.rows]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sched: _Schedule):
        axis, nm = sched.axis, sched.n_micro
        first, last = axis.index == 0, axis.index == axis.size - 1
        mb = x.shape[0] // nm
        xs = x.detach().split(mb)
        outs, sends = [], []
        for m in range(nm):
            h = xs[m] if first else collectives.recv(xs[m], axis.prev,
                                                     axis.group)
            if sched.grad:
                h = h.detach().requires_grad_(True)
            with torch.enable_grad() if sched.grad else (
                    contextlib.nullcontext()):
                y = sched.layer_fn(sched.blocks, h, *sched.rows_of(m, mb))
            if y.shape != h.shape:
                raise ValueError(f"a pipeline stage maps {tuple(h.shape)} "
                                 f"to {tuple(y.shape)}; its shape must stay")
            if sched.grad:
                sched.saved.append((h, y))
            if last:
                outs.append(y.detach())
            else:
                sends.append(collectives.send(y.detach(), axis.next,
                                              axis.group))
        for s in sends:
            s.wait()
        out = torch.cat(outs) if last else torch.empty_like(
            x, memory_format=torch.contiguous_format)
        ctx.sched = sched
        return collectives.broadcast(out, axis.last, axis.group)

    @staticmethod
    def backward(ctx, g):
        sched = ctx.sched
        axis, nm = sched.axis, sched.n_micro
        first, last = axis.index == 0, axis.index == axis.size - 1
        gs = g.split(g.shape[0] // nm)
        grads, sends = [None] * nm, []
        for m in reversed(range(nm)):
            h, y = sched.saved[m]
            sched.saved[m] = None
            gy = gs[m] if last else collectives.recv(y, axis.next,
                                                     axis.group)
            torch.autograd.backward(y, gy)
            if first:
                grads[m] = h.grad
            else:
                sends.append(collectives.send(h.grad, axis.prev, axis.group))
            del h, y
        for s in sends:
            s.wait()
        ctx.sched = None
        return (torch.cat(grads) if first else torch.zeros_like(g)), None


def pipelined(layer_fn: Callable, axis: StageAxis,
              n_micro: Optional[int] = None) -> Callable:
    """f(stage_blocks, x, *rows) running `layer_fn(stage_blocks, h, *rows_m)`
    as an `axis.size`-stage GPipe pipeline over microbatches of x's leading
    (batch) dimension: x (B, ...) the same on every stage (stage 0 reads
    it), `rows` tensors (or None) whose leading dimension is x's, split
    with it; → the last stage's output (B, ...) on every stage.
    `layer_fn` applies this stage's blocks and keeps the shape.
    n_micro=None picks `auto_n_micro(B, S)`; an explicit n_micro must
    divide B (ValueError). Differentiable: every stage's blocks get their
    gradients, x its gradient on stage 0 (zeros on the others); every rank
    of the model group calls f, in the same order."""

    def f(stage_blocks: Sequence[nn.Module], x: torch.Tensor, *rows):
        nm = n_micro_for(n_micro, x.shape[0], axis.size)
        _log_schedule(axis.size, nm, x.shape[0])
        grad = torch.is_grad_enabled()
        if grad and not x.requires_grad:
            # the backward must run on every stage, whichever leaves train
            x = x.detach().requires_grad_(True)
        return _GPipe.apply(x, _Schedule(layer_fn, stage_blocks, rows, axis,
                                         nm, grad))

    return f


# ---------------------------------------------------------------------------
# the layout of a staged model
# ---------------------------------------------------------------------------


class OtherStage(nn.Module):
    """The place of a block that another pipeline stage owns: no
    parameters, so `named_parameters()` and `state_dict()` hold the
    stage's own blocks under their global names."""

    def __init__(self, stage: int):
        super().__init__()
        self.stage = stage

    def extra_repr(self) -> str:
        return f"stage={self.stage}"


def check_stages(cfg, stages: int) -> None:
    """ValueError when the EVA tower's blocks do not divide over the stages
    (JAX asserts, eva_vit.py:592-594)."""
    layers = cfg.vision_tower_config.layers
    if layers % stages:
        raise ValueError(
            f"pipeline parallelism: the vision_encoder "
            f"({cfg.vision_encoder_type}) tower's {layers} blocks do not "
            f"divide over pipeline_stages={stages}")


def stage_axis_of(module: nn.Module) -> Optional[StageAxis]:
    """The stage axis recorded on a staged MiCo or its tower (None when it
    is whole)."""
    return getattr(module, "pp", None)


def stage_module(model: nn.Module, axis: Optional[StageAxis]) -> nn.Module:
    """In place: an EVA tower's blocks outside this stage's range freed
    (an `OtherStage` each), the axis and the range recorded on the tower
    and the axis on the model. Other towers stay whole (JAX stages the EVA
    towers alone); a no-op at one stage."""
    if axis is None or axis.size == 1:
        return model
    cfg = model.cfg
    if not cfg.is_eva:
        LOGGER.info("pipeline stages: the %s tower runs whole on every "
                    "stage (JAX stages the EVA towers alone)",
                    cfg.vision_encoder_type)
        return model
    check_stages(cfg, axis.size)
    tower = model.vision_encoder
    layers = len(tower.blocks)
    a, b = stage_range(layers, axis.size, axis.index)
    for i in range(layers):
        if not a <= i < b:
            tower.blocks[i] = OtherStage(block_stage(i, layers, axis.size))
    tower.pp, tower.stage_range = axis, (a, b)
    model.pp = axis
    return model


def block_index(name: str) -> Optional[int]:
    """The EVA block index of a parameter name (None outside the blocks)."""
    if not name.startswith(_BLOCKS):
        return None
    return int(name[len(_BLOCKS):].partition(".")[0])


def summed_names(model: nn.Module) -> set:
    """The parameters whose gradients the model group sums: a staged
    tower's leaves upstream of the pipeline and its shared table."""
    if stage_axis_of(model) is None:
        return set()
    pre = "vision_encoder."
    return {n for n, _ in model.named_parameters()
            if n.startswith(pre) and n[len(pre):].startswith(_SUMMED)}


def owned_names(model: nn.Module) -> set:
    """This stage's block parameters (empty on a whole model)."""
    if stage_axis_of(model) is None:
        return set()
    return {n for n, _ in model.named_parameters()
            if block_index(n) is not None}


def whole_entries(model: nn.Module, tensors: Dict[str, object]
                  ) -> Dict[str, object]:
    """`tensors` (this stage's, keyed by parameter name in the model's
    order) with every block in depth order where the blocks stand: another
    stage's entry is a `Remote` naming its owner and this stage's twin (the
    same leaf of its first block: the blocks' leaves share shapes). The
    same keys in the same order on every stage."""
    axis = stage_axis_of(model)
    if axis is None:
        return dict(tensors)
    a, b = model.vision_encoder.stage_range
    layers = len(model.vision_encoder.blocks)
    out: Dict[str, object] = {}
    placed = False
    for name, t in tensors.items():
        i = block_index(name)
        if i is None:
            out[name] = t
            continue
        if placed:
            continue
        placed = True
        first = f"{_BLOCKS}{a}."
        leaves = [n[len(first):] for n in tensors if n.startswith(first)]
        for j in range(layers):
            for leaf in leaves:
                key = f"{_BLOCKS}{j}.{leaf}"
                out[key] = (tensors[key] if a <= j < b else Remote(
                    block_stage(j, layers, axis.size), f"{first}{leaf}"))
    return out


@dataclass(frozen=True)
class Remote:
    """Another stage's block leaf: its owner stage and this stage's twin."""

    stage: int
    twin: str


def remote_names(model: nn.Module) -> Dict[str, str]:
    """{another stage's block parameter name: this stage's twin}."""
    named = dict(model.named_parameters())
    return {k: v.twin for k, v in whole_entries(model, named).items()
            if isinstance(v, Remote)}


def from_stage(t: Optional[torch.Tensor], like: torch.Tensor, stage: int,
               axis: StageAxis) -> torch.Tensor:
    """The tensor of stage `stage` on every rank of the model group (`t`
    on that stage, a buffer shaped as `like` elsewhere); collective."""
    buf = (t.detach().contiguous() if axis.index == stage
           else torch.empty_like(like, memory_format=torch.contiguous_format))
    return collectives.broadcast(buf, axis.ranks[stage], axis.group)


def fetch(model: nn.Module, name: str, tensors: Dict[str, torch.Tensor],
          twins: Dict[str, str]) -> torch.Tensor:
    """`tensors[name]`; for a staged tower's block leaf, its owner stage's
    tensor, broadcast over the model group (collective: every rank of the
    group fetches the same names in the same order). `tensors` holds this
    stage's tensors by parameter name, `twins` is `remote_names(model)`."""
    axis = stage_axis_of(model)
    i = block_index(name)
    if axis is None or i is None:
        return tensors[name]
    stage = block_stage(i, len(model.vision_encoder.blocks), axis.size)
    if name in twins:
        return from_stage(None, tensors[twins[name]], stage, axis)
    return from_stage(tensors[name], tensors[name], stage, axis)


@contextlib.contextmanager
def whole_tower(model: nn.Module):
    """The evaluation's view of a staged model (JAX's evaluator drops to
    pipeline_stages=1 on the localized parameters, evaluation/__init__.py:
    75-81): every block gathered over the model group in stage order into a
    whole tower and `model.cfg.pipeline_stages` 1 for the body; after it
    the gathered blocks are freed and the stages restored. Collective:
    every rank of the model group enters it. A no-op on a whole model."""
    axis = stage_axis_of(model)
    if axis is None:
        yield model
        return
    from mico_tpu_torch.models._params import Init
    from mico_tpu_torch.models.eva_vit import EvaBlock

    tower = model.vision_encoder
    cfg, tcfg = model.cfg, model.cfg.vision_tower_config
    a, _ = tower.stage_range
    twin = tower.blocks[a]
    like = next(twin.parameters())
    kept = list(tower.blocks)
    with torch.no_grad():
        for i, blk in enumerate(kept):
            if isinstance(blk, OtherStage):
                # the block's parameters as the owner holds them
                new = EvaBlock(tcfg, Init(None, meta=True), i).to_empty(
                    device=like.device).to(like.dtype)
                for name, p in new.named_parameters():
                    p.copy_(from_stage(None, twin.get(name), blk.stage,
                                       axis))
                tower.blocks[i] = new
            else:
                for p in blk.parameters():
                    from_stage(p, p, axis.index, axis)
    tower.pp = model.pp = None
    model.cfg = dataclasses.replace(cfg, pipeline_stages=1)
    try:
        yield model
    finally:
        for i, blk in enumerate(kept):
            tower.blocks[i] = blk
        tower.pp = model.pp = axis
        model.cfg = cfg
