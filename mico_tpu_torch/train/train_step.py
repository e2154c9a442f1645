"""The training step (counterpart of `mico_tpu/train/train_step.py`): the
task losses, their total, the backward, the global-norm clip and the AdamW
update (every `accum_steps`-th call when the optimizer accumulates, with
`optax.MultiSteps`' mean). Parameters stay fp32 (master weights) and the
model computes in `cfg.compute_dtype` (bf16 on the card): each matmul casts
its weight, so the gradients arrive in fp32. The total is checked for
finiteness every step, and a non-finite loss raises before the update.

Across processes (`mesh`, the data axis of `parallel.mesh`) each rank runs
the losses on its rows of the global batch (`objectives.task_losses` under
the group), the optimizer averages the gradients over the ranks at the
window's last call, and with `zero1` (the optimizer's ZeRO-1 split) each
rank reduce-scatters them into the slices it owns. The step is the
one-process step on the global batch, as JAX's is (its run path computes
the losses on the global batch, train_step.py:81). The returned losses are
the global batch's: the ranks' shares averaged, one all-reduce a step,
whose result every rank checks, so all raise together. Under tensor
parallelism (a model sharded over the mesh's model axis) `mesh.group` is
the data group: the ranks of a model group compute the same losses on the
same rows, so the average runs over the data group alone. So under
pipeline stages: every stage computes the losses on the tokens the last
stage broadcast, and the same finiteness check holds on every rank, so all
ranks raise together.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mico_tpu_torch.config import MiCoConfig
from mico_tpu_torch.parallel.collectives import all_reduce_sum
from mico_tpu_torch.train.objectives import Draws, task_losses
from mico_tpu_torch.train.optim import Optimizer


def make_train_step(cfg: MiCoConfig, optimizer: Optimizer, task: str,
                    mesh=None, zero1: bool = False) -> Callable:
    """Returns step(model, batch, generator, draws=None) → the loss dict
    (detached, the global batch's, with `loss_total` and `grad_norm`).
    `generator` is the CPU `torch.Generator` the step's draws come from
    (one per rank); `batch` holds this rank's rows. `zero1` must match the
    optimizer's state layout (`build_optimizer(..., zero1=)`)."""
    group = None if mesh is None else mesh.group
    if group is not optimizer.group or bool(zero1) != optimizer.zero1:
        raise ValueError(
            f"the step's mesh group and zero1={zero1} must be the "
            f"optimizer's (zero1={optimizer.zero1})")

    def step(model, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator],
             draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        if optimizer.mini_step == 0:
            optimizer.zero_grad()
        losses = task_losses(model, cfg, batch, task, generator,
                             axis_name=group, draws=draws)
        total = sum(losses.values())
        out = backward_checked(optimizer, total, losses, group)
        norm = optimizer.accumulate()
        if norm is not None:
            out["grad_norm"] = norm
        return out

    return step


def backward_checked(optimizer: Optimizer, total: torch.Tensor,
                     losses: Dict[str, torch.Tensor],
                     group=None) -> Dict[str, torch.Tensor]:
    """The backward of `total`, then the finiteness check of the global
    batch's losses (this rank's shares averaged over `group`): a
    non-finite total clears the accumulation window and raises before any
    update. → the global losses with `loss_total`, detached."""
    total.backward()
    names = list(losses) + ["loss_total"]
    vals = torch.stack([v.detach().float() for v in losses.values()]
                       + [total.detach().float()])
    if group is not None:
        vals = all_reduce_sum(vals, group) / optimizer.world
    if not torch.isfinite(vals[-1]).item():
        optimizer.zero_grad()
        optimizer.mini_step = 0
        raise FloatingPointError(
            f"non-finite loss at update {optimizer.count}: "
            f"{ {k: v.item() for k, v in zip(names, vals)} }")
    return dict(zip(names, vals.unbind()))
