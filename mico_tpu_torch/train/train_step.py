"""The training step (counterpart of `mico_tpu/train/train_step.py`) on one
card: the task losses, their total, the backward, the global-norm clip and
the AdamW update (every `accum_steps`-th call when the optimizer
accumulates, with `optax.MultiSteps`' mean). Parameters stay fp32 (master
weights) and the model computes in `cfg.compute_dtype` (bf16 on the card):
each matmul casts its weight, so the gradients arrive in fp32. The total is checked for
finiteness every step, and a non-finite loss raises before the update.
Data parallelism and ZeRO-1 (`mesh`, `zero1`) wait for ROADMAP.md queue 1,
parallelism.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mico_tpu_torch.config import MiCoConfig
from mico_tpu_torch.train.objectives import Draws, task_losses
from mico_tpu_torch.train.optim import Optimizer


def make_train_step(cfg: MiCoConfig, optimizer: Optimizer, task: str,
                    mesh=None, zero1: bool = False) -> Callable:
    """Returns step(model, batch, generator, draws=None) → the loss dict
    (detached, with `loss_total` and `grad_norm`). `generator` is the CPU
    `torch.Generator` the step's draws come from."""
    if mesh is not None or zero1:
        raise NotImplementedError(
            "mesh / zero1: not ported yet (ROADMAP.md, queue 1: parallelism)")

    def step(model, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator],
             draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        if optimizer.mini_step == 0:
            optimizer.zero_grad()
        losses = task_losses(model, cfg, batch, task, generator, draws=draws)
        total = sum(losses.values())
        backward_checked(optimizer, total, losses)
        norm = optimizer.accumulate()
        out = {k: v.detach() for k, v in losses.items()}
        out["loss_total"] = total.detach()
        if norm is not None:
            out["grad_norm"] = norm
        return out

    return step


def backward_checked(optimizer: Optimizer, total: torch.Tensor,
                     losses: Dict[str, torch.Tensor]) -> None:
    """The backward of `total`, then the finiteness check: a non-finite
    total clears the accumulation window and raises before any update."""
    total.backward()
    if not torch.isfinite(total).item():
        optimizer.zero_grad()
        optimizer.mini_step = 0
        raise FloatingPointError(
            f"non-finite loss at update {optimizer.count}: "
            f"{ {k: v.item() for k, v in losses.items()} }")
