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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mico_tpu_torch.train.sched import lr_schedule_ratio


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
                 accum_steps: int = 1):
        self.cfg = cfg
        self.accum_steps = int(accum_steps)
        self.mini_step = 0
        self.labels = param_group_labels(model, cfg.new_params_name,
                                         cfg.frozen_prefixes)
        # every parameter's name (frozen ones too) and the model's config:
        # the leaf order of the JAX package's optimizer state
        # (`checkpoints.jax_optimizer_leaves`)
        self.model_cfg = getattr(model, "cfg", None)
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
        fused = all(p.is_cuda for p in self.params)
        self.torch_optimizer = torch.optim.AdamW(
            [dict(params=ps, name=label, lr=0.0,
                  init_lr=init_lr[label.split("_")[0]],
                  weight_decay=0.0 if label.endswith("_nd")
                  else cfg.weight_decay)
             for label, ps in groups.items()],
            lr=0.0, betas=cfg.betas, eps=cfg.eps, fused=fused or None)
        self.count = 0

    def zero_grad(self) -> None:
        self.torch_optimizer.zero_grad(set_to_none=True)

    def clip_(self) -> torch.Tensor:
        """Scale the gradients to global norm `grad_norm` when they exceed
        it; returns the norm before clipping (fp32, on the device)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
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

    def accumulate(self) -> Optional[torch.Tensor]:
        """After a backward: count it in the window; on its k-th, scale
        the summed gradients to their mean, clip, update and close the
        window (the next step's `zero_grad` clears them).
        → the norm before clipping when it updated, else None."""
        self.mini_step += 1
        if self.mini_step < self.accum_steps:
            return None
        if self.accum_steps > 1:
            grads = [p.grad for p in self.params if p.grad is not None]
            torch._foreach_mul_(grads, 1.0 / self.accum_steps)
        norm = self.clip_()
        self.step()
        self.mini_step = 0
        return norm


def build_optimizer(model: nn.Module, cfg: OptimConfig = OptimConfig(),
                    accum_steps: int = 1) -> Optimizer:
    """The training entry: turns `requires_grad` on for every parameter
    outside `frozen_prefixes` and returns their optimizer."""
    return Optimizer(model, cfg, accum_steps)
