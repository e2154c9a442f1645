"""LR schedules (counterpart of `mico_tpu/train/sched.py`): the ratio-based
warmup_linear / warmup_cosine / warmup_constant of the reference
(data/utils/sched.py:3-29), on host floats: the port sets each param
group's learning rate before the update."""

from __future__ import annotations

import math


def warmup_linear(x: float, warmup_ratio: float) -> float:
    if x < warmup_ratio:
        return x / warmup_ratio
    return max((x - 1.0) / (warmup_ratio - 1.0), 0.0)


def warmup_cosine(x: float, warmup_ratio: float) -> float:
    if x < warmup_ratio:
        return x / warmup_ratio
    return 0.5 * (1.0 + math.cos(math.pi * x))


def warmup_constant(x: float, warmup_ratio: float) -> float:
    return x / warmup_ratio if x < warmup_ratio else 1.0


SCHEDULES = {
    "warmup_linear": warmup_linear,
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
}


def lr_schedule_ratio(global_step: int, num_train_steps: int,
                      warmup_ratio: float,
                      scheduler: str = "warmup_linear") -> float:
    return SCHEDULES[scheduler](global_step / num_train_steps, warmup_ratio)
