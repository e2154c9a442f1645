"""Tracing and profiling utilities (counterpart of
`mico_tpu/utils/profiling.py`).

  - `trace(logdir)`: context manager around `torch.profiler` with the CPU
    and (when there is a card) CUDA activities; writes a chrome trace
    (`trace.json`, loadable in chrome://tracing or Perfetto) into `logdir`.
  - `annotate(name)` / `annotate_fn`: `record_function` spans that show up
    as named ranges in that trace, plus an NVTX range when a card is
    present.
  - `StepTimer`: wall-clock step timing that synchronises the device the
    step's output lives on (CUDA returns before the card finishes, so an
    honest time waits for it).
  - analytic forward FLOPs of the flagship towers, as JAX's module counts
    them.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, record_shapes: bool = False):
    """Profile the block with torch.profiler and write its chrome trace to
    `logdir/trace.json`; yields the profiler (its `key_averages()` sum the
    kernels' device time)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, record_shapes=record_shapes) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named span in the profiler's trace (wrap dispatch sites), and an
    NVTX range on the card."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def annotate_fn(fn=None, *, name: Optional[str] = None):
    """Decorator form of `annotate`."""
    if fn is None:
        return functools.partial(annotate_fn, name=name)

    label = name or fn.__name__

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with annotate(label):
            return fn(*args, **kwargs)

    return wrapped


def _first_tensor(out) -> Optional[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (list, tuple)) else ())
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


class StepTimer:
    """Running mean/last step time with explicit device synchronisation.

    >>> timer = StepTimer()
    >>> with timer:
    ...     out = step(model, batch)
    ...     timer.sync(out)          # wait for the card → honest timing
    >>> timer.last_ms, timer.mean_ms
    """

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.n = 0
        self.total = 0.0
        self.last = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def sync(self, out) -> None:
        """Wait for the device that holds `out`'s first tensor (nested
        lists, tuples and dicts are searched in order)."""
        t = _first_tensor(out)
        if t is not None and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.last = dt
        if self.n >= self.warmup:
            self.total += dt
        self.n += 1
        return False

    @property
    def last_ms(self) -> float:
        return self.last * 1e3

    @property
    def mean_ms(self) -> float:
        steps = max(self.n - self.warmup, 1)
        return self.total / steps * 1e3


# ---------------------------------------------------------------------------
# Analytic FLOPs (fwd, multiply-accumulate = 2 FLOPs)
# ---------------------------------------------------------------------------


def vit_flops(layers: int, width: int, seq_len: int, mlp_hidden: int) -> int:
    """Per-image forward FLOPs of a ViT trunk (attention scores included)."""
    per_tok = 4 * width * width + 2 * width * mlp_hidden
    attn = 2 * seq_len * width
    return 2 * layers * seq_len * (per_tok + attn)


def eva_vit_flops(cfg, n_frames: int = 1) -> int:
    """cfg: the port's `EvaVitConfig` → forward FLOPs for n_frames frames."""
    return n_frames * vit_flops(
        cfg.layers, cfg.width, cfg.seq_len, cfg.mlp_hidden
    )


def bert_flops(layers: int, hidden: int, seq_len: int, intermediate: int,
               cross_len: int = 0) -> int:
    """BERT(+cross-attention) forward FLOPs per sequence."""
    per_tok = 4 * hidden * hidden + 2 * hidden * intermediate
    attn = 2 * seq_len * hidden
    xattn = (2 * hidden * hidden + 2 * cross_len * hidden) if cross_len else 0
    return 2 * layers * seq_len * (per_tok + attn + xattn)
