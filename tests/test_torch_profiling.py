"""The port's profiling module (`mico_tpu_torch/utils/profiling.py`)
against `mico_tpu/utils/profiling.py`: the analytic FLOP counts are JAX's
integers; `StepTimer` skips its warm-up steps; `trace` writes a chrome
trace holding an `annotate`d span (on the CPU here)."""

import json
import time

import pytest
import torch

from mico_tpu import config as jax_config
from mico_tpu.utils import profiling as jax_profiling
from mico_tpu_torch import config
from mico_tpu_torch.utils import profiling

TOWERS = ["evaclip01_giant", "evaclip02_bige", "evaclip02_base",
          "evaclip02_large"]


@pytest.mark.parametrize("tower", TOWERS)
@pytest.mark.parametrize("frames", [1, 4])
def test_eva_vit_flops_equal_jax(tower, frames):
    got_cfg = config.MiCoConfig(vision_encoder_type=tower).eva_config
    want_cfg = jax_config.MiCoConfig(vision_encoder_type=tower).eva_config
    got = profiling.eva_vit_flops(got_cfg, frames)
    assert isinstance(got, int) and got > 0
    assert got == jax_profiling.eva_vit_flops(want_cfg, frames)


@pytest.mark.parametrize("args", [(12, 768, 30, 3072), (12, 768, 30, 3072,
                                                        257 * 4),
                                  (12, 768, 40, 3072, 2056)])
def test_bert_flops_equal_jax(args):
    assert profiling.bert_flops(*args) == jax_profiling.bert_flops(*args)


@pytest.mark.parametrize("args", [(40, 1408, 257, 6144), (24, 1024, 577,
                                                          4096)])
def test_vit_flops_equal_jax(args):
    assert profiling.vit_flops(*args) == jax_profiling.vit_flops(*args)


def test_step_timer_counts_warmup():
    """The first `warmup` steps are counted in `n` and `last`, never in the
    mean: two slow warm-up steps leave the mean at the fast steps'."""
    timer = profiling.StepTimer(warmup=2)
    times = []
    for i, sleep in enumerate((0.3, 0.3, 0.005, 0.005)):
        with timer:
            out = {"a": [torch.ones(2) * i]}
            time.sleep(sleep)
            timer.sync(out)
        times.append(timer.last)
    assert timer.n == 4
    assert timer.total == pytest.approx(times[2] + times[3])
    assert timer.mean_ms == pytest.approx(1e3 * (times[2] + times[3]) / 2)
    assert 5.0 <= timer.mean_ms < 150.0
    assert timer.last_ms == pytest.approx(timer.last * 1e3)
    assert profiling.StepTimer().mean_ms == 0.0


def test_trace_writes_an_annotated_span(tmp_path):
    @profiling.annotate_fn(name="decorated step")
    def step(x):
        return x @ x

    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("embed batch"):
            y = step(x)
    assert y.shape == (64, 64)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"embed batch", "decorated step"} <= names
    assert any(e.key == "embed batch" for e in prof.key_averages())
