"""Train / test orchestration (counterpart of `mico_tpu/pipeline.py`).

The reference pipeline (data/utils/pipeline.py:17-180):
  - train: iterate the MetaLoader, one train step function per task,
    RunningMeter EMA losses logged every `log_every` steps, the evaluation
    registry every `valid_steps` steps and at the last, then a checkpoint
    save and best-metric snapshots (CIDEr / accuracy / video_r1);
  - test: the evaluation registry once over the val loaders.

Eagerly, a process a card: the LR schedule is set on the optimizer's groups
before each update (`train/optim.py`), gradient accumulation is the
optimizer's (`optax.MultiSteps`' semantics), and batches reach the card
through the loader's CUDA prefetcher. The loop reads `run_cfg.valid_steps`
as the JAX loop does (`create_train_dataloaders` sets it). An `scst%…`
task takes `train/scst.py`'s step (with `run_cfg.scst_finetune_encoder`)
and the batch's reference captions, `raw_captions`.

Across processes (`mesh`: data × model; one process a card) each data
index loads its rows of the global batch, which every rank of its model
group runs on its part of a tensor-parallel model, or through its stage of
a pipeline-staged EVA tower (`make_train_step(mesh=, zero1=)`); the data
index is rank // the model axis (`collectives.data_shard`: `model_parallel`,
or the stages under `pipeline_stages`); the logged losses are the global
batch's, the evaluations gather every data index's shard, so every rank
agrees on "best", and rank 0 writes the checkpoints (every rank takes
part in a save: ZeRO-1's moments and the model's parts are gathered).
Each data index draws from its own generator (seed + data index), the
same on every rank of its model group, so they draw the same masks.
SCST does not train across processes: JAX builds its step without the
mesh (pipeline.py:90-95) and reads the sampled tokens of the sharded
global batch back to the host, which fails across processes, so the port
raises for `scst%…` at more than one process, pipeline stages included.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from mico_tpu_torch.config import MiCoConfig
from mico_tpu_torch.data.tokenize_collate import BatchTokenizer, device_batch
from mico_tpu_torch.evaluation import Evaluator, evaluation_registry
from mico_tpu_torch.parallel import collectives
from mico_tpu_torch.parallel.collectives import data_shard
from mico_tpu_torch.parallel.mesh import Mesh
from mico_tpu_torch.train.checkpoints import ModelSaver
from mico_tpu_torch.train.scst import make_scst_step
from mico_tpu_torch.train.train_step import make_train_step
from mico_tpu_torch.utils.logger import LOGGER, RunningMeter


def get_best_name(task: str) -> Optional[str]:
    """Metric that defines 'best' for a task (reference
    pipeline.py:168-179)."""
    head = task.split("%")[0].split("_")[0]
    return {"cap": "CIDEr", "qa": "accuracy", "ret": "video_r1"}.get(head)


SCST_PARALLEL = ("scst tasks across processes: JAX's SCST step does not "
                 "train across processes either (mico_tpu/train/scst.py:126 "
                 "reads a global array; ROADMAP.md, JAX-side faults)")


def train(cfg: MiCoConfig, model, optimizer, meta_loader,
          val_loaders: Dict, run_cfg, tokenizer, start_step: int = 0,
          mesh: Optional[Mesh] = None) -> dict:
    """Run the training loop on `model` in place (its device is the
    run's); → the run's record: per step the task, the loss values, the
    seconds waiting for data and in the step; per evaluation its metrics
    and seconds; per save its seconds; on the card the peak device memory.

    start_step: the global step to count from (the resumed checkpoint's,
    reference build_model.py:106-124), so periodic saves continue the
    numbering. mesh: the data axis across processes (None: one process)."""
    device = next(model.parameters()).device
    zero1 = bool(run_cfg.get("zero1", False))
    num_steps = int(run_cfg.get("num_train_steps", 1000))
    valid_steps = int(run_cfg.get("valid_steps", num_steps))
    log_every = int(run_cfg.get("log_every", 50))
    saver = ModelSaver(
        run_cfg.get("output_dir", "./output"),
        remove_before_ckpt=bool(run_cfg.get("remove_before_ckpt", True)),
        backend=run_cfg.get("checkpoint_backend", "npz"))
    batch_tok = BatchTokenizer(
        tokenizer,
        max_caption_len=cfg.max_caption_len,
        max_omni_caption_len=cfg.max_omni_caption_len,
        max_subtitle_len=cfg.max_subtitle_len)
    evaluate_fn = evaluation_registry[
        run_cfg.get("evaluation_type", "evaluation_mm")]
    step_fns: Dict[str, callable] = {}
    meters: Dict[str, RunningMeter] = {}
    best_indicator: Dict[str, float] = {}
    # the steps' draws: one CPU generator from the run's seed, a stream of
    # its own on each rank
    generator = torch.Generator().manual_seed(
        int(run_cfg.get("seed", 0)) + data_shard()[1])
    record = {"start_step": int(start_step), "steps": [], "evals": [],
              "saves": []}

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    global_step = int(start_step)
    t_start = time.perf_counter()
    loader = iter(meta_loader)
    while True:
        t_wait = time.perf_counter()
        try:
            name, batch = next(loader)
        except StopIteration:
            break
        data_wait_s = time.perf_counter() - t_wait
        if global_step >= num_steps:
            break
        task = name.split("--")[0]
        is_scst = task.startswith("scst")
        if is_scst and collectives.process_count() > 1:
            raise NotImplementedError(SCST_PARALLEL)
        if task not in step_fns:
            step_fns[task] = (
                make_scst_step(cfg, optimizer, task, tokenizer,
                               finetune_encoder=bool(run_cfg.get(
                                   "scst_finetune_encoder", False)))
                if is_scst else make_train_step(cfg, optimizer, task,
                                                mesh=mesh, zero1=zero1))
        t_step = time.perf_counter()
        tb = batch_tok(batch, task)
        arrays = device_batch(tb, device)
        if is_scst:
            refs = tb.get("raw_captions") or batch.get("raw_captions")
            losses = step_fns[task](model, arrays, generator, refs)
        else:
            losses = step_fns[task](model, arrays, generator)
        global_step += 1
        values = {k: float(v) for k, v in losses.items()}  # waits for the step
        record["steps"].append(dict(
            step=global_step, task=task, losses=values,
            data_wait_s=data_wait_s,
            step_s=time.perf_counter() - t_step))
        for k, v in values.items():
            key = f"{task}/{k}"
            meters.setdefault(key, RunningMeter(key))(v)
        if global_step % log_every == 0:
            LOGGER.info("step %d/%d (%.1f s): %s", global_step, num_steps,
                        time.perf_counter() - t_start,
                        " ".join(str(m) for m in meters.values()))
        if global_step % valid_steps == 0 or global_step == num_steps:
            t0 = time.perf_counter()
            evaluator = Evaluator(cfg, model, tokenizer, run_cfg)
            eval_log = evaluate_fn(evaluator, val_loaders, run_cfg,
                                   global_step)
            record["evals"].append(dict(step=global_step, metrics=eval_log,
                                        eval_s=time.perf_counter() - t0))
            t0 = time.perf_counter()
            saver.save(global_step, model, optimizer)
            save = dict(step=global_step, save_s=time.perf_counter() - t0,
                        best={})
            for loader_name, metrics in eval_log.items():
                best_name = get_best_name(loader_name.split("--")[0])
                if best_name and best_name in metrics:
                    if metrics[best_name] > best_indicator.get(loader_name,
                                                               -1):
                        best_indicator[loader_name] = metrics[best_name]
                        metric = (f"{best_name}_"
                                  f"{loader_name.split('--')[-1]}")
                        t0 = time.perf_counter()
                        saver.save_best(metric, model)
                        save["best"][metric] = time.perf_counter() - t0
                    LOGGER.info("best %s for %s: %.4f", best_name,
                                loader_name, best_indicator[loader_name])
            record["saves"].append(save)
    record["end_step"] = global_step
    if device.type == "cuda":
        record["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    return record


def test(cfg: MiCoConfig, model, val_loaders, run_cfg, tokenizer):
    evaluator = Evaluator(cfg, model, tokenizer, run_cfg)
    evaluate_fn = evaluation_registry[
        run_cfg.get("evaluation_type", "evaluation_mm")]
    return evaluate_fn(evaluator, val_loaders, run_cfg, 0)
