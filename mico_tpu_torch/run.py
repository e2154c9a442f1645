"""Training / testing CLI entry (counterpart of `mico_tpu/run.py`).

The reference entry (data/run.py:13-63):

    python -m mico_tpu_torch.run --config <experiment.json> \
        [--pretrain_dir DIR] [--output_dir DIR] [--vocab FILE] \
        [--device cuda|cpu] [run_cfg.mode=testing] [k=v ...]

get_args (layered JSON + k=v CLI overrides) → initialize (the process
group, seeds, logging) → dataloaders → model (resume > pretrain_dir > fresh
init) → optimizer → train() or test(). It runs on one CUDA card unless
`--device cpu` is given, and raises without a card.

`run_cfg.multihost=true` runs one process a card, data-parallel over the
default `torch.distributed` group (JAX's `jax.distributed.initialize`,
run.py:45-80), joined one of two ways:
  - under torchrun (`python -m torch.distributed.run --nproc_per_node N
    -m mico_tpu_torch.run ...`), from its environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
  - from JAX's keys `run_cfg.coordinator_address` (host:port, or a
    `file://` path for a file rendezvous), `num_processes`, `process_id`
    (the card: the process id modulo the visible cards).
NCCL on the card (`cuda:LOCAL_RANK`), gloo with `--device cpu`; the mesh's
data and model subgroups on the same backend.
`run_cfg.model_parallel=m` lays the processes out as a data × model mesh
(`parallel.mesh.create_mesh(data=-1, model=m)`: rank r has data index
r // m and model index r % m) and shards the model over its model group:
tensor parallelism on the EVA tower and BERT, and with
`model_cfg.shard_condition_sequence` sequence parallelism of the condition
tokens (`parallel.tensor_parallel`). `run_cfg.pipeline_stages=S` (> 1)
runs the EVA tower as a GPipe pipeline of S stages over the model axis
instead (JAX's run.py:116-126): it sets `model_cfg.pipeline_stages` (and
`pipeline_microbatches` from `run_cfg.pipeline_microbatches`), overrides
`model_parallel` with S (logged), stages the tower's blocks (stage s owns
blocks [s·L/S, (s+1)·L/S) whole) and replicates every other leaf
(`parallel.pipeline_parallel`). `run_cfg.zero1=true` splits the AdamW
moments over the data group (ZeRO-1). Host seeds are seed + data index
(JAX's run.py:72 with its data axis, the model axis being S under
pipeline stages): the ranks of a model group draw the same masks. The
model's initial weights are the seed's on every rank. Rank 0 alone writes
`hps.json`, the log file, the checkpoints and `log/record.json` (the
training run's record).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

import numpy as np
import torch

from mico_tpu_torch.config import mico_config_from_dict
from mico_tpu_torch.convert import mico_from_jax
from mico_tpu_torch.data import (create_train_dataloaders,
                                 create_val_dataloaders)
from mico_tpu_torch.models.mico import MiCo, resolve_device
from mico_tpu_torch.parallel import collectives
from mico_tpu_torch.parallel.mesh import create_mesh
from mico_tpu_torch.pipeline import test, train
from mico_tpu_torch.text import BertWordPieceTokenizer
from mico_tpu_torch.text.wordpiece import DEFAULT_VOCAB
from mico_tpu_torch.train.checkpoints import (
    _latest_step,
    load_from_pretrained_dir,
    load_latest_opt_state,
    resume_latest,
)
from mico_tpu_torch.train.optim import OptimConfig, build_optimizer
from mico_tpu_torch.utils.config_io import dump_hps, load_layered_config
from mico_tpu_torch.utils.logger import LOGGER, add_log_to_file

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def init_process_group(run_cfg, device: torch.device) -> torch.device:
    """Join the run's processes (reference data/utils/initialize.py:8-16);
    → this process's device (`cuda:<local rank>` on the card)."""
    keys = ("coordinator_address", "num_processes", "process_id")
    if all(run_cfg.get(k) is not None for k in keys):
        addr = str(run_cfg["coordinator_address"])
        init = addr if "://" in addr else f"tcp://{addr}"
        world, rank = int(run_cfg["num_processes"]), int(
            run_cfg["process_id"])
        # processes numbered host by host, one a visible card
        local = (rank % torch.cuda.device_count() if device.type == "cuda"
                 else 0)
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        init = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local = int(os.environ["LOCAL_RANK"])
    else:
        raise ValueError(
            f"run_cfg.multihost needs torchrun's environment "
            f"({', '.join(_TORCHRUN_ENV)}) or "
            f"{', '.join('run_cfg.' + k for k in keys)}")
    if device.type == "cuda":
        device = torch.device("cuda", int(local))
        torch.cuda.set_device(device)
    kw = dict(device_id=device) if device.type == "cuda" else {}
    torch.distributed.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=init,
        world_size=world, rank=rank, **kw)
    LOGGER.info("process %d of %d on %s", rank, world, device)
    return device


def initialize(run_cfg, device: torch.device) -> torch.device:
    """The process group (`run_cfg.multihost`), seeds and logging
    (reference data/utils/initialize.py:8-36); → this process's device."""
    if run_cfg.get("multihost"):
        device = init_process_group(run_cfg, device)
    rank = collectives.process_index()
    seed = int(run_cfg.get("seed", 50)) + rank // model_axis_size(run_cfg)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    out = run_cfg.get("output_dir")
    if out and rank == 0:
        os.makedirs(os.path.join(out, "log"), exist_ok=True)
        os.makedirs(os.path.join(out, "ckpt"), exist_ok=True)
        add_log_to_file(os.path.join(out, "log", "log.txt"))
    return device


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--pretrain_dir", default=None)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--vocab", default=None)
    parser.add_argument("--device", default="cuda")
    known, overrides = parser.parse_known_args(argv)
    # the pretrained run's inherited model keys come from its hps.json
    # (`load_layered_config`); JAX's get_args keeps `--pretrain_dir` from
    # it, so a directory named on the command line passes on none
    inherit = (["--pretrain_dir", known.pretrain_dir] if known.pretrain_dir
               else [])
    args = load_layered_config(known.config, argv=overrides + inherit)
    args.pop("pretrain_dir", None)      # the flag read as a top-level key
    if known.pretrain_dir:
        args.run_cfg["pretrain_dir"] = known.pretrain_dir
    if known.output_dir:
        args.run_cfg["output_dir"] = known.output_dir
    args.run_cfg.setdefault("output_dir", "./output")
    args["_vocab"] = known.vocab
    args["_device"] = known.device
    return args


def model_axis_size(run_cfg) -> int:
    """The mesh's model axis: the pipeline's stages at
    `run_cfg.pipeline_stages` > 1 (which override `model_parallel`, as
    JAX's run.py:126 does), else `model_parallel`."""
    stages = int(run_cfg.get("pipeline_stages", 1))
    return stages if stages > 1 else int(run_cfg.get("model_parallel", 1))


def build_model(cfg, run_cfg, model_cfg, device, dtype, mesh=None):
    """The run's model, sharded over the mesh's model axis: resume >
    pretrain_dir > fresh init (reference build_model.py:65-124). A resumed
    checkpoint is JAX's full layout, so a run resumes at any (data,
    model); from `.orbax` each rank reads only its region (JAX's sharded
    resume, run.py:138-149, 226-245). → (model, cfg, the resumed step or
    0)."""
    if run_cfg.get("resume"):
        ckpt = os.path.join(run_cfg["output_dir"], "ckpt")
        _, latest = _latest_step(ckpt, "model")
        if latest:
            model = MiCo(cfg, device="cpu", init_weights=False, mesh=mesh)
            model = model.to_empty(device=device).to(dtype)
            step = resume_latest(run_cfg["output_dir"], model)
            if not step and latest.endswith(".orbax"):
                raise FileNotFoundError(
                    f"resume requested but no orbax checkpoint under {ckpt}")
            return model, cfg, step
    if run_cfg.get("pretrain_dir"):
        params, cfg = load_from_pretrained_dir(
            run_cfg["pretrain_dir"],
            video_resolution=int(model_cfg.get("vision_resolution", 224)),
            config_overrides=dict(model_cfg))
        return mico_from_jax(params, cfg, device=device, dtype=dtype,
                             mesh=mesh), cfg, 0
    return MiCo(cfg, device=device, seed=int(run_cfg.get("seed", 50)),
                dtype=dtype, mesh=mesh), cfg, 0


def main(argv=None):
    """→ in testing mode the evaluation logs; in training mode the run's
    record (`pipeline.train`). A process group it started is destroyed
    when it returns or raises."""
    args = get_args(argv)
    run_cfg = args.run_cfg
    device = resolve_device(args["_device"])
    try:
        return _run(args, initialize(run_cfg, device))
    finally:
        if run_cfg.get("multihost") and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _run(args, device: torch.device):
    run_cfg, model_cfg = args.run_cfg, args.model_cfg
    mesh = create_mesh(data=-1, model=model_axis_size(run_cfg))
    LOGGER.info("mesh: %s", mesh.shape)
    if collectives.process_index() == 0:
        dump_hps({k: v for k, v in args.items() if not k.startswith("_")},
                 run_cfg["output_dir"])
    stages = int(run_cfg.get("pipeline_stages", 1))
    if stages > 1:
        # the ViT stack as a GPipe pipeline over the model axis (the axis
        # tensor parallelism takes otherwise): every leaf but the stage's
        # blocks replicated (JAX's run.py:116-126, 222-225)
        model_cfg = dict(model_cfg, pipeline_stages=stages)
        if run_cfg.get("pipeline_microbatches"):
            model_cfg["pipeline_microbatches"] = int(
                run_cfg["pipeline_microbatches"])
        if int(run_cfg.get("model_parallel", 1)) != stages:
            LOGGER.info("pipeline_stages=%d: model_parallel %s -> %d",
                        stages, run_cfg.get("model_parallel", 1), stages)

    vocab = args.get("_vocab") or run_cfg.get("vocab") or DEFAULT_VOCAB
    tokenizer = BertWordPieceTokenizer(vocab)

    meta_loader = create_train_dataloaders(args, device=device)
    val_loaders = create_val_dataloaders(args, device=device)

    # run_cfg.param_dtype casts the fp32 parameters (and so the AdamW
    # moments) as the JAX entry does (run.py:167-181)
    cfg = mico_config_from_dict(dict(model_cfg))
    param_dtype = run_cfg.get("param_dtype")
    dtype = getattr(torch, param_dtype) if param_dtype else cfg.dtypes()[0]
    mode = run_cfg.get("mode", "training")
    model, cfg, resume_step = build_model(cfg, run_cfg, model_cfg, device,
                                          dtype, mesh)

    if mode == "training":
        if meta_loader is None:
            raise ValueError("training mode requires data_cfg.train")
        frozen = tuple(pfx for flag, pfx in (
            ("frozen_vision", "vision_encoder"),
            ("frozen_audio", "audio_encoder")) if model_cfg.get(flag))
        opt_cfg = OptimConfig(
            learning_rate=float(run_cfg.get("learning_rate", 1e-4)),
            clip_lr=float(run_cfg.get("clip_lr", 5e-7)),
            new_lr=float(run_cfg.get("new_lr", 1e-5)),
            new_params_name=tuple(run_cfg.get("new_params_name", ())),
            frozen_prefixes=frozen,
            weight_decay=float(run_cfg.get("weight_decay", 0.01)),
            betas=tuple(run_cfg.get("betas", (0.9, 0.98))),
            grad_norm=float(run_cfg.get("grad_norm", 2.0)),
            scheduler=run_cfg.get("scheduler", "warmup_linear"),
            warmup_ratio=float(run_cfg.get("warmup_ratio", 0.1)),
            num_train_steps=int(run_cfg.get("num_train_steps", 100000)),
        )
        optimizer = build_optimizer(
            model, opt_cfg,
            accum_steps=int(run_cfg.get("gradient_accumulation_steps", 1)),
            group=mesh.group, zero1=bool(run_cfg.get("zero1", False)))
        if resume_step:
            # the moments, the update count (so the LR schedule continues)
            # and an open accumulation window of the resumed step
            load_latest_opt_state(run_cfg["output_dir"], optimizer,
                                  step=resume_step)
        if run_cfg.get("first_eval") and val_loaders:
            test(cfg, model, val_loaders, run_cfg, tokenizer)
        record = train(cfg, model, optimizer, meta_loader, val_loaders,
                       run_cfg, tokenizer, start_step=resume_step, mesh=mesh)
        record["world"] = mesh.shape["data"]
        record["mesh"] = dict(mesh.shape)
        if collectives.process_index() == 0:
            with open(os.path.join(run_cfg["output_dir"], "log",
                                   "record.json"), "w") as f:
                json.dump(record, f, default=str)
        return record
    if mode == "testing":
        logs = test(cfg, model, val_loaders, run_cfg, tokenizer)
        LOGGER.info("test results: %s", logs)
        return logs
    raise ValueError(f"unknown mode {mode}")


if __name__ == "__main__":
    main(sys.argv[1:])
