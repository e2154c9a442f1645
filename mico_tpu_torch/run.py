"""Training / testing CLI entry (counterpart of `mico_tpu/run.py`).

The reference entry (data/run.py:13-63):

    python -m mico_tpu_torch.run --config <experiment.json> \
        [--pretrain_dir DIR] [--output_dir DIR] [--vocab FILE] \
        [--device cuda|cpu] [run_cfg.mode=testing] [k=v ...]

get_args (layered JSON + k=v CLI overrides) → initialize (seeds, logging)
→ dataloaders → model (resume > pretrain_dir > fresh init) → optimizer
→ train() or test(). It runs on one CUDA card unless `--device cpu` is given,
and raises without a card; multi-host runs, the mesh (`model_parallel`,
`pipeline_stages` > 1) and ZeRO-1 are not ported.
"""

from __future__ import annotations

import argparse
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

PARALLELISM = "not ported yet (ROADMAP.md, queue 1: parallelism)"


def initialize(run_cfg) -> None:
    """Seeds and logging (reference data/utils/initialize.py:8-36)."""
    if run_cfg.get("multihost"):
        raise NotImplementedError(f"run_cfg.multihost: {PARALLELISM}")
    seed = int(run_cfg.get("seed", 50))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    out = run_cfg.get("output_dir")
    if out:
        os.makedirs(os.path.join(out, "log"), exist_ok=True)
        os.makedirs(os.path.join(out, "ckpt"), exist_ok=True)
        add_log_to_file(os.path.join(out, "log", "log.txt"))


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


def _unported(run_cfg) -> None:
    for key, bad in (("model_parallel", lambda v: int(v) > 1),
                     ("pipeline_stages", lambda v: int(v) > 1),
                     ("zero1", bool)):
        if key in run_cfg and bad(run_cfg[key]):
            raise NotImplementedError(
                f"run_cfg.{key}={run_cfg[key]}: {PARALLELISM}")


def build_model(cfg, run_cfg, model_cfg, device, dtype):
    """The run's model: resume > pretrain_dir > fresh init (reference
    build_model.py:65-124). → (model, cfg, the resumed step or 0)."""
    if run_cfg.get("resume"):
        _, latest = _latest_step(os.path.join(run_cfg["output_dir"], "ckpt"),
                                 "model")
        if latest:
            model = MiCo(cfg, device="cpu", init_weights=False)
            model = model.to_empty(device=device).to(dtype)
            return model, cfg, resume_latest(run_cfg["output_dir"], model)
    if run_cfg.get("pretrain_dir"):
        params, cfg = load_from_pretrained_dir(
            run_cfg["pretrain_dir"],
            video_resolution=int(model_cfg.get("vision_resolution", 224)),
            config_overrides=dict(model_cfg))
        return mico_from_jax(params, cfg, device=device, dtype=dtype), cfg, 0
    return MiCo(cfg, device=device, seed=int(run_cfg.get("seed", 50)),
                dtype=dtype), cfg, 0


def main(argv=None):
    """→ in testing mode the evaluation logs; in training mode the run's
    record (`pipeline.train`)."""
    args = get_args(argv)
    run_cfg, model_cfg = args.run_cfg, args.model_cfg
    device = resolve_device(args["_device"])
    _unported(run_cfg)
    initialize(run_cfg)
    dump_hps({k: v for k, v in args.items() if not k.startswith("_")},
             run_cfg["output_dir"])

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
                                          dtype)

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
            accum_steps=int(run_cfg.get("gradient_accumulation_steps", 1)))
        if resume_step:
            # the moments, the update count (so the LR schedule continues)
            # and an open accumulation window of the resumed step
            load_latest_opt_state(run_cfg["output_dir"], optimizer,
                                  step=resume_step)
        if run_cfg.get("first_eval") and val_loaders:
            test(cfg, model, val_loaders, run_cfg, tokenizer)
        return train(cfg, model, optimizer, meta_loader, val_loaders,
                     run_cfg, tokenizer, start_step=resume_step)
    if mode == "testing":
        logs = test(cfg, model, val_loaders, run_cfg, tokenizer)
        LOGGER.info("test results: %s", logs)
        return logs
    raise ValueError(f"unknown mode {mode}")


if __name__ == "__main__":
    main(sys.argv[1:])
