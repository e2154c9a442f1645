"""Dataloaders made from the layered config (counterpart of
`mico_tpu/data/build.py`).

The reference's dataloader construction (data/utils/build_dataloader.py:
11-126):
  - per-dataset config entries (name, type, task, batch_size, n_workers,
    steps|epoch) from `data_cfg.train` / `data_cfg.val`;
  - train: shuffled padded sampling, drop_last; val: no padding, so no
    eval sample is duplicated;
  - MetaLoader step-ratio weighting = the dataset's train_steps; total
    num_train_steps defaulted to the sum; `valid_steps` set to
    num_train_steps // valid_freq - 1, over any value the config gave.
Across processes (one a card, the default `torch.distributed` group) each
rank loads `batch_size // world` rows (JAX divides by its processes,
data/build.py:6-11, 50-51) from its shard of the sampler: a training
batch must divide (the global batch is the configured one), an evaluation
batch is floored as JAX floors it. Every rank draws the same task at every
step (the MetaLoader's shared seed).
"""

from __future__ import annotations

from typing import Dict, Optional

from mico_tpu_torch.data.loader import CudaPrefetcher, DataLoader, MetaLoader
from mico_tpu_torch.data.sampler import ShardedSampler
from mico_tpu_torch.parallel.collectives import data_shard
from mico_tpu_torch.utils.logger import LOGGER


def _registry():
    from mico_tpu_torch.data import data_registry

    return data_registry


def _world():
    """(data-axis size, this process's data index) of the run's mesh; (1,
    0) without a process group. The ranks of a model group load the same
    rows."""
    return data_shard()


def build_dataloader(dataset, is_train: bool, batch_size: int,
                     n_workers: int = 4, use_sampler: bool = True,
                     seed: int = 0) -> DataLoader:
    num_shards, shard_id = _world()
    if is_train and batch_size % num_shards:
        raise ValueError(
            f"global batch {batch_size} is not divisible by the {num_shards} "
            f"processes; raise data_cfg batch_size or run fewer processes")
    per_host_bs = max(1, batch_size // num_shards)
    sampler = None
    if use_sampler and getattr(dataset, "use_sampler", True):
        sampler = ShardedSampler(len(dataset), num_shards=num_shards,
                                 shard_id=shard_id, shuffle=is_train,
                                 pad=is_train, seed=seed)
    return DataLoader(dataset, sampler=sampler, batch_size=per_host_bs,
                      num_workers=n_workers or 4, drop_last=is_train)


def create_train_dataloaders(args, device="cuda") -> Optional[CudaPrefetcher]:
    data_cfg = args.data_cfg.get("train", [])
    if not data_cfg:
        return None
    run_cfg = args.run_cfg
    accum = int(run_cfg.get("gradient_accumulation_steps", 1))
    seed = int(run_cfg.get("seed", 0))
    loaders: Dict = {}
    train_steps = []
    for d_cfg in data_cfg:
        name = d_cfg["name"]
        dataset = _registry()[d_cfg.get("type", "annoindexed")](
            d_cfg, args.model_cfg, seed=seed)
        LOGGER.info("Create Dataset %s Success", name)
        batch_size = int(d_cfg["batch_size"])
        if "steps" in d_cfg:
            steps = int(d_cfg["steps"])
        else:
            steps = int((len(dataset) // batch_size) * d_cfg.get("epoch", 1))
        train_steps.append(steps)
        loader = build_dataloader(dataset, True, batch_size // accum,
                                  d_cfg.get("n_workers", 4), seed=seed)
        loaders[f"{d_cfg['task']}--{name}"] = (loader, steps)
        LOGGER.info("loader %s, ratio %d, bs_perhost %d", name, steps,
                    loader.batch_size)

    meta = MetaLoader(loaders, accum_steps=accum, seed=seed)
    if int(run_cfg.get("num_train_steps", 0)) == 0:
        run_cfg["num_train_steps"] = sum(train_steps)
    run_cfg["valid_steps"] = max(1, run_cfg["num_train_steps"]
                                 // int(run_cfg.get("valid_freq", 10)) - 1)
    out = CudaPrefetcher(meta, device=device)
    out.ndata = len(loaders)
    return out


def create_val_dataloaders(args, device="cuda") -> Dict[str, CudaPrefetcher]:
    data_cfg = args.data_cfg.get("val", [])
    seed = int(args.run_cfg.get("seed", 0))
    out: Dict[str, CudaPrefetcher] = {}
    for d_cfg in data_cfg:
        name = d_cfg["name"]
        d_cfg = dict(d_cfg)
        d_cfg.setdefault("training", False)
        dataset = _registry()[d_cfg.get("type", "annoindexed")](
            d_cfg, args.model_cfg, seed=seed)
        dataset.name = name
        LOGGER.info("Create Dataset %s Success", name)
        loader = build_dataloader(dataset, False, int(d_cfg["batch_size"]),
                                  d_cfg.get("n_workers", 4), seed=seed)
        out[f"{d_cfg['task']}--{name}"] = CudaPrefetcher(loader, device=device)
    return out
