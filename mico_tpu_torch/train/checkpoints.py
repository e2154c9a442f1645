"""Checkpoint loading (counterpart of the load side of
`mico_tpu/train/checkpoints.py`).

`load_from_pretrained_dir` reads a released-layout directory, as the
reference inference entry does (inference_demo.py:14-116,
data/utils/build_model.py:65-103): `log/hps.json` for the config, then the
newest HF-trainer `checkpoint-N/pytorch_model*.bin`, or else the newest
`ckpt/model_step_N` — a PyTorch `.pt` state_dict (converted by
`models.mico.mico_from_torch`, with the legacy-key surgery, the embedding
resizes and an audit of the keys it did not read) or this framework's
native `.npz` tree. `.orbax` checkpoints need a JAX library and raise.
Saving and resume (`ModelSaver`) are not ported yet (ROADMAP.md, queue 1:
SCST, checkpoints and the rest of the training core).
"""

from __future__ import annotations

import glob
import logging
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mico_tpu_torch.config import MiCoConfig, mico_config_from_dict
from mico_tpu_torch.utils.config_io import load_hps

LOGGER = logging.getLogger(__name__)
SEP = "/"
_ORBAX = ("loading .orbax checkpoints needs a JAX library: not ported yet "
          "(ROADMAP.md, queue 1: native media decoders and .orbax loading)")


def unflatten_pytree(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        parts = key.split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_pytree_npz(path: str):
    with np.load(path) as z:
        return unflatten_pytree({k: z[k] for k in z.files})


def load_checkpoint_path(path: str):
    """A native model checkpoint by extension: `.npz` (a `.orbax` raises)."""
    if path.endswith(".orbax"):
        raise NotImplementedError(f"{path}: {_ORBAX}")
    return load_pytree_npz(path)


def _latest_step(ckpt_dir: str, prefix: str):
    steps = []
    for p in glob.glob(os.path.join(ckpt_dir, f"{prefix}_step_*")):
        if p.endswith("-tmp"):
            # uncommitted scratch of an interrupted save, never a candidate
            continue
        m = re.search(rf"{prefix}_step_(\d+)", os.path.basename(p))
        if m:
            steps.append((int(m.group(1)), p))
    return max(steps) if steps else (None, None)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A `.pt`/`.bin` state_dict (unwrapping a `"state_dict"` entry), its
    tensors on the CPU. Tensor data is memory-mapped where the file's
    format allows, so it is read as the converter touches it."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except RuntimeError:            # a legacy (non-zip) file cannot be mapped
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def _hf_trainer_state_dict(pretrain_dir: str):
    """HuggingFace-trainer layout: `checkpoint-N/pytorch_model.bin`, possibly
    sharded as `pytorch_model-0000i-of-0000n.bin` (reference
    data/utils/build_model.py:65-88). The merged state dict, or None when
    the layout is absent."""
    steps = []
    for d in os.listdir(pretrain_dir) if os.path.isdir(pretrain_dir) else []:
        if d.startswith("checkpoint-") and d.split("-")[-1].isdigit():
            steps.append(int(d.split("-")[-1]))
    if not steps:
        return None
    cdir = os.path.join(pretrain_dir, f"checkpoint-{max(steps)}")
    single = os.path.join(cdir, "pytorch_model.bin")
    shards = sorted(glob.glob(os.path.join(cdir, "pytorch_model-*.bin")))
    if os.path.exists(single):
        LOGGER.info("load_from_pretrained: %s", single)
        return load_torch_state_dict(single)
    if shards:
        merged: Dict[str, torch.Tensor] = {}
        for s in shards:
            LOGGER.info("load_from_pretrained shard: %s", s)
            merged.update(load_torch_state_dict(s))
        return merged
    return None


def load_from_pretrained_dir(
    pretrain_dir: str,
    video_resolution: int = 224,
    config_overrides: Optional[dict] = None,
    return_modal: str = "full",
    consumed: Optional[set] = None,
) -> Tuple[dict, MiCoConfig]:
    """→ (params tree, MiCoConfig) of a released-layout directory; place
    the tree with `convert.mico_from_jax`.

    return_modal (inference_demo.py:99-112): 'full' = the whole tree;
    'uni' = just the shared vision tower's subtree; 'text' = just BERT's.
    consumed: optional set that collects the checkpoint keys the converter
    read (after the legacy remap); keys it did not read are logged as a
    warning either way."""
    from mico_tpu_torch.models.mico import mico_from_torch, remap_legacy_keys

    hps = load_hps(pretrain_dir)
    model_cfg = dict(hps.get("model_cfg", hps))
    model_cfg["vision_resolution"] = video_resolution
    if config_overrides:
        model_cfg.update(config_overrides)
    cfg = mico_config_from_dict(model_cfg)

    def finish(params):
        if return_modal == "uni":
            return params["vision_encoder"], cfg
        if return_modal == "text":
            return params["bert"], cfg
        return params, cfg

    def convert_with_audit(sd):
        read = set() if consumed is None else consumed
        params = mico_from_torch(sd, cfg, consumed=read)
        leftover = sorted(set(remap_legacy_keys(sd)) - read)
        if leftover:
            LOGGER.warning(
                "checkpoint keys NOT consumed by the converter (%d): %s%s",
                len(leftover), leftover[:8], " ..." if len(leftover) > 8 else "")
        return params

    hf_sd = _hf_trainer_state_dict(pretrain_dir)
    if hf_sd is not None:
        return finish(convert_with_audit(hf_sd))

    ckpt_dir = os.path.join(pretrain_dir, "ckpt")
    _, path = _latest_step(ckpt_dir, "model")
    if path is None:
        raise FileNotFoundError(f"no model_step_* checkpoint in {ckpt_dir}")
    LOGGER.info("load_from_pretrained: %s", path)
    if path.endswith((".npz", ".orbax")):
        return finish(load_checkpoint_path(path))
    return finish(convert_with_audit(load_torch_state_dict(path)))
