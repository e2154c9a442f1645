"""Weights from the JAX package's parameter tree into the port.

`params_from_jax` takes the nested dict that `mico_tpu.models.mico.init_mico`
(or its `fold_inference_params`) returns, with numpy leaves, and gives the
port's `state_dict`: the path `a/b/c` becomes the key `a.b.c`, and the
stacked depth axis of `vision_encoder/blocks/*` and `bert/layers/*` is
written out as a ModuleList index (`vision_encoder.blocks.3.qkv_w`). A list
of per-block dicts (the CLIP tower's `blocks`, `init_clip_vit`) maps onto
the same ModuleList keys by its list index. Layouts
are unchanged (linears stay (in, out)). Loading a released `.pt` checkpoint
waits for a later slice (ROADMAP.md, queue 1 item 4).
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping

import numpy as np
import torch

from mico_tpu_torch.config import MiCoConfig
from mico_tpu_torch.models.mico import MiCo, resolve_device

# parameter groups whose leaves carry a leading depth axis
STACKED = ("vision_encoder/blocks", "bert/layers")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, (list, tuple)):
            v = {str(i): item for i, item in enumerate(v)}
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def _skeleton(cfg: MiCoConfig, keys) -> MiCo:
    """A weightless (meta) MiCo with the parameter names `cfg` gives, in the
    layout the state_dict keys are in: folded when they lack a parameter
    that folding removes (a pre-norm block's LN affines and q/v biases, a
    block's LayerScale). A post-norm tower without LayerScale folds to
    itself."""
    canonical = MiCo(cfg, device="cpu", init_weights=False)
    folded = copy.deepcopy(canonical).fold_inference_params()
    removed = set(canonical.state_dict()) - set(folded.state_dict())
    return folded if removed - set(keys) else canonical


def _place(params: Mapping, cfg: MiCoConfig):
    """(state_dict, the skeleton it fills) for the JAX params of `cfg`."""
    flat = _flatten(params)
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in flat.items():
        group, _, name = path.rpartition("/")
        if group in STACKED:
            for i in range(leaf.shape[0]):
                key = f"{group.replace('/', '.')}.{i}.{name}"
                sd[key] = torch.from_numpy(np.array(leaf[i], np.float32))
        else:
            sd[path.replace("/", ".")] = torch.from_numpy(
                np.array(leaf, np.float32))
    model = _skeleton(cfg, sd)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    unplaced = sorted(set(sd) - set(want))
    unfilled = sorted(set(want) - set(sd))
    if unplaced or unfilled:
        raise KeyError(f"JAX leaves with no port parameter: {unplaced}; "
                       f"port parameters with no JAX leaf: {unfilled}")
    bad = [k for k, shape in want.items() if tuple(sd[k].shape) != shape]
    if bad:
        raise ValueError("shape mismatch: " + ", ".join(
            f"{k} {tuple(sd[k].shape)} vs {want[k]}" for k in bad))
    return sd, model


def params_from_jax(params: Mapping, cfg: MiCoConfig) -> Dict[str, torch.Tensor]:
    """The port's state_dict for the JAX params of `cfg` (canonical or
    folded). Raises on a leaf it does not place, on a port parameter it does
    not fill, and on a shape that differs."""
    return _place(params, cfg)[0]


def mico_from_jax(params: Mapping, cfg: MiCoConfig, *, device="cuda",
                  dtype=None) -> MiCo:
    """A MiCo holding the JAX params, on `device` in `dtype` (default
    `cfg.param_dtype`)."""
    dev = resolve_device(device)
    sd, model = _place(params, cfg)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device=dev, dtype=dtype or cfg.dtypes()[0])
