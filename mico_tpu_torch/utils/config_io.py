"""Layered run/model/data config (counterpart of
`mico_tpu/utils/config_io.py`).

Re-design of data/utils/args.py:
  - three-tier merge: packaged defaults → experiment JSON → CLI overrides
    (only keys actually present on argv override, args.py:18-28)
  - namespaces: run_cfg / model_cfg / data_cfg (args.py:130-134)
  - derived values: max_{vision,audio}_sample_num = max over datasets ×
    concatenated_nums (args.py:118-124)
  - the merged config persisted at `<output_dir>/log/hps.json`
    (args.py:182-184), the file `load_from_pretrained_dir` reads back
    (reference inference_demo.py:17).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List, Optional, Sequence


class AttrDict(dict):
    """dict with attribute access (easydict equivalent)."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def deep(cls, d):
        if isinstance(d, dict):
            return cls({k: cls.deep(v) for k, v in d.items()})
        if isinstance(d, list):
            return [cls.deep(v) for v in d]
        return d


def deep_merge(base: Dict, override: Dict) -> Dict:
    out = copy.deepcopy(dict(base))
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_value(s: str) -> Any:
    try:
        return json.loads(s)
    except (ValueError, TypeError):
        return s


def apply_cli_overrides(cfg: Dict, argv: Sequence[str]) -> Dict:
    """`key=value` or `--section.key value` style overrides; dotted paths
    descend into namespaces. Only keys present on argv change anything."""
    cfg = copy.deepcopy(dict(cfg))
    items: List[tuple] = []
    i = 0
    argv = list(argv)
    while i < len(argv):
        a = argv[i]
        if "=" in a:
            k, v = a.lstrip("-").split("=", 1)
            items.append((k, v))
        elif a.startswith("--") and i + 1 < len(argv):
            items.append((a[2:], argv[i + 1]))
            i += 1
        i += 1
    for key, raw in items:
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(raw)
    return cfg


def derive_sample_nums(cfg: Dict) -> Dict:
    """max_{vision,audio}_sample_num from dataset configs (args.py:118-124,
    141-179): max over train/test datasets of (sample_num ×
    concatenated_nums)."""
    cfg = copy.deepcopy(dict(cfg))
    data_cfg = cfg.get("data_cfg", {})
    vis, aud = [], []
    for split in ("train", "val", "test"):
        for d in data_cfg.get(split, []) or []:
            cat = d.get("concatenated_nums", 1)
            if "vision_sample_num" in d:
                vis.append(d["vision_sample_num"] * cat)
            if "audio_sample_num" in d:
                aud.append(d["audio_sample_num"] * cat)
    model_cfg = cfg.setdefault("model_cfg", {})
    if vis:
        model_cfg["max_vision_sample_num"] = max(vis)
    if aud:
        model_cfg["max_audio_sample_num"] = max(aud)
    return cfg


def load_layered_config(
    experiment_json: Optional[str] = None,
    default_run_cfg: Optional[Dict] = None,
    default_model_cfg: Optional[Dict] = None,
    argv: Sequence[str] = (),
) -> AttrDict:
    cfg: Dict = {
        "run_cfg": dict(default_run_cfg or DEFAULT_RUN_CFG),
        "model_cfg": dict(default_model_cfg or DEFAULT_MODEL_CFG),
        "data_cfg": {},
    }
    if experiment_json:
        with open(experiment_json) as f:
            exp = json.load(f)
        # reference-style default chaining (args.py:12-57): a section may
        # name a base JSON via {"default": "file.json", ...overrides};
        # the file resolves relative to the experiment config's directory
        base_dir = os.path.dirname(os.path.abspath(experiment_json))
        for section in ("run_cfg", "model_cfg"):
            sec = exp.get(section)
            if isinstance(sec, dict) and isinstance(sec.get("default"), str):
                with open(os.path.join(base_dir, sec.pop("default"))) as f:
                    exp[section] = deep_merge(json.load(f), sec)
        cfg = deep_merge(cfg, exp)
    # pretrain_dir inheritance (args.py:40-47): the pretrained run's
    # model_cfg overrides the global inherit keys plus any listed in this
    # config's model_cfg.inherit_keys — BEFORE CLI overrides
    pretrain_dir = cfg["run_cfg"].get("pretrain_dir")
    for i, a in enumerate(argv):        # CLI may set it (args.py:40)
        if a == "--pretrain_dir" and i + 1 < len(argv):
            pretrain_dir = argv[i + 1]
        elif a.startswith("--pretrain_dir="):
            pretrain_dir = a.split("=", 1)[1]
    hps_path = (
        os.path.join(pretrain_dir, "log", "hps.json") if pretrain_dir else ""
    )
    if hps_path and os.path.exists(hps_path):
        with open(hps_path) as f:
            pre_model_cfg = json.load(f).get("model_cfg", {})
        inherit = set(GLOBAL_INHERIT_KEYS) | set(
            cfg["model_cfg"].get("inherit_keys", ())
        )
        cfg["model_cfg"].update(
            {k: v for k, v in pre_model_cfg.items() if k in inherit}
        )
    cfg = apply_cli_overrides(cfg, argv)
    cfg = derive_sample_nums(cfg)
    # special rules (args.py:115-116,126-127)
    if cfg["model_cfg"].get("checkpointing"):
        cfg["run_cfg"]["use_ddp"] = False
    if cfg["run_cfg"].get("bf16"):
        cfg["run_cfg"]["fp16"] = False
    return AttrDict.deep(cfg)


def dump_hps(cfg: Dict, output_dir: str) -> str:
    log_dir = os.path.join(output_dir, "log")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "hps.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2, default=str)
    return path


def load_hps(pretrain_dir: str) -> AttrDict:
    with open(os.path.join(pretrain_dir, "log", "hps.json")) as f:
        return AttrDict.deep(json.load(f))


# always inherited from a pretrain_dir's hps.json (args.py:45)
GLOBAL_INHERIT_KEYS = ("vision_encoder_type", "pool_video")

# defaults mirroring data/caption_config/default_run_cfg.json and
# default_model_cfg.json
DEFAULT_RUN_CFG: Dict = {
    "learning_rate": 1e-4,
    "clip_lr": 5e-7,
    "new_lr": 1e-5,
    "new_params_name": [],
    "optim": "adamw",
    "betas": [0.9, 0.98],
    "weight_decay": 0.01,
    "grad_norm": 2.0,
    "warmup_ratio": 0.1,
    "scheduler": "warmup_linear",
    "seed": 50,
    "fp16": False,
    "bf16": True,
    "gradient_accumulation_steps": 1,
    "use_ddp": True,
    "valid_freq": 10,
    "num_train_steps": 100000,
}

DEFAULT_MODEL_CFG: Dict = {
    "vision_encoder_type": "evaclip01_giant",
    "audio_encoder_type": "beats",
    "vision_resolution": 224,
    "contra_dim": 512,
    "frame_embedding_type": "adaptive",
    "max_vision_sample_num": 4,
    "max_audio_sample_num": 4,
    "max_depth_sample_num": 4,
    "pool_video": False,
    "beam_size": 3,
    "itm_ratio": 0.1,
    "max_caption_len": 40,
    "max_omni_caption_len": 70,
    "max_subtitle_len": 70,
    "checkpointing": False,
}
