"""The run config a pretrained directory carries (counterpart of the
loader half of `mico_tpu/utils/config_io.py`).

A run persists its merged config at `<output_dir>/log/hps.json`, the file
`load_from_pretrained_dir` reads back (reference inference_demo.py:17).
The three-tier merge that writes it is not ported yet (ROADMAP.md, queue 1:
runtime, data engine and evaluation).
"""

from __future__ import annotations

import json
import os


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


def load_hps(pretrain_dir: str) -> AttrDict:
    with open(os.path.join(pretrain_dir, "log", "hps.json")) as f:
        return AttrDict.deep(json.load(f))
