"""The pretrained checkpoint registry (counterpart of
`mico_tpu/utils/pretrained.py`, kept as this package's own copy): each
model's tags with the provenance URL, file name and expected sha256
(a prefix suffices). Nothing is fetched: `resolve_pretrained` finds the
file in the local cache ($MICO_CACHE, else ~/.cache/mico_tpu, the JAX
package's directory too), checks its digest and returns its path, or
raises naming the URL to fetch it from on a connected machine.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional

# name → tag → {url, filename, sha256}
PRETRAINED: Dict[str, Dict[str, Dict[str, str]]] = {
    "MiCo-ViT-g-14": {
        "omnimodal-300k-b64k": {
            "url": ("https://huggingface.co/Yiyuan/"
                    "MiCo-ViT-g-14-omnimodal-300k-b64K"),
            "filename": "model_step_300000.pt",
            "sha256": "",
        },
    },
    "EVA01-CLIP-g-14": {
        "laion400m": {
            "url": ("https://huggingface.co/QuanSun/EVA-CLIP/resolve/main/"
                    "EVA01_CLIP_g_14_psz14_s11B.pt"),
            "filename": "EVA01_CLIP_g_14_psz14_s11B.pt",
            "sha256": "",
        },
    },
    "BEATs": {
        "iter3-plus-AS2M": {
            "url": ("https://valle.blob.core.windows.net/share/BEATs/"
                    "BEATs_iter3_plus_AS2M.pt"),
            "filename": "BEATs_iter3_plus_AS2M.pt",
            "sha256": "",
        },
    },
}


def cache_dir() -> str:
    return os.environ.get(
        "MICO_CACHE", os.path.expanduser("~/.cache/mico_tpu"))


def list_pretrained() -> List[str]:
    """'model/tag' strings."""
    return [f"{m}/{t}" for m, tags in PRETRAINED.items() for t in tags]


def get_pretrained_cfg(model: str, tag: str) -> Dict[str, str]:
    return PRETRAINED.get(model, {}).get(tag, {})


def get_pretrained_url(model: str, tag: str) -> str:
    return get_pretrained_cfg(model, tag).get("url", "")


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def verify_checkpoint(path: str, expected_sha256: str) -> bool:
    """Whether the file's sha256 starts with `expected_sha256` (always,
    for an empty one)."""
    if not expected_sha256:
        return True
    return sha256_file(path).startswith(expected_sha256.lower())


def resolve_pretrained(model: str, tag: str,
                       cache: Optional[str] = None) -> str:
    """The path of a registered checkpoint in the local cache, its digest
    checked. KeyError for an unregistered one, FileNotFoundError (naming
    the URL) for one not in the cache, ValueError on a digest mismatch."""
    cfg = get_pretrained_cfg(model, tag)
    if not cfg:
        raise KeyError(
            f"unknown pretrained {model}/{tag}; have {list_pretrained()}")
    path = os.path.join(cache or cache_dir(), cfg["filename"])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint {cfg['filename']} not in {cache or cache_dir()}; "
            f"fetch it from {cfg['url']} on a connected machine")
    if not verify_checkpoint(path, cfg.get("sha256", "")):
        raise ValueError(f"sha256 mismatch for {path}")
    return path
