"""Nearest-neighbour resize with torch `F.interpolate(mode='nearest')`
sampling (src = floor(dst * in/out)), the counterpart of
`mico_tpu/ops/interpolate.py` `interp_nearest_1d`."""

from __future__ import annotations

import torch


def interp_nearest_1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Nearest-neighbour resize along the last axis of (..., L)."""
    in_len = x.shape[-1]
    if in_len == out_len:
        return x
    idx = torch.floor(
        torch.arange(out_len, dtype=torch.float32) * (in_len / out_len)
    ).to(torch.int64)
    idx = idx.clamp(0, in_len - 1).to(x.device)
    return torch.index_select(x, -1, idx)
