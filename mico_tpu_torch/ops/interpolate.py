"""Resizes with torch `F.interpolate` sampling, written as
`mico_tpu/ops/interpolate.py` writes them (not calls to `F.interpolate`):

- `interp_nearest_1d`: nearest, src = floor(dst * in/out);
- `interp_bilinear_2d`: bilinear with align_corners=False, src = (dst + 0.5)
  * in/out - 0.5 clamped to the input, a 2-tap lerp per axis (separable), no
  antialias. The checkpoint loaders' positional-embedding resizes use it,
  and `resize_bilinear_no_antialias` is its image-named alias;
- `interp_bilinear_2d_np`: its numpy twin (the same sampling math), which
  the media processors run in their host threads.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
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


def _bilinear_weights(in_len: int, out_len: int):
    """Source indices and lerp weights of one axis (`_bilinear_weights`,
    interpolate.py:37-46), in fp32."""
    scale = in_len / out_len
    src = (torch.arange(out_len, dtype=torch.float32) + 0.5) * scale - 0.5
    src = src.clamp(0.0, float(in_len - 1))
    i0 = torch.floor(src).to(torch.int64).clamp(0, in_len - 1)
    i1 = (i0 + 1).clamp(0, in_len - 1)
    return i0, i1, src - i0.to(torch.float32)


def _interp_axis(x: torch.Tensor, out_len: int, axis: int) -> torch.Tensor:
    in_len = x.shape[axis]
    if in_len == out_len:
        return x
    i0, i1, w1 = _bilinear_weights(in_len, out_len)
    x0 = torch.index_select(x, axis, i0.to(x.device))
    x1 = torch.index_select(x, axis, i1.to(x.device))
    shape = [1] * x.dim()
    shape[axis] = out_len
    w1 = w1.reshape(shape).to(x.device, x.dtype)
    return x0 * (1 - w1) + x1 * w1


def interp_bilinear_2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the last two axes of (..., H, W), torch
    `F.interpolate(mode='bilinear', align_corners=False)` sampling."""
    x = _interp_axis(x, out_hw[0], axis=x.dim() - 2)
    return _interp_axis(x, out_hw[1], axis=x.dim() - 1)


def resize_bilinear_no_antialias(img: torch.Tensor,
                                 out_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) bilinear resize exactly as torchvision's tensor-mode
    `Resize` (antialias off) of the reference preprocessing
    (model/imageprocessor.py:26-38)."""
    return interp_bilinear_2d(img, out_hw)


def _interp_axis_np(x: np.ndarray, out_len: int, axis: int) -> np.ndarray:
    in_len = x.shape[axis]
    if in_len == out_len:
        return x
    scale = in_len / out_len
    src = (np.arange(out_len, dtype=np.float32) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, float(in_len - 1))
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_len - 1)
    i1 = np.clip(i0 + 1, 0, in_len - 1)
    w1 = (src - i0.astype(np.float32)).astype(x.dtype)
    x0 = np.take(x, i0, axis=axis)
    x1 = np.take(x, i1, axis=axis)
    shape = [1] * x.ndim
    shape[axis] = out_len
    w1 = w1.reshape(shape)
    return x0 * (1 - w1) + x1 * w1


def interp_bilinear_2d_np(x: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Numpy twin of `interp_bilinear_2d` (torch bilinear, align_corners=
    False, no antialias)."""
    x = _interp_axis_np(x, out_hw[0], axis=x.ndim - 2)
    return _interp_axis_np(x, out_hw[1], axis=x.ndim - 1)
