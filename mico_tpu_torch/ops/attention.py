"""Multi-head attention entry point (counterpart of `mico_tpu/ops/attention.py`).

Two implementations with the JAX package's routing:
  - `plain`: `plain_attention`, the twin of `xla_attention` — fp32 scores and
    softmax, probabilities cast to v's dtype, fp32 accumulation.
  - `flash`: `flash_attention` (`ops/flash_attention.py`), the resident-KV
    kernel K2 or, past 8192 keys with at least 128 query rows, the KV-tiled
    K6 and its backward K6b on the card, and their plain twins on the CPU.

Shapes: q (B, H, Lq, D); k, v (B, H, Lk, D); additive bias broadcastable to
(B, H, Lq, Lk). Attention-probability dropout (training) is drawn after the
softmax on the plain route, and a positive rate forces that route, as
`mico_tpu/ops/attention.py:39-58, 82-86` do: no kernel keeps the
probabilities to drop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mico_tpu_torch.ops import flash_attention as fa
from mico_tpu_torch.ops.layers import dropout

# 'flash' routes to the plain path when lq·lk is at or below this (the
# ≤64-token text self-attention), as attention.py:95 does
SMALL_ATTN_PLAIN_MAX = 64 * 64


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_generator: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
    dropout_heads: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Twin of `xla_attention`; probabilities dropped after the softmax
    (torch semantics) when a generator and a rate are given.
    `dropout_heads` = (first, all): q holds heads first.. of `all` (a
    tensor-parallel rank's), and the mask is drawn for all heads and cut
    to them, so the ranks drop what one process drops."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = dropout(torch.softmax(scores, dim=-1), dropout_rate,
                    dropout_generator, heads=dropout_heads)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "flash",
    dropout_generator: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
    dropout_heads: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """impl: 'flash' | 'plain'. Tiny self-attention (lq·lk ≤ 4096) stays
    plain under 'flash'; active probability dropout takes the plain route."""
    if dropout_generator is not None and dropout_rate > 0.0:
        return plain_attention(q, k, v, bias=bias, scale=scale,
                               dropout_generator=dropout_generator,
                               dropout_rate=dropout_rate,
                               dropout_heads=dropout_heads)
    if impl == "flash" and q.shape[2] * k.shape[2] <= SMALL_ATTN_PLAIN_MAX:
        impl = "plain"
    if impl == "flash":
        return fa.flash_attention(q, k, v, bias=bias, scale=scale)
    if impl != "plain":
        raise ValueError(f"unknown attention impl {impl!r}")
    return plain_attention(q, k, v, bias=bias, scale=scale)
