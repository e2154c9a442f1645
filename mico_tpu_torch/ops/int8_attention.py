"""Dequant-fused int8 cross-attention for the KV-cached decode (counterpart
of `mico_tpu/ops/int8_attention.py`).

The beam and sample decode steps read every layer's cross-attention K/V
over the condition tokens each step. `int8_cross_kv=True` in
`generation.py` stores them as symmetric per-(row, head) int8 with fp32
scales (`quantize_kv`), halving those bytes, and dequantises inside kernel
K7, `int8_cross_attention` (source `csrc/int8_cross_attn.cu`), which
replaces the Pallas `_int8_cross_call` (int8_attention.py:86, body :56). Its
plain twin `int8_cross_attention_plain` keeps the Pallas body's rounding
points. The wrapper launches K7 for CUDA tensors and raises on what K7 does
not take; only CPU tensors go to the plain twin. `launches` counts K7's
launches. K7 has no backward, so the wrapper raises rather than return an
output without a gradient when autograd records a call that needs one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from mico_tpu_torch.ops import _build
from mico_tpu_torch.ops.flash_attention import (
    _MAX_SMEM,
    _check,
    _require,
    _stream,
    refuse_grad,
)

# K7's limits (csrc/int8_cross_attn.cu): head dim, query rows, block warps
K7_HEAD_DIM = 64
K7_MAX_Q = 16
_K7_WARPS = 8


def quantize_kv(x: torch.Tensor,
                num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, Lk, H) float → ((B, Lk, H) int8, (B, Lk, nh) fp32 scales):
    symmetric per-(row, head), scale = max(amax, 1e-8) / 127, values
    rounded half to even and clipped to ±127; dequant is x8 · scale."""
    b, lk, h = x.shape
    d = h // num_heads
    xf = x.float().reshape(b, lk, num_heads, d)
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.round(xf / scale[..., None])
    q = q.clamp(-127, 127).to(torch.int8).reshape(b, lk, h)
    return q, scale


def int8_cross_attention_plain(q, k8, ks, v8, vs, num_heads: int,
                               scale: float) -> torch.Tensor:
    """K7's plain twin, at the Pallas body's rounding points
    (int8_attention.py:56-80): K and V dequantised in fp32 and rounded to
    q's dtype; fp32 scores times `scale`; p = exp(s - row max) in fp32
    with the row sum over the unrounded p; p rounded to v's dtype for an
    fp32-accumulated PV; o / l rounded to q's dtype."""
    b, lq, h = q.shape
    lk = k8.shape[1]
    d = h // num_heads

    def dq(x8, s):
        x = x8.float().reshape(b, lk, num_heads, d) * s[..., None]
        return x.to(q.dtype).transpose(1, 2)         # (B, nh, Lk, d)

    kh, vh = dq(k8, ks), dq(v8, vs)
    qh = q.reshape(b, lq, num_heads, d).transpose(1, 2)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(vh.dtype).float(), vh.float())
    return (o / l).to(q.dtype).transpose(1, 2).reshape(b, lq, h)


def _k7_smem_bytes(lq: int, lk: int) -> int:
    """K7's dynamic shared memory (mirrors `smem_floats` on the C side)."""
    return 4 * (lq * K7_HEAD_DIM * (1 + _K7_WARPS) + -(-lq // 4) * 4 + lq * lk)


@functools.lru_cache(maxsize=None)
def _k7_entry():
    fn = _build.load("int8_cross_attn").mico_int8_cross_attn
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int8_cross_attention(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                         v8: torch.Tensor, vs: torch.Tensor, num_heads: int,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Lq, H); k8, v8 (B, Lk, H) int8; ks, vs (B, Lk, nh) fp32.
    Returns (B, Lq, H) in q's dtype. Decode only (no backward). On the card
    K7 takes bf16 q, head dim 64, Lq ≤ 16, and Lq·Lk scores that fit one
    block's shared memory (Lk ≤ 9108 at Lq = 6). Raises under autograd when
    an input requires a gradient, on any device."""
    refuse_grad("K7 (int8_cross_attention)", q, ks, vs)
    if scale is None:
        scale = float(q.shape[-1] // num_heads) ** -0.5
    if not q.is_cuda:
        return int8_cross_attention_plain(q, k8, ks, v8, vs, num_heads,
                                          float(scale))
    _require(q.dim() == 3, f"q must be (B, Lq, H), got {tuple(q.shape)}")
    b, lq, h = q.shape
    lk = k8.shape[1]
    _require(q.dtype == torch.bfloat16, f"K7 takes bf16 q, got {q.dtype}")
    _require(k8.dtype == v8.dtype == torch.int8,
             f"K7 takes int8 K/V, got {k8.dtype}/{v8.dtype}")
    _require(ks.dtype == vs.dtype == torch.float32,
             f"K7 takes fp32 scales, got {ks.dtype}/{vs.dtype}")
    _require(tuple(k8.shape) == (b, lk, h) and v8.shape == k8.shape,
             f"k8/v8 {tuple(k8.shape)}/{tuple(v8.shape)} vs q {tuple(q.shape)}")
    _require(tuple(ks.shape) == (b, lk, num_heads) and vs.shape == ks.shape,
             f"scales {tuple(ks.shape)}/{tuple(vs.shape)}, want "
             f"({b}, {lk}, {num_heads})")
    _require(h == num_heads * K7_HEAD_DIM,
             f"K7 takes head dim {K7_HEAD_DIM}, got H={h} with {num_heads} heads")
    _require(1 <= lq <= K7_MAX_Q and lk >= 1,
             f"K7 takes 1..{K7_MAX_Q} query rows and Lk >= 1, got {lq}, {lk}")
    _require(_k7_smem_bytes(lq, lk) <= _MAX_SMEM,
             f"Lq={lq} x Lk={lk} scores do not fit K7's shared memory")
    for name, x in (("q", q), ("k8", k8), ("ks", ks), ("v8", v8), ("vs", vs)):
        _require(x.device == q.device, "K7 inputs must share one device")
        _require(x.is_contiguous(), f"K7 needs a contiguous {name}")
    _require(k8.data_ptr() % 16 == 0 and v8.data_ptr() % 16 == 0,
             "K7 needs 16-byte aligned K/V rows")
    out = torch.empty_like(q)
    rc = _k7_entry()(
        q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
        vs.data_ptr(), out.data_ptr(), b, lq, lk, h, num_heads, float(scale),
        _stream(),
    )
    _check(rc, "int8_cross_attn")
    int8_cross_attention.launches += 1
    return out


int8_cross_attention.launches = 0
