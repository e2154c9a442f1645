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

`k7_plan` chooses, by shape, one of K7's two plans: the fast one (persistent
CTAs over the (batch row, head) items, K/V through a TMA ring, tensor-core
products; `k7_items` lists each CTA's items) where its shared memory fits,
else the large one (the first body, a block per item). The fast plan's tensor maps are
encoded once per (pointer, shape, stride) of K, V and their scales and kept
(`_k7_maps`), so a decode's steps reuse them.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from mico_tpu_torch.ops import _build
from mico_tpu_torch.ops.flash_attention import (
    _MAX_SMEM,
    _check,
    _sm_count,
    _stream,
    refuse_grad,
)

# K7's limits (csrc/int8_cross_attn.cu): head dim, query rows, the large
# plan's block warps
K7_HEAD_DIM = 64
K7_MAX_Q = 16
_K7_WARPS = 8
# the fast plan's geometry (namespace k7 of the source): consumer warps,
# keys a ring stage (16 a warp), a stage's bytes (int8 rows and a 4-head
# scale box), the partial O's padded row, the ring's depth
K7_FAST_WARPS = 12
K7_STAGE_ROWS = 16 * K7_FAST_WARPS
_K7_STAGE_BYTES = K7_STAGE_ROWS * (K7_HEAD_DIM + 16)
_K7_OSTRIDE = K7_HEAD_DIM + 4
K7_MIN_STAGES, K7_MAX_STAGES = 2, 8
# tensor maps kept for this many (K, V, scales) sets: a decode has one a
# layer
_K7_MAP_CACHE = 64


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
    """K7's large plan's dynamic shared memory (mirrors `smem_floats` on the
    C side); the wrapper takes every shape where it fits."""
    return 4 * (lq * K7_HEAD_DIM * (1 + _K7_WARPS) + -(-lq // 4) * 4 + lq * lk)


def _k7_fast_smem_bytes(n_tile: int, lk: int, stages: int) -> int:
    """The fast plan's dynamic shared memory (mirrors `k7::smem_bytes`): the
    alignment, the ring, n_tile rows of fp32 scores over Lk rounded up to a
    stage, the warps' partial O and their row maxima and sums, the
    mbarriers."""
    nst = -(-lk // K7_STAGE_ROWS)
    w = K7_FAST_WARPS
    return (1024 + stages * _K7_STAGE_BYTES + nst * w * 64 * n_tile
            + w * n_tile * _K7_OSTRIDE * 4 + 2 * w * n_tile * 4 + 16 * stages)


class K7Plan(NamedTuple):
    """How one K7 call runs. `route` "fast": `ctas` persistent CTAs walk
    the B·nh items (`k7_items`), a ring of `stages` buffers of
    K7_STAGE_ROWS keys, the query rows padded to `n_tile` (8 or 16) for the
    tensor cores. "large": a block per item (ctas = B·nh, stages 0)."""
    route: str
    ctas: int
    n_tile: int
    stages: int


@functools.lru_cache(maxsize=1024)
def k7_plan(b: int, nh: int, lq: int, lk: int, sms: int = 132) -> K7Plan:
    """K7's plan for q (b, lq, nh·64) over lk keys on a card of `sms` SMs.
    The fast plan where its shared memory fits one SM at K7_MIN_STAGES
    stages and nh is a multiple of 4 (its scale map reads 4 heads' 16-byte
    columns): one CTA an SM (at most one per item) and the deepest ring
    that fits, up to K7_MAX_STAGES. Otherwise the large plan, by shape
    alone."""
    n_tile = 8 if lq <= 8 else 16
    items = b * nh
    if nh % 4 == 0:
        for stages in range(K7_MAX_STAGES, K7_MIN_STAGES - 1, -1):
            if _k7_fast_smem_bytes(n_tile, lk, stages) <= _MAX_SMEM:
                return K7Plan("fast", min(items, sms), n_tile, stages)
    return K7Plan("large", items, n_tile, 0)


def k7_items(plan: K7Plan, b: int, nh: int) -> List[List[int]]:
    """The items (b·nh + h) each CTA of a fast plan walks, in its order:
    CTA i takes i, i + ctas, ... (consecutive CTAs take one batch row's
    heads together)."""
    return [list(range(cta, b * nh, plan.ctas)) for cta in range(plan.ctas)]


@functools.lru_cache(maxsize=None)
def _k7_lib():
    lib = _build.load("int8_cross_attn")
    lib.mico_k7_maps.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.mico_int8_cross_attn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.mico_int8_cross_attn_large.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    for fn in (lib.mico_k7_maps, lib.mico_int8_cross_attn,
               lib.mico_int8_cross_attn_large):
        fn.restype = ctypes.c_int
    return lib


_k7_sms = functools.lru_cache(maxsize=None)(_sm_count)
_K7_MAPS: "collections.OrderedDict[tuple, ctypes.Array]" = (
    collections.OrderedDict())


def _k7_map_key(k8, ks, v8, vs) -> tuple:
    """What a set of the fast plan's tensor maps encodes, and nothing else:
    each tensor's pointer, shape and strides. A map looked up by it is never
    stale."""
    return tuple((x.data_ptr(), tuple(x.shape), x.stride())
                 for x in (k8, ks, v8, vs))


def _k7_maps(k8, ks, v8, vs, nh: int):
    """The four tensor maps of the fast plan (a 512-byte host buffer),
    encoded at the first call with these tensors and kept for the next
    _K7_MAP_CACHE sets (least recently used out first)."""
    key = _k7_map_key(k8, ks, v8, vs)
    maps = _K7_MAPS.get(key)
    if maps is not None:
        _K7_MAPS.move_to_end(key)
        return maps
    b, lk, h = k8.shape
    maps = ctypes.create_string_buffer(4 * 128)
    _check(_k7_lib().mico_k7_maps(k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
                                  vs.data_ptr(), b, lk, h, nh, maps),
           "int8_cross_attn tensor maps")
    _K7_MAPS[key] = maps
    if len(_K7_MAPS) > _K7_MAP_CACHE:
        _K7_MAPS.popitem(last=False)
    return maps


def _k7_check(q, k8, ks, v8, vs, nh: int) -> Tuple[int, int, int]:
    """What K7 takes on the card; returns (B, Lq, Lk). Messages are built
    only on failure: this runs on every decode step."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, Lq, H), got {tuple(q.shape)}")
    b, lq, h = q.shape
    lk = k8.shape[1]
    if q.dtype != torch.bfloat16:
        raise ValueError(f"K7 takes bf16 q, got {q.dtype}")
    if not k8.dtype == v8.dtype == torch.int8:
        raise ValueError(f"K7 takes int8 K/V, got {k8.dtype}/{v8.dtype}")
    if not ks.dtype == vs.dtype == torch.float32:
        raise ValueError(f"K7 takes fp32 scales, got {ks.dtype}/{vs.dtype}")
    if k8.shape != (b, lk, h) or v8.shape != k8.shape:
        raise ValueError(f"k8/v8 {tuple(k8.shape)}/{tuple(v8.shape)} vs q "
                         f"{tuple(q.shape)}")
    if ks.shape != (b, lk, nh) or vs.shape != ks.shape:
        raise ValueError(f"scales {tuple(ks.shape)}/{tuple(vs.shape)}, want "
                         f"({b}, {lk}, {nh})")
    if h != nh * K7_HEAD_DIM:
        raise ValueError(f"K7 takes head dim {K7_HEAD_DIM}, got H={h} with "
                         f"{nh} heads")
    if not (1 <= lq <= K7_MAX_Q and lk >= 1):
        raise ValueError(f"K7 takes 1..{K7_MAX_Q} query rows and Lk >= 1, "
                         f"got {lq}, {lk}")
    if _k7_smem_bytes(lq, lk) > _MAX_SMEM:
        raise ValueError(f"Lq={lq} x Lk={lk} scores do not fit K7's shared "
                         "memory")
    for name, x in (("q", q), ("k8", k8), ("ks", ks), ("v8", v8), ("vs", vs)):
        if x.device != q.device:
            raise ValueError("K7 inputs must share one device")
        if not x.is_contiguous():
            raise ValueError(f"K7 needs a contiguous {name}")
    for x in (k8, ks, v8, vs):
        if x.data_ptr() % 16:
            raise ValueError("K7 needs 16-byte aligned K/V and scales")
    return b, lq, lk


def _k7_launch(q, k8, ks, v8, vs, nh: int, scale: float,
               plan: K7Plan) -> torch.Tensor:
    """One K7 launch of `plan` on checked inputs; counts it."""
    b, lq, h = q.shape
    lk = k8.shape[1]
    out = torch.empty_like(q)
    lib = _k7_lib()
    if plan.route == "fast":
        rc = lib.mico_int8_cross_attn(
            q.data_ptr(), out.data_ptr(), _k7_maps(k8, ks, v8, vs, nh), b, lq,
            lk, h, nh, scale, plan.ctas, plan.stages, plan.n_tile, _stream())
    else:
        rc = lib.mico_int8_cross_attn_large(
            q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
            vs.data_ptr(), out.data_ptr(), b, lq, lk, h, nh, scale, _stream())
    _check(rc, "int8_cross_attn")
    int8_cross_attention.launches += 1
    return out


def int8_cross_attention(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                         v8: torch.Tensor, vs: torch.Tensor, num_heads: int,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Lq, H); k8, v8 (B, Lk, H) int8; ks, vs (B, Lk, nh) fp32.
    Returns (B, Lq, H) in q's dtype. Decode only (no backward). On the card
    K7 takes bf16 q, head dim 64, Lq ≤ 16, and Lq·Lk scores that fit one
    block's shared memory (Lk ≤ 9108 at Lq = 6), with K/V and scales
    16-byte aligned; `k7_plan` picks the plan. Raises under autograd when
    an input requires a gradient, on any device."""
    refuse_grad("K7 (int8_cross_attention)", q, ks, vs)
    if scale is None:
        scale = float(q.shape[-1] // num_heads) ** -0.5
    if not q.is_cuda:
        return int8_cross_attention_plain(q, k8, ks, v8, vs, num_heads,
                                          float(scale))
    b, lq, lk = _k7_check(q, k8, ks, v8, vs, num_heads)
    plan = k7_plan(b, num_heads, lq, lk, _k7_sms(q.device.index))
    return _k7_launch(q, k8, ks, v8, vs, num_heads, float(scale), plan)


int8_cross_attention.launches = 0
