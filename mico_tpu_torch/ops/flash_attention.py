"""Attention kernels of the main path: wrappers, plain twins and launch counts.

K1 `fused_ln_qkv_self_attention` replaces the Pallas kernel
`_fused_ln_qkv_attn_kernel` (mico_tpu/ops/flash_attention.py:1567, called at
:1641): LayerNorm → packed qkv projection → per-head softmax attention, output
packed (B, L, H·D). Source: `csrc/fused_ln_qkv_attn.cu`.

K2 `flash_attention` replaces the resident-KV `_flash` (:93, call :127) with
both bodies, `_kernel` (no bias, exp2) and `_kernel_bias` (additive bias,
exp), on (B, H, Lq, D). Source: `csrc/flash_attn.cu`.

Each wrapper launches its kernel for CUDA tensors and raises on anything the
kernel does not take; only a tensor on the CPU goes to the plain twin. Each
carries a `launches` count that grows by one per kernel launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from mico_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
# beyond this many KV rows the JAX package leaves the resident kernel
# (flash_attention.py:32); with fewer than KV_TILED_MIN_Q query rows it goes
# to plain math (:615, :639-643), otherwise to the KV-tiled kernel K6
MAX_RESIDENT_KV = 8192
KV_TILED_MIN_Q = 128

# shared memory one block may take on an H100 (232,448 bytes)
_MAX_SMEM = 232448
# K1's attention launch: 6 warps of 16 query rows (fused_ln_qkv_attn.cu)
_K1_ROWS = 96

_c_void_p = ctypes.c_void_p


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def packed_qkv_attention_plain(
    qkv: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """Twin of `_packed_qkv_reference`: (B, L, 3·H·D) → (B, L, H·D) with fp32
    scores and softmax, probabilities cast to v's dtype, fp32 accumulation."""
    b, l, w3 = qkv.shape
    w = w3 // 3
    d = w // num_heads
    q, k, v = (t.reshape(b, l, num_heads, d).transpose(1, 2)
               for t in qkv.split(w, dim=-1))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(qkv.dtype).transpose(1, 2).reshape(b, l, w)


def fused_ln_qkv_plain(x, g, b0, w, bias, num_heads: int, scale: float,
                       eps: float, affine: bool) -> torch.Tensor:
    """Twin of `_fused_ln_qkv_reference` (flash_attention.py:1669-1674) with
    its rounding points: LN in fp32 rounded once to x's dtype, qkv in fp32 +
    bias in fp32 rounded once, then the packed attention."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    if affine:
        xn = xn * g.float() + b0.float()
    xn = xn.to(x.dtype)
    qkv = torch.matmul(xn.float(), w.to(x.dtype).float()) + bias.float()
    return packed_qkv_attention_plain(qkv.to(x.dtype), num_heads, scale)


def flash_attention_plain(q, k, v, bias: Optional[torch.Tensor],
                          scale: float) -> torch.Tensor:
    """Twin of `_kernel` / `_kernel_bias` (flash_attention.py:49-89): q is
    scaled in fp32 and rounded to k's dtype before the product; the bias-free
    body folds log2(e) into that scale and takes exp2, the biased body adds
    the bias in fp32 and takes exp. Full-row softmax, p rounded to v's dtype
    for the PV product, the row sum over unrounded p."""
    qscale = scale * LOG2E if bias is None else scale
    qs = (q.float() * qscale).to(k.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias.float()
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m) if bias is None else torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


# ---------------------------------------------------------------------------
# K1: LN-fused packed self-attention
# ---------------------------------------------------------------------------


def _k1_smem_bytes(l: int, d: int) -> int:
    """Dynamic shared memory of K1's attention launch (mirrors the C side):
    K rows at stride DP+8, V rows (which first stage the Q tile) at stride
    D or D+8, DP = D rounded up to 16."""
    dp = -(-d // 16) * 16
    lp = -(-l // 16) * 16
    vst = d if (d // 8) % 2 == 1 else d + 8
    return 2 * (lp * (dp + 8) + max(lp * vst, _K1_ROWS * (dp + 8)))


@functools.lru_cache(maxsize=None)
def _k1_entry():
    fn = _build.load("fused_ln_qkv_attn").mico_fused_ln_qkv_attn
    fn.argtypes = [_c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, _c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_ln_qkv_self_attention(x, g, b0, w, bias, num_heads: int,
                                scale: float, eps: float,
                                affine: bool) -> torch.Tensor:
    """LN + qkv projection + packed self-attention on the raw residual stream
    x (B, L, W); w (W, 3W) and bias (3W,) the packed projection; g/b0 the LN
    affine (ignored, and may be None, when affine is False). Returns
    (B, L, W). The kernel takes bf16 x and w; the vectors go in as fp32."""
    if not x.is_cuda:
        return fused_ln_qkv_plain(x, g, b0, w, bias, num_heads, scale, eps,
                                  affine)
    _require(x.dim() == 3, f"x must be (B, L, W), got {tuple(x.shape)}")
    b, l, wd = x.shape
    d = wd // num_heads
    _require(x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16,
             f"K1 takes bf16 x and w, got {x.dtype} and {w.dtype}")
    _require(x.is_contiguous() and w.is_contiguous(), "K1 needs contiguous x, w")
    _require(tuple(w.shape) == (wd, 3 * wd) and bias.numel() == 3 * wd,
             f"w must be ({wd}, {3 * wd}) and bias ({3 * wd},)")
    _require(d * num_heads == wd and d % 8 == 0 and d <= 128,
             f"head dim {d} must divide W and be a multiple of 8 up to 128")
    _require(wd % 32 == 0 and (3 * wd) % 128 == 0 and wd <= 2048,
             f"width {wd}: K1 needs W % 32 == 0, 3W % 128 == 0, W <= 2048")
    _require(_k1_smem_bytes(l, d) <= _MAX_SMEM,
             f"L={l} with head dim {d} does not fit K1's shared memory")
    dev = x.device
    for t in (w, bias) + ((g, b0) if affine else ()):
        _require(t.device == dev, "K1 inputs must share one device")
    bias32 = bias.float().contiguous()
    if affine:
        g32, b32 = g.float().contiguous(), b0.float().contiguous()
    else:
        g32 = b32 = bias32           # not read by the kernel
    stats = torch.empty((b * l, 2), dtype=torch.float32, device=dev)
    qkv = torch.empty((b, l, 3 * wd), dtype=x.dtype, device=dev)
    out = torch.empty((b, l, wd), dtype=x.dtype, device=dev)
    rc = _k1_entry()(
        x.data_ptr(), g32.data_ptr(), b32.data_ptr(), w.data_ptr(),
        bias32.data_ptr(), stats.data_ptr(), qkv.data_ptr(), out.data_ptr(),
        b, l, wd, num_heads, float(eps), int(bool(affine)),
        float(scale * LOG2E), _stream(),
    )
    _check(rc, "fused_ln_qkv_attn")
    fused_ln_qkv_self_attention.launches += 1
    return out


fused_ln_qkv_self_attention.launches = 0


# ---------------------------------------------------------------------------
# K2: resident-KV flash attention (KV streamed through shared memory)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _k2_entry():
    fn = _build.load("flash_attn").mico_flash_attn
    fn.argtypes = [_c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float,
        ctypes.c_int, _c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _flash_cuda(q, k, v, bias, scale) -> torch.Tensor:
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
             "q, k, v must be (B, H, L, D)")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    _require(tuple(k.shape) == (b, h, lk, d) and k.shape == v.shape,
             f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    _require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
             f"K2 takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    _require(d % 8 == 0 and d <= 128, f"K2 head dim {d}: multiple of 8, <= 128")
    _require(lk >= 1 and lq >= 1, "empty attention")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.device == q.device, "q/k/v must share one device")
        _require(t.stride(3) == 1, f"{name} must have a unit last stride")
        _require(all(s % 8 == 0 for s in t.stride()[:3])
                 and t.data_ptr() % 16 == 0,
                 f"{name} rows must be 16-byte aligned")
    out = torch.empty((b, lq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    if bias is None:
        bias_t = out                 # not read by the kernel
        strides += [0, 0, 0, 0]
        qscale, pscale = scale * LOG2E, 1.0
    else:
        _require(bias.dim() == 4, "bias must be (B|1, H|1, Lq|1, Lk)")
        _require(bias.device == q.device, "bias must share q's device")
        bias_t = bias.float().expand(b, h, lq, lk)
        strides += list(bias_t.stride())
        qscale, pscale = scale, LOG2E
    c_strides = (ctypes.c_longlong * 16)(*strides)
    rc = _k2_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_t.data_ptr(),
        out.data_ptr(), b, h, lq, lk, d, c_strides, float(qscale),
        float(pscale), int(bias is not None), _stream(),
    )
    _check(rc, "flash_attn")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, Lq, D); k, v (B, H, Lk, D); bias broadcastable
    (B|1, H|1, Lq|1, Lk). Routes as `_flash_diff` does: past 8192 KV rows,
    fewer than 128 query rows take plain math and more need K6, which is not
    ported yet."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if k.shape[2] > MAX_RESIDENT_KV:
        if q.shape[2] < KV_TILED_MIN_Q:
            from mico_tpu_torch.ops.attention import plain_attention

            return plain_attention(q, k, v, bias=bias, scale=scale)
        raise NotImplementedError(
            "K6 (KV-tiled flash attention, mico_tpu/ops/flash_attention.py:"
            "218) is not ported yet: Lk > 8192 with Lq >= 128 "
            "(ROADMAP.md, kernel queue)"
        )
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, bias, float(scale))
    return _flash_cuda(q, k, v, bias, float(scale))


flash_attention.launches = 0

KERNELS = {
    "K1": fused_ln_qkv_self_attention,
    "K2": flash_attention,
}


def _all_kernels() -> dict:
    """K1, K2 and K7 (`ops/int8_attention.py`, which imports this module)."""
    from mico_tpu_torch.ops.int8_attention import int8_cross_attention

    return {**KERNELS, "K7": int8_cross_attention}


def reset_launch_counts() -> None:
    for fn in _all_kernels().values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _all_kernels().items()}
