"""Attention kernels of the main path: wrappers, plain twins and launch counts.

K1 `fused_ln_qkv_self_attention` replaces the Pallas kernel
`_fused_ln_qkv_attn_kernel` (mico_tpu/ops/flash_attention.py:1567, called at
:1641): LayerNorm → packed qkv projection → per-head softmax attention, output
packed (B, L, H·D). Source: `csrc/fused_ln_qkv_attn.cu`: a statistics pass,
then the LayerNorm-prologue instance of K5's GEMM (`csrc/wgmma_gemm.cuh`:
x normalised in registers on its way into the tensor cores) and K5's
attention (`csrc/qkv_attn.cuh`). `ln_gemm_bias` launches the statistics pass
and the GEMM alone, for checks and timing; no model path calls it.

K2 `flash_attention` replaces the resident-KV `_flash` (:93, call :127) with
both bodies, `_kernel` (no bias, exp2) and `_kernel_bias` (additive bias,
exp), on (B, H, Lq, D). Source: `csrc/flash_attn.cu`. K2 and K6 split the
keys across blocks where that fills the card (`flash_plan`); a split call
also launches a combine kernel. It is differentiable as `_flash_diff` is
on the resident route (:686-697): the backward recomputes attention in
plain torch.

K6 `kv_tiled_attention` replaces the KV-tiled `_flash_kv_tiled` (:218, call
:260) and `_flash_kv_tiled_stats` (:286, call :329), body `_kv_tiled_kernel`
(:160): the same attention past MAX_RESIDENT_KV keys, with K6's rounding
points and optionally the per-row log-sum-exp. K6b `kv_tiled_attention_bwd`
replaces `_flash_kv_tiled_bwd` (:486; dQ call :531, dK/dV call :588): its
gradient from that LSE, in one wgmma + TMA pass over the keys split across
blocks (`k6b_plan`) and a combine of the per-split dQ partials. Sources:
`csrc/kv_tiled_attn.cu` (K2's device code, `csrc/flash_attn.cuh`, with K6's
rounding points) and `csrc/kv_tiled_attn_bwd.cu`. `flash_attention` routes
to them as `_flash_diff` does (:637-697); long-context caption training
reaches them.

K3 `packed_attention` replaces `_packed_qkv_fwd` (:1135, call :1155) and
`_packed_fwd` (:885, call :897), body `_packed_body` (:757): self-attention
on projection-layout (B, L, H·D) rows read by column offset. K4
`packed_attention_bwd` replaces `_packed_qkv_bwd` (:1059, call :1070) and
`_packed_bwd` (:1032, call :1040), body `_packed_bwd_body` (:954), its
gradient. Sources: `csrc/packed_attn.cu` (the attention of K1, K5 and K8,
`csrc/qkv_attn.cuh`) and `csrc/packed_attn_bwd.cu` (two wgmma + TMA
launches on the same machinery: the rows' statistics and dQ, then dK and
dV by key tiles). Both take any L. The ViT's training route reaches them
through the autograd Functions `packed_qkv_self_attention` and
`packed_self_attention`.

K9 `packed_qkv_cls_attention` replaces the CLS-split body of
`_packed_qkv_fwd` (:1135, call :1155), `_packed_qkv_cls_kernel` (:809), which
JAX selects when `PACKED_CLS_SPLIT` is on and L > 128 with L % 128 == 1: K3's
function on the fused qkv with the CLS token split out (the patch x patch
tile, a CLS column and a CLS row as fp32 rank-1 terms, natural exp). Source:
`csrc/packed_cls_attn.cu`, an instance of K3's attention (`csrc/qkv_attn.cuh`)
over the patch rows with the CLS terms added; any L >= 2. Its gradient is
K4's, as in JAX (:1199).

K5 `fused_qkv_self_attention` replaces `_fused_qkv_attn_fwd` (:1277, call
:1292), body `_fused_qkv_attn_kernel` (:1229): K1 without the LayerNorm, the
inference attention of a post-norm block (EVA02-CLIP-bigE). K8
`fused_qkv_attn_proj` replaces `_fused_qkv_attn_proj_fwd` (:1443, call
:1459), body :1388: K5 followed by the output projection, the same block's
route when `FUSED_ATTN_PROJ` is on. Sources: `csrc/fused_qkv_attn.cu` and
`csrc/fused_qkv_attn_proj.cu`: the wgmma + TMA GEMM of `csrc/wgmma_gemm.cuh`
and the packed attention of `csrc/qkv_attn.cuh` (one block per head, both
products on wgmma). `bf16_gemm_bias` launches the GEMM alone, for checks
and timing; no model path calls it.

Each wrapper launches its kernel for CUDA tensors and raises on anything the
kernel does not take; only a tensor on the CPU goes to the plain twin (the
JAX dtype gate, which sends other dtypes on the card to the twins, is the
caller's: `kernel_route`). Each carries a `launches` count that grows by
one per call that launches its kernel (K6b launches two, its pass and the
dQ combine, and K2 and K6 past one split of the keys a second, the
combine).
When autograd records a call whose inputs require a gradient, K1, K5 and
K8 take their differentiated routes, as JAX's custom VJPs do
(`_fused_ln_qkv_vjp_fwd` :1703, `_fused_qkv_vjp_fwd` / `_bwd` :1345-1380,
`_fused_qkv_attn_proj_vjp_fwd` / `_bwd` :1522-1554): K5's forward is the
unfused composition (the qkv projection, then K3) and its backward K4 and
the projection's gradients; K1's is the LayerNorm of `ops/layers.py`
feeding K5's route, with autograd through the LayerNorm; K8's forward
launches K8 and saves its inputs, and its backward recomputes qkv and K3's
output, then runs K4 and the three linear gradients. No kernel is added:
the backward work is K3's and K4's. Under `no_grad` the kernels run as
before. K7 has no backward and refuses autograd (`refuse_grad`).
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import Dict, Optional

import torch

from mico_tpu_torch.ops import _build
from mico_tpu_torch.ops.layers import layer_norm, matmul_f32, records_grad

LOG2E = 1.4426950408889634
# beyond this many KV rows the JAX package leaves the resident kernel
# (flash_attention.py:32); with fewer than KV_TILED_MIN_Q query rows it goes
# to plain math (:615, :639-643), otherwise to the KV-tiled kernel K6
MAX_RESIDENT_KV = 8192
KV_TILED_MIN_Q = 128
# under autograd the KV-tiled route treats a bias as a constant mask: K6b
# replays it and it gets a zero gradient; False sends a biased call to the
# plain recompute backward instead, with the bias's true gradient (:627-634)
KV_TILED_BIAS_IS_MASK = True

# shared memory one block may take on an H100 (232,448 bytes)
_MAX_SMEM = 232448

# Routing knobs with the JAX package's defaults (flash_attention.py:1129,
# :1226, :1385, :1564). PACKED_CLS_SPLIT: the fused-qkv self-attention of a
# 128k+1-token sequence takes K9 instead of K3. FUSED_QKV_PROJ: a ViT
# block's inference attention runs its qkv projection in the kernel (K5; K1
# with FUSED_LN_QKV for a pre-norm block). FUSED_ATTN_PROJ: K8, the output
# projection too. FUSED_LN_QKV: a pre-norm block's LN in the kernel (K1).
PACKED_CLS_SPLIT = False
FUSED_QKV_PROJ = True
FUSED_ATTN_PROJ = False
FUSED_LN_QKV = True

_c_void_p = ctypes.c_void_p


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def refuse_grad(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd records this call and an input requires a
    gradient: the kernel has no backward, and its output would carry none."""
    if records_grad(*tensors):
        raise RuntimeError(
            f"{kernel} has no backward: call it under torch.no_grad(), or "
            "take the training route (a train generator selects the "
            "differentiable kernels)")


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def packed_qkv_attention_plain(
    qkv: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """Twin of `_packed_qkv_reference`: (B, L, 3·H·D) → (B, L, H·D) with fp32
    scores and softmax, probabilities cast to v's dtype, fp32 accumulation
    (any H·D: all heads, or a tensor-parallel rank's)."""
    b, l, w3 = qkv.shape
    w = w3 // 3
    d = w // num_heads
    q, k, v = (t.reshape(b, l, num_heads, d).transpose(1, 2)
               for t in qkv.split(w, dim=-1))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(qkv.dtype).transpose(1, 2).reshape(b, l, w)


def _ln_plain(x, g, b0, eps: float, affine: bool) -> torch.Tensor:
    """K1's LayerNorm: fp32 statistics (two-pass variance), (x − mean) ·
    rsqrt(var + eps), the affine in fp32, rounded once to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    if affine:
        xn = xn * g.float() + b0.float()
    return xn.to(x.dtype)


def fused_ln_qkv_plain(x, g, b0, w, bias, num_heads: int, scale: float,
                       eps: float, affine: bool) -> torch.Tensor:
    """Twin of `_fused_ln_qkv_reference` (flash_attention.py:1669-1674) with
    its rounding points: LN in fp32 rounded once to x's dtype, qkv in fp32 +
    bias in fp32 rounded once, then the packed attention."""
    return fused_qkv_plain(_ln_plain(x, g, b0, eps, affine), w, bias,
                           num_heads, scale)


def ln_gemm_plain(x, g, b0, w, bias, eps: float,
                  affine: bool) -> torch.Tensor:
    """The twin of K1's GEMM stage with its LayerNorm (`ln_gemm_bias`): x
    (M, K) normalised as `fused_ln_qkv_plain` does, then `bf16_gemm_plain`."""
    return bf16_gemm_plain(_ln_plain(x, g, b0, eps, affine), w, bias)


def bf16_gemm_plain(a, w, bias) -> torch.Tensor:
    """The twin of K5's and K8's GEMM stage (`bf16_gemm_bias`): a·w + bias
    in fp32 with w in a's dtype, rounded once to a's dtype."""
    out = torch.matmul(a.float(), w.to(a.dtype).float()) + bias.float()
    return out.to(a.dtype)


def fused_qkv_plain(x, w, bias, num_heads: int, scale: float) -> torch.Tensor:
    """K5's twin, `_fused_qkv_reference` (flash_attention.py:1318-1325): qkv
    = x·W + bias in fp32, rounded once to x's dtype, then the packed
    attention."""
    return packed_qkv_attention_plain(bf16_gemm_plain(x, w, bias), num_heads,
                                      scale)


def fused_qkv_attn_proj_plain(x, w, bias, wp, bp, num_heads: int,
                              scale: float,
                              partial: bool = False) -> torch.Tensor:
    """K8's twin, `_fused_qkv_attn_proj_reference` (:1492-1497): K5's twin,
    then ·Wp + bp in fp32, rounded once to x's dtype; `partial`: the fp32
    product ·Wp alone (a rank's share of a row-parallel projection)."""
    o = fused_qkv_plain(x, w, bias, num_heads, scale)
    if partial:
        return torch.matmul(o.float(), wp.to(o.dtype).float())
    return bf16_gemm_plain(o, wp, bp)


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


@functools.lru_cache(maxsize=None)
def _k1_entry():
    fn = _build.load("fused_ln_qkv_attn").mico_fused_ln_qkv_attn
    fn.argtypes = [_c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, _c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _ln_gemm_entry():
    fn = _build.load("fused_ln_qkv_attn").mico_ln_gemm_bias
    fn.argtypes = [_c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, _c_void_p]
    fn.restype = ctypes.c_int
    return fn


# the attention of K1, K3, K5, K8 and K9 (csrc/qkv_attn.cuh): keys a key
# block, rows a Q tile; one key block of K and of V in 64-column chunks of
# 128 bytes; K9's CLS row takes CLS_THREADS threads, and K9 fp32 scratch:
# the CLS token's q, k, v, a chunk's p, column sums, reductions, the CLS
# row's scores and the CLS column of two Q tiles
_QKV_ATTN_KEYS = 272
_QKV_ATTN_QROWS = 64
_CLS_THREADS = 96
_CLS_FLOATS = (3 * 128 + 3 * _CLS_THREADS + 8 + _QKV_ATTN_KEYS
               + 2 * _QKV_ATTN_QROWS)


def _qkv_attn_smem_bytes(d: int, cls: bool = False) -> int:
    """Dynamic shared memory of the attention launch of K1, K3, K5 and K8,
    and with `cls` of K9 (mirrors `qattn::smem_bytes` in
    csrc/qkv_attn.cuh): one key block of K and of V (272 keys, the whole
    head at L ≤ 272; longer rows stream their blocks through them) in
    ⌈D/64⌉ chunks of 128-byte rows, two Q tiles and two output tiles of 64
    rows, eight mbarriers and 1 KB to align the swizzled tiles; K9 adds an
    mbarrier (16 bytes) and its fp32 scratch. It does not grow with L."""
    nt = -(-d // 64)
    return (2 * nt * _QKV_ATTN_KEYS * 128 + 4 * nt * _QKV_ATTN_QROWS * 128
            + 8 * 8 + 1024 + (16 + 4 * _CLS_FLOATS if cls else 0))


# the checks take head dims up to 128, which this bounds at any L
assert _qkv_attn_smem_bytes(128, cls=True) <= _MAX_SMEM


def _check_fused_qkv(name: str, x, w, bias, num_heads: int):
    """The checks K1, K5 and K8 share: bf16 contiguous x (B, L, W_in) and w
    (W_in, 3·H·D) on one device with bias (3·H·D,), where H·D may differ
    from W_in (a tensor-parallel rank's heads); head dim D a multiple of 8
    up to 128 (which gives the GEMM's N % 8, TMA's 16-byte strides, and
    fits the attention's shared memory at any L); W_in a multiple of 8 (the
    GEMM's K); for K1, W_in ≤ 2048 (its statistics pass holds a row in a
    warp's registers). Returns (B, L, W_in, D)."""
    _require(x.dim() == 3, f"{name}: x must be (B, L, W), got {tuple(x.shape)}")
    b, l, wd = x.shape
    _require(x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16,
             f"{name} takes bf16 x and w, got {x.dtype} and {w.dtype}")
    _require(x.is_contiguous() and w.is_contiguous(),
             f"{name} needs contiguous x, w")
    _require(w.dim() == 2 and w.shape[0] == wd and w.shape[1] % 3 == 0
             and bias.numel() == w.shape[1],
             f"{name}: w must be ({wd}, 3·H·D) and bias (3·H·D,), got "
             f"{tuple(w.shape)} and ({bias.numel()},)")
    hd = w.shape[1] // 3
    d = hd // num_heads
    _require(d * num_heads == hd and d % 8 == 0 and d <= 128,
             f"{name}: head dim {d} must divide H·D {hd} over {num_heads} "
             "heads and be a multiple of 8 up to 128")
    _require(wd % 8 == 0, f"{name}: W_in {wd} must be a multiple of 8")
    _require(name != "K1" or wd <= 2048,
             f"width {wd}: K1's LN statistics need W <= 2048")
    _require(w.device == x.device and bias.device == x.device,
             f"{name} inputs must share one device")
    return b, l, wd, d


def fused_ln_qkv_self_attention(x, g, b0, w, bias, num_heads: int,
                                scale: float, eps: float,
                                affine: bool) -> torch.Tensor:
    """LN + qkv projection + packed self-attention on the raw residual stream
    x (B, L, W); w (W, 3·H·D) and bias (3·H·D,) the packed projection of
    the H heads given (all of them, W = H·D, or a tensor-parallel rank's);
    g/b0 the LN affine over W (ignored, and may be None, when affine is
    False). Returns (B, L, H·D). The kernel takes bf16 x and w; the vectors go in as fp32.
    Under autograd (`_fused_ln_qkv_vjp_fwd`, :1703): `layer_norm` of
    `ops/layers.py` (fp32 statistics) feeding K5's differentiated route, so
    the work is K3 and, in the backward, K4; K1 does not launch."""
    if records_grad(x, g, b0, w, bias):
        if x.is_cuda:
            _check_fused_qkv("K1", x, w, bias, num_heads)
        xn = layer_norm(x, g if affine else None, b0 if affine else None, eps)
        return _FusedQKV.apply(xn, w, bias, num_heads, float(scale))
    if not x.is_cuda:
        return fused_ln_qkv_plain(x, g, b0, w, bias, num_heads, scale, eps,
                                  affine)
    b, l, wd, d = _check_fused_qkv("K1", x, w, bias, num_heads)
    hd = num_heads * d
    dev = x.device
    for t in (g, b0) if affine else ():
        _require(t.device == dev, "K1 inputs must share one device")
    bias32 = bias.float().contiguous()
    if affine:
        g32, b32 = g.float().contiguous(), b0.float().contiguous()
    else:
        g32 = b32 = bias32           # not read by the kernel
    stats = torch.empty((b * l, 2), dtype=torch.float32, device=dev)
    qkv = torch.empty((b, l, 3 * hd), dtype=x.dtype, device=dev)
    out = torch.empty((b, l, hd), dtype=x.dtype, device=dev)
    rc = _k1_entry()(
        x.data_ptr(), g32.data_ptr(), b32.data_ptr(), w.data_ptr(),
        bias32.data_ptr(), stats.data_ptr(), qkv.data_ptr(), out.data_ptr(),
        b, l, wd, num_heads, d, float(eps), int(bool(affine)),
        float(scale * LOG2E), _stream(),
    )
    _check(rc, "fused_ln_qkv_attn")
    fused_ln_qkv_self_attention.launches += 1
    return out


fused_ln_qkv_self_attention.launches = 0


# ---------------------------------------------------------------------------
# K5 / K8: projection-fused packed self-attention (post-norm blocks)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _k5_entry():
    fn = _build.load("fused_qkv_attn").mico_fused_qkv_attn
    fn.argtypes = [_c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, _c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _k8_entry():
    fn = _build.load("fused_qkv_attn_proj").mico_fused_qkv_attn_proj
    fn.argtypes = [_c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_float, _c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _gemm_entry():
    fn = _build.load("fused_qkv_attn").mico_bf16_gemm_bias
    fn.argtypes = [_c_void_p] * 4 + [ctypes.c_int] * 3 + [_c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_gemm(a, w, bias, name: str = "bf16_gemm_bias"):
    """What the GEMM stage takes: contiguous bf16 a (M, K) and w (K, N) on
    one device with bias (N,), K and N multiples of 8 (TMA's 16-byte
    strides). Returns (M, K, N)."""
    _require(a.dim() == 2 and w.dim() == 2 and a.shape[1] == w.shape[0]
             and bias.numel() == w.shape[1],
             f"{name}: a {tuple(a.shape)}, w {tuple(w.shape)}, "
             f"bias ({bias.numel()},) do not chain")
    _require(a.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
             and a.is_contiguous() and w.is_contiguous(),
             f"{name} takes contiguous bf16 a and w")
    m, k = a.shape
    n = w.shape[1]
    _require(k % 8 == 0 and n % 8 == 0,
             f"{name}: K {k} and N {n} must be multiples of 8")
    _require(w.device == a.device and bias.device == a.device,
             f"{name} inputs must share one device")
    return m, k, n


def bf16_gemm_bias(a, w, bias) -> torch.Tensor:
    """K5's and K8's GEMM stage alone (csrc/wgmma_gemm.cuh): a (M, K) · w
    (K, N) + bias (N,) with bf16 a, w and an fp32 bias, rounded once to
    bf16. For checks and timing: no model path calls it."""
    if not a.is_cuda:
        return bf16_gemm_plain(a, w, bias)
    m, k, n = _check_gemm(a, w, bias)
    bias32 = bias.float().contiguous()
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _check(_gemm_entry()(a.data_ptr(), w.data_ptr(), bias32.data_ptr(),
                         out.data_ptr(), m, k, n, _stream()),
           "bf16_gemm_bias")
    return out


def ln_gemm_bias(x, g, b0, w, bias, eps: float,
                 affine: bool) -> torch.Tensor:
    """K1's statistics pass and GEMM stage alone (csrc/fused_ln_qkv_attn.cu
    `mico_ln_gemm_bias`): LN(x (M, K)) · w (K, N) + bias (N,), the
    LayerNorm applied on the way into the tensor cores, rounded once to
    bf16. For checks and timing: no model path calls it."""
    if not x.is_cuda:
        return ln_gemm_plain(x, g, b0, w, bias, eps, affine)
    m, k, n = _check_gemm(x, w, bias, "ln_gemm_bias")
    _require(k <= 2048, f"ln_gemm_bias: K {k} must be <= 2048")
    bias32 = bias.float().contiguous()
    g32, b32 = ((g.float().contiguous(), b0.float().contiguous()) if affine
                else (bias32, bias32))
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _check(_ln_gemm_entry()(
        x.data_ptr(), g32.data_ptr(), b32.data_ptr(), w.data_ptr(),
        bias32.data_ptr(), stats.data_ptr(), out.data_ptr(), m, k, n,
        float(eps), int(bool(affine)), _stream()),
        "ln_gemm_bias")
    return out


def fused_qkv_self_attention(x, w, bias, num_heads: int,
                             scale: float) -> torch.Tensor:
    """K5: qkv projection + packed self-attention on the block input x
    (B, L, W), not normalised first; w (W, 3·H·D) and bias (3·H·D,) the
    packed projection of the H heads given (W = H·D, or a tensor-parallel
    rank's heads). Returns (B, L, H·D), ready for the output projection. The
    kernel takes bf16 x and w; the bias goes in as fp32. Under autograd the
    differentiated route `_FusedQKV` runs instead (K3, then K4)."""
    if records_grad(x, w, bias):
        if x.is_cuda:
            _check_fused_qkv("K5", x, w, bias, num_heads)
        return _FusedQKV.apply(x, w, bias, num_heads, float(scale))
    if not x.is_cuda:
        return fused_qkv_plain(x, w, bias, num_heads, scale)
    b, l, wd, d = _check_fused_qkv("K5", x, w, bias, num_heads)
    hd = num_heads * d
    bias32 = bias.float().contiguous()
    qkv = torch.empty((b, l, 3 * hd), dtype=x.dtype, device=x.device)
    out = torch.empty((b, l, hd), dtype=x.dtype, device=x.device)
    rc = _k5_entry()(
        x.data_ptr(), w.data_ptr(), bias32.data_ptr(), qkv.data_ptr(),
        out.data_ptr(), b, l, wd, num_heads, d, float(scale * LOG2E),
        _stream(),
    )
    _check(rc, "fused_qkv_attn")
    fused_qkv_self_attention.launches += 1
    return out


fused_qkv_self_attention.launches = 0


def fused_qkv_attn_proj(x, w, bias, wp, bp, num_heads: int,
                        scale: float, partial: bool = False) -> torch.Tensor:
    """K8: K5 followed by the output projection, ·wp (H·D, W) + bp (W,),
    computed in the kernel's own GEMM. Returns (B, L, W) bf16. Takes what
    K5 takes, and bf16 contiguous wp; the biases go in as fp32. `partial`
    (a tensor-parallel rank's heads, whose out-projection is row-parallel):
    the fp32 product o·wp without bp, for the caller to sum over the model
    group in fp32, add bp once and round once (bp is not read). Under
    autograd `_FusedQKVAttnProj` launches K8 and recomputes through K3 and
    K4 in the backward; the partial form has no differentiated route (the
    tensor-parallel K8 route is inference's)."""
    if records_grad(x, w, bias, wp, bp):
        if partial:
            raise RuntimeError("K8's partial form has no backward: call it "
                               "under torch.no_grad()")
        return _FusedQKVAttnProj.apply(x, w, bias, wp, bp, num_heads,
                                       float(scale))
    if not x.is_cuda:
        return fused_qkv_attn_proj_plain(x, w, bias, wp, bp, num_heads, scale,
                                         partial)
    b, l, wd, d = _check_fused_qkv("K8", x, w, bias, num_heads)
    hd = num_heads * d
    _require(wp.dtype == torch.bfloat16 and wp.is_contiguous()
             and tuple(wp.shape) == (hd, wd) and bp.numel() == wd,
             f"K8: wp must be contiguous bf16 ({hd}, {wd}) and bp ({wd},)")
    _require(wp.device == x.device and bp.device == x.device,
             "K8 inputs must share one device")
    bias32, bp32 = bias.float().contiguous(), bp.float().contiguous()
    qkv = torch.empty((b, l, 3 * hd), dtype=x.dtype, device=x.device)
    o = torch.empty((b, l, hd), dtype=x.dtype, device=x.device)
    out = torch.empty((b, l, wd), dtype=torch.float32 if partial else x.dtype,
                      device=x.device)
    rc = _k8_entry()(
        x.data_ptr(), w.data_ptr(), bias32.data_ptr(), wp.data_ptr(),
        bp32.data_ptr(), qkv.data_ptr(), o.data_ptr(), out.data_ptr(),
        b, l, wd, num_heads, d, int(bool(partial)), float(scale * LOG2E),
        _stream(),
    )
    _check(rc, "fused_qkv_attn_proj")
    fused_qkv_attn_proj.launches += 1
    return out


fused_qkv_attn_proj.launches = 0


# ---------------------------------------------------------------------------
# K2: resident-KV flash attention (KV streamed through shared memory)
# ---------------------------------------------------------------------------


# K2/K6 launch geometry (csrc/flash_attn.cuh): keys a streamed chunk, the
# chunks a split of the keys takes at least where it can, and the packed
# FlashCall the C entries read (every field 8 bytes)
KV_CHUNK = 64
SPLIT_CHUNKS = 2
_FLASH_CALL = struct.Struct("<7q11q16q2d")


def row_warps(lq: int) -> int:
    """Warps of 16 query rows in a K2/K6 block: enough for min(Lq, 128)
    rows, so that one block holds all of a head's query rows up to 128."""
    return -(-min(lq, 128) // 16)


def chunk_splits(lk: int, splits: int):
    """(splits, chunks a split) of Lk keys laid out as at most `splits`
    runs of 64-key chunks: split s takes the chunks [s·per, (s+1)·per) ∩
    [0, ⌈Lk/64⌉). The splits are contiguous, each starts on a chunk and
    none is empty; only the last may end inside a chunk (a ragged Lk)."""
    chunks = -(-lk // KV_CHUNK)
    per = -(-chunks // max(1, min(splits, chunks)))
    return -(-chunks // per), per


def kv_split_plan(lq: int, lk: int, heads: int, sms: int = 132,
                  splits: Optional[int] = None, rw: Optional[int] = None):
    """(splits, chunks a split) of K2's and K6's keys for `heads` = B·H, as
    `chunk_splits` lays them out. Unless `splits` asks for a count, it is
    the fewest that give about two blocks per SM, with SPLIT_CHUNKS chunks
    a split at least: a launch and a combine cost more than a warp's chain
    of one or two chunks (PERF.md §6), so up to two chunks of keys take one
    split."""
    if splits is None:
        chunks = -(-lk // KV_CHUNK)
        blocks = heads * -(-lq // (16 * (rw or row_warps(lq))))
        splits = min(-(-2 * sms // blocks), -(-chunks // SPLIT_CHUNKS))
    return chunk_splits(lk, splits)


def flash_plan(lq: int, lk: int, heads: int, d: int, bias_rows: int = 0,
               sms: int = 132, splits: Optional[int] = None,
               key_warps: Optional[int] = None,
               block_rows: Optional[int] = None):
    """(row warps, key warps, splits, chunks a split) of one K2/K6 launch.
    The splits are `kv_split_plan`'s. Where the grid still has under two
    blocks an SM, key warps walk a split's chunks side by side for the same
    rows (one per chunk, up to 16 warps a block at D ≤ 64, 8 above, and as
    many chunk slots as shared memory holds beside the Q tile), which
    shortens the chain of chunks one warp walks in series. `bias_rows` is
    the staged bias's rows a chunk: 0, 1 (broadcast over the queries) or
    -1 for a row per query row. `splits`, `key_warps` and `block_rows`
    (query rows a block, a multiple of 16) override the plan's counts (the
    benchmark's sweep)."""
    rw = row_warps(min(lq, block_rows or lq))
    nsplit, per = kv_split_plan(lq, lk, heads, sms, splits, rw)
    dp = -(-d // 16) * 16
    rows = 16 * rw if bias_rows < 0 else bias_rows
    slot = 4 * KV_CHUNK * (dp + 8) + 4 * rows * (KV_CHUNK + 8)
    fit = (_MAX_SMEM - 32 * rw * (dp + 8)) // slot
    most = min((16 if d <= 64 else 8) // rw, per, fit)
    if key_warps is None:
        blocks = heads * -(-lq // (16 * rw)) * nsplit
        key_warps = 1 if blocks >= 2 * sms else most
    return rw, max(1, min(key_warps, most)), nsplit, per


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _flash_entry(tiled: bool):
    """K6's (`tiled`) or K2's C entry: one argument, a packed FlashCall."""
    lib = _build.load("kv_tiled_attn" if tiled else "flash_attn")
    fn = lib.mico_kv_tiled_attn if tiled else lib.mico_flash_attn
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn


def _check_heads(name: str, q, k, v, g=None) -> None:
    """The layout K2, K6 and K6b take: bf16 q (B, H, Lq, D), k and v
    (B, H, Lk, D) and, for K6b, g of q's shape, on one device; views with a
    unit last stride and 16-byte aligned rows, such as BERT's transposed
    linear outputs; D a multiple of 8 up to 128. (Messages are built only
    on failure: this runs on every launch.)"""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, L, D)")
    b, h, lq, d = q.shape
    ks = k.shape
    if ks[0] != b or ks[1] != h or ks[3] != d or v.shape != ks:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} vs q "
                         f"{tuple(q.shape)}")
    if g is not None and g.shape != q.shape:
        raise ValueError(f"g shape {tuple(g.shape)} vs q {tuple(q.shape)}")
    bf16 = torch.bfloat16
    if (q.dtype != bf16 or k.dtype != bf16 or v.dtype != bf16
            or (g is not None and g.dtype != bf16)):
        raise ValueError(
            f"{name} takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}"
            + ("" if g is None else f" and g {g.dtype}"))
    if d % 8 or d > 128:
        raise ValueError(f"{name} head dim {d}: multiple of 8, <= 128")
    if ks[2] < 1 or lq < 1:
        raise ValueError("empty attention")
    dev = q.device
    for name_t, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} inputs must share one device")
        st = t.stride()
        if st[3] != 1:
            raise ValueError(f"{name_t} must have a unit last stride")
        if st[0] % 8 or st[1] % 8 or st[2] % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name_t} rows must be 16-byte aligned")


def _heads_out(q: torch.Tensor, length: int) -> torch.Tensor:
    """An uninitialised (B, H, length, D) output laid out as (B, length, H,
    D), the layout BERT reshapes back without a copy."""
    b, h, _, d = q.shape
    return torch.empty_strided((b, h, length, d),
                               (length * h * d, d, h * d, 1),
                               dtype=q.dtype, device=q.device)


def _bias_strides(bias, q, lk):
    """(fp32 bias or None, its (b, h, q, k) strides) of an additive bias
    broadcastable to (B, H, Lq, Lk): stride 0 on every axis of size 1, as
    `expand` gives, without making the view. Keep the tensor alive through
    the launch."""
    if bias is None:
        return None, (0, 0, 0, 0)
    if bias.dim() != 4:
        raise ValueError("bias must be (B|1, H|1, Lq|1, Lk)")
    if bias.device != q.device:
        raise ValueError("bias must share q's device")
    if bias.dtype != torch.float32:
        bias = bias.float()
    b, h, lq, _ = q.shape
    strides = []
    for want, size, st in zip((b, h, lq, lk), bias.shape, bias.stride()):
        if size != want and size != 1:
            raise ValueError(f"bias {tuple(bias.shape)} does not broadcast "
                             f"to {(b, h, lq, lk)}")
        strides.append(0 if size == 1 else st)
    return bias, strides


def _flash_launch(q, k, v, bias, scale: float, tiled: bool,
                  return_lse: bool = False, splits: Optional[int] = None,
                  key_warps: Optional[int] = None,
                  block_rows: Optional[int] = None):
    """Launch K6 (`tiled`, K6's rounding points, optionally the LSE) or K2
    on CUDA tensors as `flash_plan` lays it out, and count one launch of
    the public wrapper's: the split kernel and, past one split, its
    combine. `splits`, `key_warps` and `block_rows` override the plan (the
    benchmark's sweep)."""
    _check_heads("K6" if tiled else "K2", q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bias, bstrides = _bias_strides(bias, q, lk)
    bias_rows = 0 if bias is None else (1 if bstrides[2] == 0 else -1)
    rw, kw, nsplit, per = flash_plan(lq, lk, b * h, d, bias_rows,
                                     _sm_count(q.device.index), splits,
                                     key_warps, block_rows)
    out = _heads_out(q, lq)
    lse = (torch.empty((b, h, lq, 1), dtype=torch.float32, device=q.device)
           if return_lse else None)
    ws = None
    if nsplit > 1:
        ws = torch.empty(nsplit * b * h * lq * (d + 2), dtype=torch.float32,
                         device=q.device)
    if tiled or bias is not None:
        qscale, pscale = scale, LOG2E
    else:
        qscale, pscale = scale * LOG2E, 1.0
    call = _FLASH_CALL.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        0 if bias is None else bias.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(),
        0 if ws is None else ws.data_ptr(),
        b, h, lq, lk, d, rw, kw, nsplit, per, int(bias is not None),
        _stream(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], *bstrides, qscale, pscale)
    _check(_flash_entry(tiled)(call),
           "kv_tiled_attn" if tiled else "flash_attn")
    if tiled:
        kv_tiled_attention.launches += 1
    else:
        flash_attention.launches += 1
    return (out, lse) if return_lse else out


def _flash_forward(q, k, v, bias, scale) -> torch.Tensor:
    """The forward without LSE: K6 past MAX_RESIDENT_KV keys, else K2 (their
    plain twins on the CPU)."""
    if k.shape[2] > MAX_RESIDENT_KV:
        return kv_tiled_attention(q, k, v, bias, scale)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, bias, scale)
    return _flash_launch(q, k, v, bias, scale, tiled=False)


class _Flash(torch.autograd.Function):
    """K2 or K6 (or their plain twins on the CPU) forward; the backward
    recomputes attention in plain torch from the saved q, k, v and bias and
    takes its gradient, as `_flash_diff_bwd` does on every route but the
    KV-tiled masked one (flash_attention.py:686-697): no probability matrix
    is kept between the passes, and the bias gets its gradient by the same
    rule."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias)
        return _flash_forward(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g):
        from mico_tpu_torch.ops.attention import plain_attention

        saved = ctx.saved_tensors
        want = [i for i, t in enumerate(saved)
                if t is not None and ctx.needs_input_grad[i]]
        if not want:
            return None, None, None, None, None
        with torch.enable_grad():
            args = [t.detach().requires_grad_(i in want)
                    if t is not None else None for i, t in enumerate(saved)]
            out = plain_attention(*args[:3], bias=args[3], scale=ctx.scale)
            got = torch.autograd.grad(out, [args[i] for i in want], g)
        grads = [None] * 5
        for i, gi in zip(want, got):
            grads[i] = gi
        return tuple(grads)


class _KVTiled(torch.autograd.Function):
    """The KV-tiled route under autograd (`_flash_diff_fwd` / `_bwd`,
    flash_attention.py:650-685): forward K6 with the per-row LSE, saving q,
    k, v, bias, out and lse; backward δ = Σ(g·out) in fp32 in plain torch,
    then K6b. The bias is a constant mask here (`KV_TILED_BIAS_IS_MASK`):
    its gradient is zero."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        out, lse = kv_tiled_attention(q, k, v, bias, scale, return_lse=True)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if g.stride(-1) != 1:
            g = g.contiguous()
        delta = (g.float() * out.float()).sum(dim=-1, keepdim=True)
        grads = kv_tiled_attention_bwd(q, k, v, g, lse, delta.contiguous(),
                                       bias, ctx.scale)
        grads = [gi if ctx.needs_input_grad[i] else None
                 for i, gi in enumerate(grads)]
        dbias = (torch.zeros_like(bias)
                 if bias is not None and ctx.needs_input_grad[3] else None)
        return (*grads, dbias, None)


def flash_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, Lq, D); k, v (B, H, Lk, D); bias broadcastable
    (B|1, H|1, Lq|1, Lk). Routes as `_flash_diff` does (flash_attention.py:
    637-697): up to MAX_RESIDENT_KV keys K2; past them, fewer than
    KV_TILED_MIN_Q query rows take plain math, more take K6. A call that
    records no gradient runs the forward alone (no autograd Function, no
    LSE). Under autograd the KV-tiled route with no bias or a mask bias
    (`KV_TILED_BIAS_IS_MASK`) is `_KVTiled` (K6 with LSE, then K6b; the
    bias gets a zero gradient); every other route is `_Flash` (K2 or K6,
    then the plain recompute backward)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scale = float(scale)
    tiled = k.shape[2] > MAX_RESIDENT_KV
    if tiled and q.shape[2] < KV_TILED_MIN_Q:
        from mico_tpu_torch.ops.attention import plain_attention

        return plain_attention(q, k, v, bias=bias, scale=scale)
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias))):
        return _flash_forward(q, k, v, bias, scale)
    if tiled and (bias is None or KV_TILED_BIAS_IS_MASK):
        return _KVTiled.apply(q, k, v, bias, scale)
    return _Flash.apply(q, k, v, bias, scale)


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# K6 / K6b: KV-tiled flash attention and its backward (long context)
# ---------------------------------------------------------------------------


def kv_tiled_attention_plain(q, k, v, bias: Optional[torch.Tensor],
                             scale: float, return_lse: bool = False):
    """K6's twin, the rounding points of `_kv_tiled_kernel`
    (flash_attention.py:160-215): q cast to k's dtype with no prescale; s =
    q·kᵀ in fp32 times scale, plus the bias in fp32; p = exp(s − m) in
    natural exp; p rounded to v's dtype for the PV product, the row sum l
    over the unrounded p; o = acc / l in q's dtype and lse = m + log l in
    fp32 (B, H, Lq, 1). Full-row: m is the row's maximum, not a running
    one. The production tiles (`KV_TILED_TQ`/`TK` = 512/2048) and the card's
    64-key chunks change only where p is rounded relative to the running
    maximum, an fp32 rescale of an equally rounded p; a full-row twin is
    the same function for any tiling, and in fp32 equals the tiled kernels
    up to summation order."""
    s = torch.matmul(q.to(k.dtype).float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (torch.matmul(p.to(v.dtype).float(), v.float()) / l).to(q.dtype)
    return (o, m + torch.log(l)) if return_lse else o


def kv_tiled_attention_bwd_plain(q, k, v, g, lse, delta,
                                 bias: Optional[torch.Tensor], scale: float):
    """K6b's twin, the rounding points of `_kv_tiled_dq_kernel` and
    `_kv_tiled_dkv_kernel` (flash_attention.py:369-483): p = exp(s − lse)
    in fp32 with s as K6's; dp = g·vᵀ in fp32; ds = p·(dp − δ)·scale
    rounded to k's dtype; dq = ds·k, dv = bf16(p)ᵀ·g, dk = dsᵀ·q, fp32
    accumulation, written in the inputs' dtypes. Full-row, so there are no
    padded tail rows: the kernels zero theirs (never 0·NaN). → (dq, dk,
    dv)."""
    kf, vf = k.float(), v.float()
    qf, gf = q.to(k.dtype).float(), g.to(v.dtype).float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - lse)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(k.dtype).float()
    dq = torch.matmul(ds, kf).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qf).to(k.dtype)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), gf).to(v.dtype)
    return dq, dk, dv


# K6b's launch geometry (csrc/kv_tiled_attn_bwd.cu): the queries a block
# keeps resident at once (a 64-row tile for each consumer warpgroup)
K6B_GROUP = 128


def k6b_plan(lk: int, heads: int, sms: int = 132):
    """(splits, chunks a split) of K6b's keys for `heads` = B·H, as
    `chunk_splits` lays them out. A block takes an SM (384 threads, 232
    registers for each consumer thread), so the plan asks for the fewest
    splits that fill the card in one wave: ⌊sms / heads⌋, with
    SPLIT_CHUNKS 64-key chunks a split at least."""
    return chunk_splits(lk, min(sms // heads,
                                -(-lk // KV_CHUNK) // SPLIT_CHUNKS))


@functools.lru_cache(maxsize=None)
def _k6b_entry():
    fn = _build.load("kv_tiled_attn_bwd").mico_kv_tiled_attn_bwd
    fn.argtypes = [_c_void_p] * 12 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
        _c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kv_tiled_attention(q, k, v, bias: Optional[torch.Tensor], scale: float,
                       return_lse: bool = False):
    """K6: q (B, H, Lq, D), k, v (B, H, Lk, D), bias broadcastable
    (B|1, H|1, Lq|1, Lk) → o (B, H, Lq, D), and with `return_lse` also the
    per-row log-sum-exp (B, H, Lq, 1) fp32. On the card q, k, v are bf16
    views as K2 takes them (BERT's cross-attention K/V need no copy); CPU
    tensors take the plain twin."""
    if not q.is_cuda:
        return kv_tiled_attention_plain(q, k, v, bias, scale, return_lse)
    return _flash_launch(q, k, v, bias, scale, tiled=True,
                         return_lse=return_lse)


kv_tiled_attention.launches = 0


def _check_row_stats(q, *stats) -> None:
    """K6b's lse and δ: contiguous fp32 (B, H, Lq, 1) on q's device."""
    b, h, lq, _ = q.shape
    for t in stats:
        _require(t.dtype == torch.float32 and tuple(t.shape) == (b, h, lq, 1)
                 and t.is_contiguous() and t.device == q.device,
                 f"K6b: lse and delta must be contiguous fp32 "
                 f"({b}, {h}, {lq}, 1), got {t.dtype} {tuple(t.shape)}")


def kv_tiled_attention_bwd(q, k, v, g, lse, delta,
                           bias: Optional[torch.Tensor], scale: float):
    """K6b: the gradient (dq, dk, dv) of K6 for the output gradient g, from
    K6's lse and δ = Σ(g·out) (each (B, H, Lq, 1) fp32), the bias replayed
    into the scores and given no gradient. On the card q, k, v and g as K6
    takes q, k, v; one call launches the split-key pass and the dQ combine
    as `k6b_plan` lays the splits out, and counts once. CPU tensors take
    the plain twin."""
    if not q.is_cuda:
        return kv_tiled_attention_bwd_plain(q, k, v, g, lse, delta, bias,
                                            scale)
    nsplit, per = k6b_plan(k.shape[2], q.shape[0] * q.shape[1],
                           _sm_count(q.device.index))
    return _k6b_launch(q, k, v, g, lse, delta, bias, scale, nsplit, per)


def _k6b_launch(q, k, v, g, lse, delta, bias, scale: float, nsplit: int,
                per: int):
    """Launch K6b on CUDA tensors in `nsplit` splits of `per` chunks
    (`k6b_plan`'s, or the benchmark's sweep) and count one launch of the
    public wrapper's: the split-key pass and the dQ combine."""
    _check_heads("K6b", q, k, v, g)
    _check_row_stats(q, lse, delta)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dq, dk, dv = _heads_out(q, lq), _heads_out(k, lk), _heads_out(v, lk)
    bias, bstrides = _bias_strides(bias, q, lk)
    strides = [s for t in (q, k, v, g, dq, dk, dv)
               for s in t.stride()[:3]] + list(bstrides)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq_part = torch.empty(b * h * nsplit * lq * d, **f32)
    dkv_acc = (torch.empty(2 * b * h * lk * d, **f32) if lq > K6B_GROUP
               else None)
    rc = _k6b_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        q.data_ptr() if bias is None else bias.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dq_part.data_ptr(),
        None if dkv_acc is None else dkv_acc.data_ptr(), b, h, lq, lk, d,
        nsplit, per, (ctypes.c_longlong * 25)(*strides), float(scale),
        int(bias is not None), _stream(),
    )
    _check(rc, "kv_tiled_attn_bwd")
    kv_tiled_attention_bwd.launches += 1
    return dq, dk, dv


kv_tiled_attention_bwd.launches = 0


# ---------------------------------------------------------------------------
# K3 / K4: packed self-attention forward and backward (ViT training)
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H·D) → (B, H, L, D) fp32."""
    b, l, w = x.shape
    return x.reshape(b, l, num_heads, w // num_heads).transpose(1, 2).float()


def _unheads(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.to(dtype).transpose(1, 2).reshape(b, l, h * d)


def packed_attention_plain(q, k, v, num_heads: int,
                           scale: float) -> torch.Tensor:
    """K3's plain twin, the rounding points of `_packed_body`
    (flash_attention.py:757-796): fp32 scores times scale·log2(e), p =
    exp2(s − row max) unnormalised, p rounded to v's dtype for an
    fp32-accumulated PV product, then o / row sum(p) in q's dtype. q, k, v
    (B, L, H·D) → (B, L, H·D)."""
    s = torch.matmul(_heads(q, num_heads),
                     _heads(k, num_heads).transpose(-1, -2)) * (scale * LOG2E)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(v.dtype).float(), _heads(v, num_heads))
    return _unheads(o / p.sum(dim=-1, keepdim=True), q.dtype)


def packed_attention_bwd_plain(q, k, v, g, num_heads: int, scale: float):
    """K4's plain twin, the explicit formula of `_packed_bwd_body`
    (flash_attention.py:954-1014), not autograd of the forward: p
    normalised in fp32 before it is rounded; dv = bf16(p)ᵀ g; dp = g vᵀ;
    δ = rowsum(dp ∘ p) over the unrounded p; ds = bf16(p ∘ (dp − δ) ·
    scale) with the true scale; dq = ds k, dk = dsᵀ q; fp32 accumulation,
    results in q's dtype. → (dq, dk, dv), each (B, L, H·D)."""
    dt = q.dtype
    qh, kh, vh, gh = (_heads(x, num_heads) for x in (q, k, v, g))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (scale * LOG2E)
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(_unheads(x, dt) for x in (dq, dk, dv))


def packed_qkv_cls_attention_plain(qkv: torch.Tensor, num_heads: int,
                                   scale: float) -> torch.Tensor:
    """K9's plain twin, the rounding points of `_packed_qkv_cls_kernel`
    (flash_attention.py:809-868), which are not K3's: s_pp = q_p·k_pᵀ in
    fp32 times scale; the CLS column s_pc = Σ_d q_p·k_cls, the CLS row
    s_cp = Σ_d k_p·q_cls and s_cc as fp32 elementwise products summed over
    D, times scale; natural exp against m_p = max(rowmax s_pp, s_pc) and
    m_c = max(max s_cp, s_cc); only p_pp is rounded to qkv's dtype (for the
    PV product, fp32 accumulation), p_pc·v_cls and the CLS row Σ p_cp·v_p +
    p_cc·v_cls stay fp32 with the unrounded p; each row is divided by its
    sum after PV and rounded once. qkv (B, L, 3·H·D) → (B, L, H·D)."""
    b, l, w3 = qkv.shape
    w = w3 // 3
    q, k, v = (_heads(x, num_heads) for x in qkv.split(w, dim=-1))
    qp, kp, vp = q[:, :, 1:], k[:, :, 1:], v[:, :, 1:]
    qc, kc, vc = q[:, :, :1], k[:, :, :1], v[:, :, :1]
    s_pp = torch.matmul(qp, kp.transpose(-1, -2)) * scale
    s_pc = (qp * kc).sum(dim=-1, keepdim=True) * scale       # (B, H, P, 1)
    s_cp = (kp * qc).sum(dim=-1, keepdim=True) * scale       # (B, H, P, 1)
    s_cc = (qc * kc).sum(dim=-1, keepdim=True) * scale       # (B, H, 1, 1)
    m_p = torch.maximum(s_pp.amax(dim=-1, keepdim=True), s_pc)
    p_pp, p_pc = torch.exp(s_pp - m_p), torch.exp(s_pc - m_p)
    l_p = p_pp.sum(dim=-1, keepdim=True) + p_pc
    m_c = torch.maximum(s_cp.amax(dim=-2, keepdim=True), s_cc)
    p_cp, p_cc = torch.exp(s_cp - m_c), torch.exp(s_cc - m_c)
    l_c = p_cp.sum(dim=-2, keepdim=True) + p_cc
    o_p = torch.matmul(p_pp.to(qkv.dtype).float(), vp) + p_pc * vc
    o_c = (p_cp * vp).sum(dim=-2, keepdim=True) + p_cc * vc
    return _unheads(torch.cat([o_c / l_c, o_p / l_p], dim=2), qkv.dtype)


def _packed_layout(name: str, ts, num_heads: int) -> int:
    """Check that (B, L, W) views share one row stride `ld` (column slices
    of a fused (B, L, 3W) tensor, or contiguous tensors) that K3/K4 can
    address; returns ld."""
    b, l, w = ts[0].shape
    d = w // num_heads
    ld = ts[0].stride(1)
    for t in ts:
        _require(t.dim() == 3 and tuple(t.shape) == (b, l, w),
                 f"{name}: shapes {[tuple(x.shape) for x in ts]} differ")
        _require(t.dtype == torch.bfloat16,
                 f"{name} takes bf16, got {t.dtype}")
        _require(t.device == ts[0].device, f"{name}: inputs on two devices")
        _require(t.stride(2) == 1 and t.stride(1) == ld
                 and t.stride(0) == l * ld,
                 f"{name}: strides {t.stride()} are not rows of one stride")
        _require(t.data_ptr() % 16 == 0, f"{name}: rows must be 16-byte aligned")
    _require(d * num_heads == w and d % 8 == 0 and d <= 128,
             f"{name}: head dim {d} must divide W and be a multiple of 8 "
             "up to 128")
    _require(ld % 8 == 0, f"{name}: row stride {ld} must be a multiple of 8")
    return ld


@functools.lru_cache(maxsize=None)
def _k3_entry():
    fn = _build.load("packed_attn").mico_packed_attn
    fn.argtypes = [_c_void_p] * 3 + [ctypes.c_int, _c_void_p] + [
        ctypes.c_int] * 4 + [ctypes.c_float, _c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _k4_entry():
    fn = _build.load("packed_attn_bwd").mico_packed_attn_bwd
    fn.argtypes = [_c_void_p] * 3 + [ctypes.c_int] + [_c_void_p] * 5 + [
        ctypes.c_int] * 5 + [ctypes.c_float, _c_void_p]
    fn.restype = ctypes.c_int
    return fn


def packed_attention(q, k, v, num_heads: int, scale: float) -> torch.Tensor:
    """K3: q, k, v (B, L, H·D) → (B, L, H·D). On the card they are bf16
    views with one row stride: the column slices of the fused qkv (stride
    3W) or three contiguous tensors (stride W); any L. CPU tensors take the
    plain twin."""
    if not q.is_cuda:
        return packed_attention_plain(q, k, v, num_heads, scale)
    ld = _packed_layout("K3", (q, k, v), num_heads)
    b, l, w = q.shape
    d = w // num_heads
    out = torch.empty((b, l, w), dtype=q.dtype, device=q.device)
    rc = _k3_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), ld,
                     out.data_ptr(), b, l, num_heads, d,
                     float(scale * LOG2E), _stream())
    _check(rc, "packed_attn")
    packed_attention.launches += 1
    return out


packed_attention.launches = 0


def _check_k4(q, k, v, g, num_heads: int,
              dqkv: Optional[torch.Tensor] = None) -> int:
    """What K4 takes: q, k, v as for K3, g bf16 (B, L, W) contiguous on
    their device and, when given, dqkv contiguous (B, L, 3W); any L.
    Returns q/k/v's row stride."""
    ld = _packed_layout("K4", (q, k, v), num_heads)
    b, l, w = q.shape
    _require(g.dtype == q.dtype and tuple(g.shape) == (b, l, w)
             and g.is_contiguous() and g.device == q.device,
             f"K4: g must be contiguous {tuple(q.shape)} {q.dtype}")
    _require(dqkv is None or (
        tuple(dqkv.shape) == (b, l, 3 * w) and dqkv.is_contiguous()
        and dqkv.dtype == q.dtype and dqkv.device == q.device),
        f"K4: dqkv must be contiguous ({b}, {l}, {3 * w})")
    return ld


def packed_attention_bwd(q, k, v, g, num_heads: int, scale: float,
                         dqkv: Optional[torch.Tensor] = None):
    """K4: the gradient (dq, dk, dv) of `packed_attention` for the output
    gradient g (B, L, H·D). With `dqkv` (B, L, 3·H·D) given, the three are
    written into its column slices (the fused projection's gradient) and
    returned as views of it. On the card q, k, v as for K3 and g bf16 and
    contiguous, any L; CPU tensors take the plain twin."""
    if not q.is_cuda:
        grads = packed_attention_bwd_plain(q, k, v, g, num_heads, scale)
        if dqkv is None:
            return grads
        w = q.shape[-1]
        for i, x in enumerate(grads):
            dqkv[..., i * w:(i + 1) * w] = x
        return tuple(dqkv[..., i * w:(i + 1) * w] for i in range(3))
    ld = _check_k4(q, k, v, g, num_heads, dqkv)
    b, l, w = q.shape
    d = w // num_heads
    if dqkv is None:
        outs = tuple(torch.empty_like(q, memory_format=torch.contiguous_format)
                     for _ in range(3))
    else:
        outs = tuple(dqkv[..., i * w:(i + 1) * w] for i in range(3))
    ldo = outs[0].stride(1)
    # the rows' (m, l, 1/l, delta), rows padded to the columns launch's
    # 64-query tiles
    stats = torch.empty((b, num_heads, -(-l // 64) * 64, 4),
                        dtype=torch.float32, device=q.device)
    rc = _k4_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), ld,
                     g.data_ptr(), stats.data_ptr(),
                     *(o.data_ptr() for o in outs), ldo, b, l, num_heads, d,
                     float(scale), _stream())
    _check(rc, "packed_attn_bwd")
    packed_attention_bwd.launches += 1
    return outs


packed_attention_bwd.launches = 0


def _check_cls(qkv: torch.Tensor, num_heads: int):
    """What K9 takes: contiguous, 16-byte aligned bf16 qkv (B, L, 3W) with
    L >= 2 (any L: past 273 the patch keys stream, as K3's do) and D a
    multiple of 8 up to 128. Returns (B, L, W, D)."""
    _require(qkv.dim() == 3, f"K9: qkv must be (B, L, 3W), got {tuple(qkv.shape)}")
    b, l, w3 = qkv.shape
    w = w3 // 3
    d = w // num_heads
    _require(qkv.dtype == torch.bfloat16, f"K9 takes bf16, got {qkv.dtype}")
    _require(qkv.is_contiguous() and qkv.data_ptr() % 16 == 0,
             "K9 needs a contiguous, 16-byte aligned qkv")
    _require(3 * w == w3 and d * num_heads == w and d % 8 == 0 and d <= 128,
             f"K9: head dim {d} must divide W and be a multiple of 8 up to 128")
    _require(l >= 2, f"K9: L={l} has no patch token")
    return b, l, w, d


@functools.lru_cache(maxsize=None)
def _k9_entry():
    fn = _build.load("packed_cls_attn").mico_packed_cls_attn
    fn.argtypes = [_c_void_p, ctypes.c_int, _c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_float, _c_void_p]
    fn.restype = ctypes.c_int
    return fn


def packed_qkv_cls_attention(qkv: torch.Tensor, num_heads: int,
                             scale: float) -> torch.Tensor:
    """K9: self-attention on the fused qkv (B, L, 3·H·D) → (B, L, H·D) with
    the CLS token (row 0) split out, at `_packed_qkv_cls_kernel`'s rounding
    points. On the card qkv is contiguous bf16, read by column offset (row
    stride 3W) with no split copy; any L ≥ 2, D a multiple of 8 up to 128.
    CPU tensors take the plain twin."""
    if not qkv.is_cuda:
        return packed_qkv_cls_attention_plain(qkv, num_heads, scale)
    b, l, w, d = _check_cls(qkv, num_heads)
    out = torch.empty((b, l, w), dtype=qkv.dtype, device=qkv.device)
    rc = _k9_entry()(qkv.data_ptr(), 3 * w, out.data_ptr(), b, l, num_heads, d,
                     float(scale), _stream())
    _check(rc, "packed_cls_attn")
    packed_qkv_cls_attention.launches += 1
    return out


packed_qkv_cls_attention.launches = 0


def kernel_route(x: torch.Tensor) -> bool:
    """The JAX dtype gate (flash_attention.py:1186-1192, :1204, :1340,
    :1513, :1693): the kernels take bf16 on the card; CUDA fp32 takes the
    plain twins, as JAX takes its identical-math reference; the CPU always
    takes the twins (through the wrappers)."""
    return not x.is_cuda or x.dtype == torch.bfloat16


def _packed_qkv_forward(qkv, num_heads: int, scale: float) -> torch.Tensor:
    """K3 over the column slices of the fused qkv, or K9 under
    `PACKED_CLS_SPLIT` at L = 128k + 1 (`_packed_qkv_fwd`, :1144); the
    plain twin off the kernel route."""
    q, k, v = qkv.chunk(3, dim=-1)
    if not kernel_route(qkv):
        return packed_attention_plain(q, k, v, num_heads, scale)
    l = qkv.shape[1]
    if PACKED_CLS_SPLIT and l > 128 and l % 128 == 1:
        return packed_qkv_cls_attention(qkv, num_heads, scale)
    return packed_attention(q, k, v, num_heads, scale)


def _packed_qkv_backward(qkv, g, num_heads: int,
                         scale: float) -> torch.Tensor:
    """K4 (its plain twin off the kernel route) into one (B, L, 3W)
    gradient of the fused qkv."""
    q, k, v = qkv.chunk(3, dim=-1)
    g = g.contiguous()
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    if kernel_route(qkv):
        packed_attention_bwd(q, k, v, g, num_heads, scale, dqkv)
    else:
        grads = packed_attention_bwd_plain(q, k, v, g, num_heads, scale)
        torch.cat(grads, dim=-1, out=dqkv)
    return dqkv


class _PackedQKV(torch.autograd.Function):
    """Forward K3 (or K9, `_packed_qkv_forward`); saves qkv and not the
    output (`_packed_qkv_vjp_fwd`, :1195); backward K4 into one (B, L, 3W)
    gradient on either forward (JAX has no K9 backward)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(qkv)
        return _packed_qkv_forward(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return _packed_qkv_backward(qkv, g, ctx.num_heads, ctx.scale), None, None


def _projection(x, w, bias) -> torch.Tensor:
    """x (..., K) · w (K, N) + bias in fp32, rounded once to x's dtype (the
    differentiated forward's qkv, `_fused_qkv_vjp_fwd`, :1345)."""
    y = matmul_f32(x.reshape(-1, x.shape[-1]), w) + bias.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[1])


def _projection_grads(x, w, bias, dy, needs):
    """(dx, dw, dbias) of `_projection` for its output gradient dy
    (`_fused_qkv_vjp_bwd`, :1362): dx = dy·wᵀ and dw = xᵀ·dy with fp32
    accumulation, rounded to x's and w's dtypes; dbias = Σ dy in fp32,
    rounded to the bias's dtype. `needs` marks which are wanted."""
    x2 = x.reshape(-1, x.shape[-1])
    dy2 = dy.reshape(-1, dy.shape[-1]).to(x.dtype)
    dx = dw = db = None
    if needs[0]:
        dx = matmul_f32(dy2, w.t()).to(x.dtype).reshape(x.shape)
    if needs[1]:
        dw = matmul_f32(x2.t(), dy2).to(w.dtype)
    if needs[2]:
        db = dy2.float().sum(dim=0).to(bias.dtype)
    return dx, dw, db


class _FusedQKV(torch.autograd.Function):
    """K5's differentiated route (`_fused_qkv_vjp_fwd` / `_bwd`,
    :1345-1380): forward the unfused composition, qkv = x·w + bias (fp32
    accumulation, one rounding) into K3, saving (x, w, bias, qkv);
    backward K4 for dqkv, then the projection's gradients. The plain twins
    off the kernel route."""

    @staticmethod
    def forward(ctx, x, w, bias, num_heads, scale):
        qkv = _projection(x, w, bias)
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(x, w, bias, qkv)
        return _packed_qkv_forward(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        x, w, bias, qkv = ctx.saved_tensors
        dqkv = _packed_qkv_backward(qkv, g.to(qkv.dtype), ctx.num_heads,
                                    ctx.scale)
        return (*_projection_grads(x, w, bias, dqkv, ctx.needs_input_grad),
                None, None)


class _FusedQKVAttnProj(torch.autograd.Function):
    """K8's differentiated route (`_fused_qkv_attn_proj_vjp_fwd` / `_bwd`,
    :1522-1554): forward K8 itself (its plain twin on the CPU), saving only
    the inputs; backward recomputes qkv and K3's output o, then the
    out-projection's gradients (do = g·wpᵀ, dwp = oᵀ·g, dbp = Σ g), K4 for
    dqkv and the qkv projection's gradients."""

    @staticmethod
    def forward(ctx, x, w, bias, wp, bp, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(x, w, bias, wp, bp)
        return fused_qkv_attn_proj(x, w, bias, wp, bp, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        x, w, bias, wp, bp = ctx.saved_tensors
        nh, scale = ctx.num_heads, ctx.scale
        needs = ctx.needs_input_grad
        qkv = _projection(x, w, bias)
        o = _packed_qkv_forward(qkv, nh, scale)
        do, dwp, dbp = _projection_grads(o, wp, bp, g, (True,) + needs[3:5])
        dqkv = _packed_qkv_backward(qkv, do, nh, scale)
        return (*_projection_grads(x, w, bias, dqkv, needs[:3]), dwp, dbp,
                None, None)


class _Packed(torch.autograd.Function):
    """Forward K3 on three (B, L, W) inputs, never K9 (`_packed_fwd`, :885);
    saves q, k, v (`_packed_vjp_fwd`, :1099); backward K4."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(q, k, v)
        if kernel_route(q):
            return packed_attention(q, k, v, num_heads, scale)
        return packed_attention_plain(q, k, v, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.contiguous()
        if kernel_route(q):
            dq, dk, dv = packed_attention_bwd(q, k, v, g, ctx.num_heads,
                                              ctx.scale)
        else:
            dq, dk, dv = packed_attention_bwd_plain(q, k, v, g, ctx.num_heads,
                                                    ctx.scale)
        return dq, dk, dv, None, None


def packed_qkv_self_attention(qkv: torch.Tensor, num_heads: int,
                              scale: float) -> torch.Tensor:
    """Self-attention on the fused projection output (B, L, 3·H·D) →
    (B, L, H·D), differentiable (`packed_qkv_self_attention`, :1180): K3,
    or K9 under `PACKED_CLS_SPLIT` at L = 128k + 1; backward K4; any L."""
    return _PackedQKV.apply(qkv, num_heads, float(scale))


def packed_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int, scale: float) -> torch.Tensor:
    """Self-attention on projection-layout q, k, v (B, L, H·D) →
    (B, L, H·D), differentiable (`packed_self_attention`, :936); any L."""
    return _Packed.apply(q, k, v, num_heads, float(scale))


KERNELS = {
    "K1": fused_ln_qkv_self_attention,
    "K2": flash_attention,
    "K3": packed_attention,
    "K4": packed_attention_bwd,
    "K5": fused_qkv_self_attention,
    "K6": kv_tiled_attention,
    "K6b": kv_tiled_attention_bwd,
    "K8": fused_qkv_attn_proj,
    "K9": packed_qkv_cls_attention,
}


def _all_kernels() -> dict:
    """K1-K6b, K8, K9, K7 (`ops/int8_attention.py`, which imports this
    module) and P1 (`ops/fused_mlp.py`)."""
    from mico_tpu_torch.ops.fused_mlp import fused_mlp
    from mico_tpu_torch.ops.int8_attention import int8_cross_attention

    return {**KERNELS, "K7": int8_cross_attention, "P1": fused_mlp}


def reset_launch_counts() -> None:
    for fn in _all_kernels().values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _all_kernels().items()}
