"""P1, the fused ViT MLP of the matmul probe: wrapper, plain twin and count.

`fused_mlp` replaces the TPU kernel `pallas_mlp`
(scripts/pallas_matmul_probe.py:33, pallas_call :35, body `mlp_kernel`
:24): out = x + bf16(bf16(gelu_tanh(x·W1))·W2), with fp32 accumulation in
both products, GELU's tanh form applied to the fp32 product, and no biases
or LayerNorm. The JAX package keeps it in a script and has no fused-MLP
route in any model (its ViT MLP is linear + bias → GELU → linear + bias,
`mico_tpu/models/eva_vit.py:379-395`), so neither does the port: the probe
(`scripts/torch_mlp_probe.py`) and `chip_smoke.py` drive it. Source:
`csrc/fused_mlp.cu`.

A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from mico_tpu_torch.ops import _build

# shared memory one block may take on an H100 (232,448 bytes)
_MAX_SMEM = 232448
ROWS_PER_BLOCK = (16, 32)


def fused_mlp_plain(x: torch.Tensor, w1: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """P1's twin, `mlp_kernel`'s rounding points: h = x·W1 in fp32, the
    tanh GELU on it in fp32, rounded to x's dtype; y = h·W2 in fp32 over
    all hidden columns, rounded once; out = y + x in x's dtype."""
    h = torch.matmul(x.float(), w1.float())
    h = F.gelu(h, approximate="tanh").to(x.dtype)
    y = torch.matmul(h.float(), w2.float()).to(x.dtype)
    return y + x


def _smem_bytes(rows: int, k: int) -> int:
    """The kernel's dynamic shared memory: the x tile, two 64 x 64 W1
    slices, two 16 x K W2 slices and the h tile (row strides padded by 8)."""
    return 2 * (rows * (k + 8) + 2 * 64 * 72 + 2 * 16 * (k + 8) + rows * 72)


def _check(x, w1, w2, rows_per_block: int):
    """What P1 takes: contiguous bf16 x (M, K), w1 (K, N), w2 (N, K) on one
    device, K a multiple of 64 up to 1536, N a positive multiple of 64,
    `rows_per_block` 16 or 32. Returns (M, K, N)."""
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("P1: x, w1, w2 must be 2-D")
    m, k = x.shape
    n = w1.shape[1]
    if tuple(w1.shape) != (k, n) or tuple(w2.shape) != (n, k):
        raise ValueError(f"P1: w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (x, w1, w2)):
        raise ValueError(f"P1 takes bf16, got {x.dtype}/{w1.dtype}/{w2.dtype}")
    if not all(t.is_contiguous() and t.device == x.device for t in (x, w1, w2)):
        raise ValueError("P1 needs contiguous x, w1, w2 on one device")
    if k % 64 or not 64 <= k <= 1536 or n % 64 or n == 0:
        raise ValueError(f"P1: K={k} must be a multiple of 64 up to 1536 and "
                         f"N={n} a multiple of 64")
    if rows_per_block not in ROWS_PER_BLOCK:
        raise ValueError(f"P1: rows_per_block {rows_per_block} not in "
                         f"{ROWS_PER_BLOCK}")
    if _smem_bytes(rows_per_block, k) > _MAX_SMEM:
        raise ValueError(f"P1: K={k} at {rows_per_block} rows does not fit "
                         "shared memory")
    return m, k, n


@functools.lru_cache(maxsize=None)
def _p1_entry():
    fn = _build.load("fused_mlp").mico_fused_mlp
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              rows_per_block: int = 32) -> torch.Tensor:
    """P1: x (M, K), w1 (K, N), w2 (N, K) → (M, K). On the card contiguous
    bf16 with K a multiple of 64 up to 1536 and N a multiple of 64; M is
    any. `rows_per_block` (16 or 32) is the row tile one block owns, the
    counterpart of `pallas_mlp`'s `tile_m`. CPU tensors take the plain twin."""
    if not x.is_cuda:
        return fused_mlp_plain(x, w1, w2)
    m, k, n = _check(x, w1, w2, rows_per_block)
    out = torch.empty_like(x)
    if m == 0:
        return out
    rc = _p1_entry()(x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                     out.data_ptr(), m, k, n, rows_per_block,
                     torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_mlp: CUDA error {rc}")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
