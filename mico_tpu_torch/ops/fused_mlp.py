"""P1, the fused ViT MLP of the matmul probe: wrapper, plain twin and count.

`fused_mlp` replaces the TPU kernel `pallas_mlp`
(scripts/pallas_matmul_probe.py:33, pallas_call :35, body `mlp_kernel`
:24): out = x + bf16(bf16(gelu_tanh(x·W1))·W2), with fp32 accumulation in
both products, GELU's tanh form applied to the fp32 product, and no biases
or LayerNorm. The JAX package keeps it in a script and has no fused-MLP
route in any model (its ViT MLP is linear + bias → GELU → linear + bias,
`mico_tpu/models/eva_vit.py:379-395`), so neither does the port: the probe
(`scripts/torch_mlp_probe.py`) and `chip_smoke.py` drive it. Source:
`csrc/fused_mlp.cu`: two launches of the wgmma + TMA GEMM of
`csrc/wgmma_gemm.cuh`, fc1 with a GELU epilogue into a bf16 hidden tensor
h (the wrapper's scratch), fc2 with the residual epilogue. One call counts
one launch.

A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from mico_tpu_torch.ops import _build


def fused_mlp_plain(x: torch.Tensor, w1: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """P1's twin, `mlp_kernel`'s rounding points: h = x·W1 in fp32, the
    tanh GELU on it in fp32, rounded to x's dtype; y = h·W2 in fp32 over
    all hidden columns, rounded once; out = y + x in x's dtype."""
    h = torch.matmul(x.float(), w1.float())
    h = F.gelu(h, approximate="tanh").to(x.dtype)
    y = torch.matmul(h.float(), w2.float()).to(x.dtype)
    return y + x


def _check(x, w1, w2):
    """What P1 takes: contiguous bf16 x (M, K), w1 (K, N), w2 (N, K) on one
    device, K and N positive multiples of 8 (TMA's 16-byte row strides).
    Returns (M, K, N)."""
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
    if k % 8 or k == 0 or n % 8 or n == 0:
        raise ValueError(f"P1: K={k} and N={n} must be positive multiples "
                         "of 8")
    return m, k, n


@functools.lru_cache(maxsize=None)
def _p1_entry():
    fn = _build.load("fused_mlp").mico_fused_mlp
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_mlp(x: torch.Tensor, w1: torch.Tensor,
              w2: torch.Tensor) -> torch.Tensor:
    """P1: x (M, K), w1 (K, N), w2 (N, K) → (M, K). On the card contiguous
    bf16 with K and N multiples of 8; M is any. The hidden h (M, N) is a
    bf16 scratch tensor of the call. CPU tensors take the plain twin."""
    if not x.is_cuda:
        return fused_mlp_plain(x, w1, w2)
    m, k, n = _check(x, w1, w2)
    out = torch.empty_like(x)
    if m == 0:
        return out
    h = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = _p1_entry()(x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                     h.data_ptr(), out.data_ptr(), m, k, n,
                     torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_mlp: CUDA error {rc}")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
