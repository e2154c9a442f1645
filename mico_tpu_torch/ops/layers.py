"""Elementary layers with the numerics of `mico_tpu/ops/layers.py`.

- `linear`: fp32 accumulation, the bias added in fp32, one rounding to the
  input dtype. On the card a bf16 product goes to cuBLAS with its bias
  epilogue (fp32 accumulate + bias, one rounding); elsewhere the product is
  taken in fp32 and rounded once.
- `layer_norm`: fp32 statistics, biased variance, output in the input dtype,
  optional affine.
- `gelu`: exact erf for fp32, the tanh approximation for bf16.

TF32 is switched off at import: a float32 product or convolution on the card
stays float32, as the JAX package's HIGHEST precision does. bf16 products
keep fp32 reductions (no reduced-precision split-K).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU for fp32; tanh approximation for bf16 (its max error
    vs erf, 4.7e-4, is far below bf16 rounding at the same magnitudes)."""
    approx = "tanh" if x.dtype == torch.bfloat16 else "none"
    return F.gelu(x, approximate=approx)


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float,
) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics (biased variance);
    output in the input dtype. weight/bias may be None (folded layout)."""
    n = x.shape[-1]
    if x.dtype == torch.float32 or x.is_cuda:
        # the card's kernel keeps statistics and affine in fp32 and rounds
        # once; its affine takes weights in the input dtype
        return F.layer_norm(
            x, (n,),
            None if weight is None else weight.to(x.dtype),
            None if bias is None else bias.to(x.dtype),
            eps,
        )
    # reduced precision on the CPU: fp32 statistics and affine, one rounding
    y = F.layer_norm(
        x.float(), (n,),
        None if weight is None else weight.float(),
        None if bias is None else bias.float(),
        eps,
    )
    return y.to(x.dtype)


def linear(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x @ W (+ b) with W stored (in_features, out_features)."""
    w = weight.to(x.dtype)
    if x.is_cuda and x.dtype != torch.float32:
        x2 = x.reshape(-1, x.shape[-1])
        if bias is None:
            y = torch.mm(x2, w)
        else:
            y = torch.addmm(bias.to(x.dtype), x2, w)
        return y.reshape(*x.shape[:-1], w.shape[1])
    y = torch.matmul(x.float(), w.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
