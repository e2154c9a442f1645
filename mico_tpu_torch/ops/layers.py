"""Elementary layers with the numerics of `mico_tpu/ops/layers.py`.

- `linear`: fp32 accumulation, the bias added in fp32, one rounding to the
  input dtype. On the card a bf16 product goes to cuBLAS with its bias
  epilogue (fp32 accumulate + bias, one rounding); elsewhere the product is
  taken in fp32 and rounded once.
- `matmul_f32`: a product with an fp32 result from operands in the compute
  dtype (JAX's preferred_element_type=float32), differentiable: the
  decoder's attention scores and the projections of K1/K5/K8's
  differentiated routes.
- `layer_norm`: fp32 statistics, biased variance, output in the input dtype,
  optional affine. `LN_STATS_DTYPE` (JAX `layers.py:22`, a perf_lab knob)
  set to bf16 computes the statistics and the affine in bf16 instead.
- `gelu`: exact erf for fp32, the tanh approximation for bf16.
- `dropout`: inverted dropout with torch semantics, drawn on the tensor's
  device from an explicit `torch.Generator`. A training step holds one CPU
  generator as its seed source; `fork_generator` / `draw_seeds` give the
  device generators and the per-layer seeds its stochastic parts draw from
  (the port's stand-in for `jax.random.split`: its numbers are not JAX's).

TF32 is switched off at import: a float32 product or convolution on the card
stays float32, as the JAX package's HIGHEST precision does. bf16 products
keep fp32 reductions (no reduced-precision split-K).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False

# dtype of LayerNorm's statistics and affine (`mico_tpu/ops/layers.py:22`):
# fp32 is the default; bf16 is `scripts/torch_perf_lab.py`'s ln_bf16 variant
LN_STATS_DTYPE = torch.float32


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
    output in the input dtype. weight/bias may be None (folded layout).
    With `LN_STATS_DTYPE` other than fp32, JAX's formula in that dtype
    (`layers.py:63-68`): every step rounded to it, the means accumulated in
    fp32 as `jnp.mean` does."""
    if LN_STATS_DTYPE != torch.float32:
        xs = x.to(LN_STATS_DTYPE)
        mean = xs.mean(dim=-1, keepdim=True)
        var = (xs - mean).square().mean(dim=-1, keepdim=True)
        y = (xs - mean) * torch.rsqrt(var + eps)
        if weight is not None:
            y = y * weight.to(LN_STATS_DTYPE) + bias.to(LN_STATS_DTYPE)
        return y.to(x.dtype)
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


def records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd records a call on these inputs: grad mode is on
    and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _mm_out_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (…, M, K) · b (…, K, N) in their reduced dtype on the card with
    an fp32 output: `mm`, or `bmm` over the leading dims (b keeps its
    layout: a transposed K stays a transposed operand)."""
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    *batch, m, k = a.shape
    n = b.shape[-1]
    bt = b.transpose(-1, -2).reshape(-1, n, k).transpose(1, 2)
    return torch.bmm(a.reshape(-1, m, k), bt,
                     out_dtype=torch.float32).view(*batch, m, n)


class _MatmulF32(torch.autograd.Function):
    """`_mm_out_f32` with a derivative (the product with an fp32 output has
    none of its own). It saves the operands as they are, not fp32 copies
    (the decoder's scores would otherwise keep one of every step's cross
    K). The backward takes the fp32 cotangent against the operands in fp32
    and rounds to their dtypes, as JAX's transpose of a dot with
    preferred_element_type=float32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_out_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (…, M, K) · b (…, K, N) with fp32 accumulation and an fp32
    result, as JAX's preferred_element_type=float32: on the card a product
    in a's reduced dtype with an fp32 output (b cast to it), elsewhere
    fp32 operands. Differentiable; a call autograd does not record (the
    no-grad decode, host-bound) takes the product without `_MatmulF32`."""
    if not a.is_cuda or a.dtype == torch.float32:
        return torch.matmul(a.float(), b.float())
    b = b.to(a.dtype)
    if records_grad(a, b):
        return _MatmulF32.apply(a, b)
    return _mm_out_f32(a, b)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout (`mico_tpu/ops/layers.py:75-82`): each element kept
    with probability 1 - rate and scaled by 1 / keep (keep rounded to x's
    dtype first, as JAX divides by it in x's dtype), the rest zeroed.
    Identity when the generator is None or the rate is 0. The mask is drawn
    on x's device, so the generator must live there. `heads` = (first,
    all): x (B, h, ...) holds heads first.. of `all`; the mask is drawn for
    all of them and cut to x's."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = x.shape if heads is None else (x.shape[0], heads[1],
                                           *x.shape[2:])
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if heads is not None:
        mask = mask[:, heads[0]:heads[0] + x.shape[1]]
    keep_x = torch.tensor(keep, dtype=x.dtype).item()
    return torch.where(mask, x / keep_x, 0.0)


def draw_seeds(generator: torch.Generator, n: int) -> List[int]:
    """n seeds drawn from a CPU generator (no device work, no sync)."""
    if generator.device.type != "cpu":
        raise ValueError(
            "a training step's generator is a CPU torch.Generator (its seed "
            f"source); got one on {generator.device}")
    return torch.randint(0, 2 ** 62, (n,), generator=generator).tolist()


def fork_generator(generator: Optional[torch.Generator],
                   device) -> Optional[torch.Generator]:
    """A new generator on `device`, seeded by one draw of the CPU
    `generator`; None for None (evaluation)."""
    if generator is None:
        return None
    return seeded_generator(draw_seeds(generator, 1)[0], device)


def seeded_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def split_generator(generator: Optional[torch.Generator],
                    n: int) -> List[Optional[torch.Generator]]:
    """n CPU generators seeded from `generator` (the port's stand-in for
    `jax.random.split`); n Nones for None."""
    if generator is None:
        return [None] * n
    return [seeded_generator(s, "cpu") for s in draw_seeds(generator, n)]
