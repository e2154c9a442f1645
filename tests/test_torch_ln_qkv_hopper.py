"""K1's and K3's Hopper design on the CPU: K1's LayerNorm-prologue GEMM
(`mico_tpu_torch/csrc/wgmma_gemm.cuh`, `ln_gemm_kernel`) and the attention
K1 and K3 share with K5 and K8 (`csrc/qkv_attn.cuh`), emulated in torch
against the JAX package's Pallas kernels in interpret mode; the wrappers'
widened checks.

K1's GEMM, as the kernel computes it: per row the fp32 mean and rstd of x
(two passes, `rsqrt(var + eps)`); x padded with zeros to an even number of
64-column k-steps (the TMA fill, and the zero step of an odd count); xn =
((x − mean)·rstd)·γ + β in fp32 with (γ, β) = (1, 0) without the affine
and (0, 0) past K, rounded to bf16; W padded with zero rows likewise; the
product accumulated in fp32 one 64-wide k-step after another; + bias in
fp32, one rounding to bf16. Then the attention of `emulate_qkv_attn`
(tests/test_torch_fused_qkv_hopper.py) on the qkv's column slices. K3 is
that attention alone, on column slices of a fused qkv or on three
tensors: the kernel's tensor maps address either layout, so the
emulation is the same.

Tolerance against the Pallas kernels and the plain twins: 2^-7 absolute and
relative, in bf16, for the reasons stated in test_torch_fused_qkv_hopper.py
(sums in another order can flip a bf16 rounding of xn or qkv; the card's
exp2 is approximate; the outputs are rounded to bf16)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mico_tpu.ops import flash_attention as jfa
from mico_tpu_torch.ops import flash_attention as tfa

from test_torch_fused_qkv_hopper import emulate_qkv_attn
from torch_port_common import close, t

BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
BK = 64
EPS = 1e-6


def emulate_ln_gemm(x, g, b0, w, bias, eps: float, affine: bool):
    """K1's GEMM stage on x (M, K) bf16, w (K, N) bf16, fp32 vectors."""
    m, k = x.shape
    nk = -(-k // BK)
    nk += nk % 2
    xf = F.pad(x.float(), (0, nk * BK - k))
    mean = xf[:, :k].mean(dim=-1, keepdim=True)
    var = (xf[:, :k] - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    gam = g.float() if affine else torch.ones(k)
    bet = b0.float() if affine else torch.zeros(k)
    gam, bet = F.pad(gam, (0, nk * BK - k)), F.pad(bet, (0, nk * BK - k))
    xn = (((xf - mean) * rstd) * gam + bet).bfloat16().float()
    wp = F.pad(w.float(), (0, 0, 0, nk * BK - k))
    acc = torch.zeros(m, w.shape[1])
    for kt in range(nk):
        cols = slice(kt * BK, (kt + 1) * BK)
        acc = acc + xn[:, cols] @ wp[cols]
    return (acc + bias.float()).bfloat16()


def emulate_k1(x, g, b0, w, bias, nh: int, scale: float, eps: float,
               affine: bool):
    b, l, wd = x.shape
    qkv = emulate_ln_gemm(x.flatten(0, 1), g, b0, w, bias, eps, affine)
    return emulate_qkv_attn(qkv.view(b, l, 3 * wd), nh, scale)


def _k1_inputs(rng, b, l, nh, d):
    w = nh * d
    f = np.float32
    return (rng.standard_normal((b, l, w)).astype(f) * 2 + 0.5,
            1 + 0.1 * rng.standard_normal(w).astype(f),
            0.1 * rng.standard_normal(w).astype(f),
            (rng.standard_normal((w, 3 * w)) * 0.05).astype(f),
            (rng.standard_normal(3 * w) * 0.05).astype(f))


# (B, L, H, D): ViT-g's head dim 88, the ragged W 80 (two heads of 40; one
# k-step past K pads to two), W 48 (an odd count of k-steps, padded with a
# zero step) and a row past one key block of 272
K1_CASES = [(2, 257, 2, 88), (2, 50, 2, 40), (2, 33, 2, 24), (1, 300, 2, 64)]
K1_IDS = ["257x2x88", "50x2x40", "33x2x24", "300x2x64"]


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "folded"])
@pytest.mark.parametrize("b,l,nh,d", K1_CASES, ids=K1_IDS)
def test_k1_emulation_matches_pallas(rng, b, l, nh, d, affine):
    x, g, b0, w, bias = _k1_inputs(rng, b, l, nh, d)
    scale = d ** -0.5
    tx, tw = t(x).bfloat16(), t(w).bfloat16()
    got = emulate_k1(tx, t(g), t(b0), tw, t(bias), nh, scale, EPS, affine)
    kernel = jfa._fused_ln_qkv_attn_fwd(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(g), jnp.asarray(b0),
        jnp.asarray(w, jnp.bfloat16), jnp.asarray(bias), nh, scale, EPS,
        affine, True)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    close(got.float(), np.asarray(kernel, np.float32), BF16_TOL)
    close(got.float(), tfa.fused_ln_qkv_plain(
        tx, t(g), t(b0), tw, t(bias), nh, scale, EPS, affine).float(),
        BF16_TOL)


# K3 at ViT-g's D 88, CLIP-L's D 64, the ragged W 80 and L 300 (two key
# blocks: the streamed path), on both layouts
K3_CASES = [(2, 257, 2, 88), (2, 50, 4, 64), (2, 50, 2, 40), (1, 300, 2, 88)]
K3_IDS = ["257x2x88", "50x4x64", "50x2x40", "300x2x88"]


@pytest.mark.parametrize("layout", ["slices", "three"])
@pytest.mark.parametrize("b,l,nh,d", K3_CASES, ids=K3_IDS)
def test_k3_emulation_matches_pallas(rng, b, l, nh, d, layout):
    """Column slices of the fused qkv against `_packed_qkv_fwd`, three
    contiguous tensors against `_packed_fwd`, both in interpret mode; the
    port's check takes each layout with its row stride (3W or W)."""
    w = nh * d
    qkv = rng.standard_normal((b, l, 3 * w)).astype(np.float32)
    scale = d ** -0.5
    tqkv = t(qkv).bfloat16()
    got = emulate_qkv_attn(tqkv, nh, scale)
    if layout == "slices":
        views = tqkv.chunk(3, dim=-1)
        kernel = jfa._packed_qkv_fwd(jnp.asarray(qkv, jnp.bfloat16), nh,
                                     scale, True)
    else:
        views = tuple(v.contiguous() for v in tqkv.chunk(3, dim=-1))
        kernel = jfa._packed_fwd(
            *(jnp.asarray(a, jnp.bfloat16) for a in np.split(qkv, 3, -1)),
            nh, scale, True)
    assert _check_k3(*views, nh) == (3 * w if layout == "slices" else w)
    close(got.float(), np.asarray(kernel, np.float32), BF16_TOL)
    close(got.float(), tfa.packed_attention_plain(*views, nh, scale).float(),
          BF16_TOL)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _check_k3(q, k, v, nh):
    return tfa._packed_layout("K3", (q, k, v), nh)


@pytest.mark.parametrize("b,l,nh,d", [(1, 600, 16, 88), (2, 9, 2, 40)],
                         ids=["L600-D88", "W80"])
def test_widened_checks_take(b, l, nh, d):
    """K1 and K3 take L 600 at D 88 (three key blocks) and W 80 (two heads
    of 40, not a multiple of 32)."""
    w = nh * d
    assert tfa._check_fused_qkv("K1", _bf16(b, l, w), _bf16(w, 3 * w),
                                torch.zeros(3 * w), nh) == (b, l, w, d)
    assert _check_k3(*_bf16(b, l, 3 * w).chunk(3, dim=-1), nh) == 3 * w


@pytest.mark.parametrize("what,kernel,args,match", [
    ("head dim 136", "K1", (_bf16(1, 9, 272), _bf16(272, 816),
                            torch.zeros(816), 2), "head dim"),
    ("head dim 60", "K1", (_bf16(1, 9, 240), _bf16(240, 720),
                           torch.zeros(720), 4), "head dim"),
    ("W 2176", "K1", (_bf16(1, 9, 2176), _bf16(2176, 6528),
                      torch.zeros(6528), 17), "W <= 2048"),
    ("fp32 x", "K1", (torch.zeros(1, 9, 256), _bf16(256, 768),
                      torch.zeros(768), 4), "bf16"),
    ("head dim 136", "K3", (*_bf16(1, 9, 816).chunk(3, dim=-1), 2),
     "head dim"),
    ("fp32", "K3", (*torch.zeros(1, 9, 768).chunk(3, dim=-1), 4), "bf16"),
    ("row stride 3W + 4", "K3",
     (*_bf16(1, 9, 772)[..., :768].chunk(3, dim=-1), 4), "row stride"),
])
def test_remaining_refusals(what, kernel, args, match):
    """What K1 and K3 still refuse before a launch on the card."""
    with pytest.raises(ValueError, match=match):
        if kernel == "K1":
            tfa._check_fused_qkv("K1", *args)
        else:
            _check_k3(*args)


@pytest.mark.parametrize("l,d", [(257, 88), (600, 88)],
                         ids=["L257-D88", "L600-D88"])
def test_k4_fit_check(l, d):
    """K3 and K4 both take any L: K4's check (`_check_k4`, which its
    wrapper runs) takes the train pass's L 257 and L 600 at D 88 (three key
    blocks, streamed by the rows launch), on the fused qkv's column slices
    and into one dqkv."""
    nh = 16
    w = nh * d
    q, k, v = _bf16(2, l, 3 * w).chunk(3, dim=-1)
    assert tfa._check_k4(q, k, v, _bf16(2, l, w), nh,
                         _bf16(2, l, 3 * w)) == 3 * w
