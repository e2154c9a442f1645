"""K5's and K8's Hopper design (`mico_tpu_torch/csrc/qkv_attn.cuh`,
`csrc/wgmma_gemm.cuh`; K1 and K3 run the same attention) on the CPU: the
attention's shared-memory formula and the wrappers' checks, and the attention's algorithm emulated in torch
against the JAX package's Pallas kernels in interpret mode.

The emulation follows the kernel: q in tiles of 64 rows; K and V padded
with zeros past L to whole key blocks of 272 keys and past D to 64-column
chunks (what the tensor maps' out-of-bounds fill gives); scores in fp32 over
every padded column, times scale·log2(e) after the product, keys past L set
to -1e30; the exact row maximum over all blocks (one block holds the whole
row at L ≤ 272; past that the blocks stream, a first pass takes the
maximum and a second recomputes the scores); p = exp2(s − m) in fp32, the row sum over fp32 p,
bf16 p for the PV product accumulated block by block in fp32; o / l as the
kernel divides, a reciprocal product with one FMA correction; one rounding
to bf16. The rounding points are `_fused_qkv_attn_kernel`'s; the design
moves none of them.

Tolerance against the Pallas kernels and their plain twins: 2^-7 absolute
and relative, in bf16 (the kernel's only dtype): the qkv projection's fp32
sums run in another order in torch than in XLA, which can flip a bf16
rounding of qkv, and the card's exp2 is the approximate ex2; the outputs
are rounded to bf16 (an ulp of 2^-8 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mico_tpu.ops import flash_attention as jfa
from mico_tpu_torch.ops import flash_attention as tfa

from torch_port_common import close, no_launch, t

BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
NEG_BIG = -1e30
QROWS = 64
KEYS = tfa._QKV_ATTN_KEYS


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# (a) shared memory and the wrappers' checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,want", [(112, 205888), (88, 205888),
                                    (128, 205888), (64, 103488), (8, 103488)])
def test_smem_formula(d, want):
    """`_qkv_attn_smem_bytes` mirrors `qattn::smem_bytes`: one key block of
    272 keys of K and of V in 64-column chunks, two Q and two output tiles
    of 64 rows, eight mbarriers and 1 KB of alignment, at any L; within a
    block's 227 KB at every head dim the wrappers take."""
    nt = -(-d // 64)
    assert tfa._qkv_attn_smem_bytes(d) == want == (
        2 * nt * KEYS * 128 + 4 * nt * 64 * 128 + 64 + 1024)
    assert want <= tfa._MAX_SMEM


@pytest.mark.parametrize("name", ["K5", "K8"])
@pytest.mark.parametrize("b,l,nh,d", [
    (112, 257, 16, 112), (8, 257, 16, 88), (3, 50, 4, 64), (1, 273, 2, 128),
    (1, 484, 16, 112), (1, 2000, 2, 128)])
def test_checks_accept_main_path_shapes(name, b, l, nh, d):
    """bigE's pass, ViT-g's 16 x 88 and the ragged (3, 50, 4 x 64) pass K5's
    and K8's checks, and so do rows past one key block (273 keys; 484 at D
    112, the most the old packed attention held; 2000, which it refused):
    the attention streams their key blocks."""
    w = nh * d
    assert tfa._check_fused_qkv(name, _bf16(b, l, w), _bf16(w, 3 * w),
                                torch.zeros(3 * w), nh) == (b, l, w, d)


@pytest.mark.parametrize("name", ["K5", "K8"])
@pytest.mark.parametrize("what,args,match", [
    ("head dim 136", (_bf16(1, 9, 272), _bf16(272, 816), torch.zeros(816),
                      2), "head dim"),
    ("head dim 60", (_bf16(1, 9, 240), _bf16(240, 720), torch.zeros(720),
                     4), "head dim"),
    ("fp32 x", (torch.zeros(1, 9, 256), _bf16(256, 768), torch.zeros(768),
                4), "bf16"),
    # W 80 (two heads of 40) is taken: the GEMM needs W % 8, which D % 8
    # gives
    pytest.param("W % 32", (_bf16(1, 9, 80), _bf16(80, 240),
                            torch.zeros(240), 2), None,
                 id="W % 32-args3-W % 32"),
])
def test_checks_refuse(name, what, args, match):
    """What K5 and K8 refuse before a launch on the card: a head dim past
    128 or not a multiple of 8, fp32 inputs; a width that is a multiple of
    8 but not of 32 they take (match None)."""
    if match is None:
        assert tfa._check_fused_qkv(name, *args) == (1, 9, 80, 40)
        return
    with pytest.raises(ValueError, match=match):
        tfa._check_fused_qkv(name, *args)


def test_k1_check_keeps_its_formula():
    """K1, K3 and K5 share one shared-memory formula, the attention's
    `_qkv_attn_smem_bytes` (one key block of K and V at any L), which fits
    a block at the largest head dim the checks take: L 2000 at D 128
    passes all three checks."""
    assert tfa._qkv_attn_smem_bytes(128) <= tfa._MAX_SMEM
    x, w, bias = _bf16(1, 2000, 256), _bf16(256, 768), torch.zeros(768)
    q, k, v = _bf16(1, 2000, 768).chunk(3, dim=-1)
    for name in ("K1", "K5"):
        assert tfa._check_fused_qkv(name, x, w, bias, 2) == (1, 2000, 256, 128)
    assert tfa._packed_layout("K3", (q, k, v), 2) == 768


@pytest.mark.parametrize("what,args,match", [
    ("K % 8", (_bf16(4, 12), _bf16(12, 16), torch.zeros(16)), "K 12"),
    ("N % 8", (_bf16(4, 16), _bf16(16, 12), torch.zeros(12)), "N 12"),
    ("chain", (_bf16(4, 16), _bf16(8, 16), torch.zeros(16)), "chain"),
    ("fp32 a", (torch.zeros(4, 16), _bf16(16, 16), torch.zeros(16)), "bf16"),
])
def test_gemm_checks_refuse(what, args, match):
    """What the GEMM stage alone refuses before a launch on the card."""
    with pytest.raises(ValueError, match=match):
        tfa._check_gemm(*args)


def test_gemm_stage_on_cpu_is_its_plain_product(rng):
    """On CPU tensors `bf16_gemm_bias` is its plain twin (a·w + bias in
    fp32, rounded once) and launches nothing; the twin matches fp64 rounded
    once to bf16 within 2^-7 relative (fp32 and fp64 sums can round to
    neighbouring bf16 values, an ulp of 2^-8 either way)."""
    a = t(rng.standard_normal((150, 256)).astype(np.float32)).bfloat16()
    w = t((rng.standard_normal((256, 768)) * 0.02).astype(np.float32))
    w = w.bfloat16()
    bias = t((rng.standard_normal(768) * 0.02).astype(np.float32))
    got = no_launch(lambda: tfa.bf16_gemm_bias(a, w, bias))
    assert got.dtype == torch.bfloat16 and got.shape == (150, 768)
    torch.testing.assert_close(got, tfa.bf16_gemm_plain(a, w, bias),
                               rtol=0, atol=0)
    want = (a.double() @ w.double() + bias.double()).bfloat16()
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# (b) the attention's algorithm, emulated, against the Pallas kernels
# ---------------------------------------------------------------------------


def _div_by(o: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """o / l as the kernel takes it: q = o·r with r = 1/l, then q + r·(o −
    q·l), both steps fused multiply-adds (exact residual in fp64)."""
    r = 1.0 / l
    q = o * r
    e = (o.double() - q.double() * l.double()).float()
    return (e.double() * r.double() + q.double()).float()


def emulate_qkv_attn(qkv: torch.Tensor, nh: int, scale: float):
    """csrc/qkv_attn.cuh's attention on a (B, L, 3W) qkv, in torch."""
    b, l, w3 = qkv.shape
    w = w3 // 3
    d = w // nh
    dp = 64 * -(-d // 64)
    nkb = -(-l // KEYS)
    nqt = -(-l // QROWS)
    heads = qkv.float().view(b, l, 3, nh, d).permute(2, 0, 3, 1, 4)

    def pad(x, rows):
        return F.pad(x, (0, dp - d, 0, rows - l))

    q = pad(heads[0], nqt * QROWS)
    k, v = pad(heads[1], nkb * KEYS), pad(heads[2], nkb * KEYS)
    qk_scale = torch.tensor(scale * tfa.LOG2E, dtype=torch.float32)
    valid = torch.arange(nkb * KEYS) < l
    out = torch.empty(b, nh, nqt * QROWS, dp)
    for qt in range(nqt):
        qs = q[:, :, qt * QROWS:(qt + 1) * QROWS]
        blocks = []
        for kb in range(nkb):
            keys = slice(kb * KEYS, (kb + 1) * KEYS)
            s = (qs @ k[:, :, keys].transpose(-1, -2)) * qk_scale
            blocks.append(torch.where(valid[keys], s, NEG_BIG))
        m = torch.stack([s.amax(-1) for s in blocks]).amax(0)[..., None]
        lsum = torch.zeros(b, nh, QROWS, 1)
        o = torch.zeros(b, nh, QROWS, dp)
        for kb, s in enumerate(blocks):
            p = torch.exp2(s - m)
            lsum = lsum + p.sum(-1, keepdim=True)
            o = o + p.bfloat16().float() @ v[:, :, kb * KEYS:(kb + 1) * KEYS]
        out[:, :, qt * QROWS:(qt + 1) * QROWS] = _div_by(o, lsum)
    out = out[:, :, :l, :d].to(qkv.dtype)
    return out.transpose(1, 2).reshape(b, l, w)


def _inputs(rng, b, l, nh, d):
    w = nh * d
    x = rng.standard_normal((b, l, w)).astype(np.float32)
    wq = (rng.standard_normal((w, 3 * w)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(3 * w) * 0.05).astype(np.float32)
    wp = (rng.standard_normal((w, w)) * 0.05).astype(np.float32)
    bp = (rng.standard_normal(w) * 0.05).astype(np.float32)
    return x, wq, bias, wp, bp


def _projection(x, wq, bias):
    """The GEMM stage's output, as the kernel and the Pallas body round it:
    x·W + bias in fp32, rounded once to bf16."""
    return tfa.bf16_gemm_plain(t(x).bfloat16().flatten(0, 1),
                               t(wq).bfloat16(), t(bias)).view(
        x.shape[0], x.shape[1], -1)


# (B, L, H, D): D in {64, 88, 112} at L in {50, 257}, and rows of two and
# three key blocks (L 500 at D 64, L 600 at D 112: the streamed two-pass
# path)
CASES = [(2, l, 2, d) for d in (64, 88, 112) for l in (50, 257)]
CASES += [(1, 500, 2, 64), (1, 600, 2, 112)]
IDS = [f"L{c[1]}-D{c[3]}" for c in CASES]


@pytest.mark.parametrize("b,l,nh,d", CASES, ids=IDS)
def test_emulation_matches_pallas_k5(rng, b, l, nh, d):
    x, wq, bias, _, _ = _inputs(rng, b, l, nh, d)
    scale = d ** -0.5
    got = emulate_qkv_attn(_projection(x, wq, bias), nh, scale)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, wq)]
    jargs.append(jnp.asarray(bias))
    kernel = jfa._fused_qkv_attn_fwd(*jargs, nh, scale, True)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    close(got.float(), np.asarray(kernel, np.float32), BF16_TOL)
    close(got.float(), tfa.fused_qkv_plain(
        t(x).bfloat16(), t(wq).bfloat16(), t(bias), nh, scale).float(),
        BF16_TOL)


@pytest.mark.parametrize("b,l,nh,d", CASES[1::2], ids=IDS[1::2])
def test_emulation_matches_pallas_k8(rng, b, l, nh, d):
    """K8: the emulated attention, then the GEMM stage's out-projection
    (o·Wp + bp in fp32, rounded once), against `_fused_qkv_attn_proj_fwd`
    in interpret mode."""
    x, wq, bias, wp, bp = _inputs(rng, b, l, nh, d)
    scale = d ** -0.5
    o = emulate_qkv_attn(_projection(x, wq, bias), nh, scale)
    got = tfa.bf16_gemm_plain(o.flatten(0, 1), t(wp).bfloat16(),
                              t(bp)).view_as(o)
    jargs = [jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq, jnp.bfloat16),
             jnp.asarray(bias), jnp.asarray(wp, jnp.bfloat16),
             jnp.asarray(bp)]
    kernel = jfa._fused_qkv_attn_proj_fwd(*jargs, nh, scale, True)
    close(got.float(), np.asarray(kernel, np.float32), BF16_TOL)


def test_division_is_the_quotient():
    """The kernel's o / l (a reciprocal product and one FMA correction)
    against fp64 division over row sums from 1 to 300 and |o| up to 30:
    within one fp32 ulp, so the same bf16 but at a rounding tie."""
    gen = torch.Generator().manual_seed(0)
    lsum = 1 + 299 * torch.rand(4096, 1, generator=gen)
    o = 30 * torch.randn(4096, 64, generator=gen)
    got = _div_by(o, lsum)
    want = (o.double() / lsum.double()).float()
    ulp = torch.finfo(torch.float32).eps * want.abs()
    assert ((got - want).abs() <= ulp).all()
    agree = (got.bfloat16() == want.bfloat16()).float().mean().item()
    assert agree > 0.999
