"""K9's and K4's Hopper design on the CPU: K9 (`cls_attn_kernel` of
`mico_tpu_torch/csrc/qkv_attn.cuh`) and K4 (`csrc/packed_attn_bwd.cu`)
emulated in torch against the JAX package's Pallas kernels in interpret
mode, and the wrappers' checks, which take any L.

K9, as the kernel computes it: the patch rows run K3's attention (tiles of
64 query rows, K and V padded with zeros past P = L − 1 to key blocks of
272 and past D to 64-column chunks, keys past P at −1e30, the exact row
maximum over all blocks) with `_packed_qkv_cls_kernel`'s rounding points:
scores times scale after the product and a natural exp; each patch row's
CLS column s_pc (an fp32 sum over D of the bf16 products: the kernel takes
it on the tensor cores with k_cls in the key block's tail at P ≤ 256, on
CUDA cores past that; only the order of the sum differs) joins the maximum
and the sum; bf16 p_pp for the PV product, accumulated block by block in
fp32; p_pc·v_cls added in fp32; o / l as the kernel divides (a reciprocal
product and one FMA correction); one rounding. The CLS row in fp32 with
the unrounded p, its weighted sum of v_p taken in chunks of 96 keys, then
a true division.

K4, as the kernel computes it. The rows launch, per tile of 64 query rows:
s = q kᵀ times scale·log2(e) over key blocks of 272 (keys past L at
−1e30), the exact maximum, e = exp2(s − m), l = Σ e, p = e / l as the
kernel divides; δ = Σ dp·p over the fp32 p, dp = g vᵀ taken in chunks of
64 keys (and the 16-key tail); then chunk by chunk s and dp again, ds =
bf16(p (dp − δ) scale) and dq += ds k in fp32, one rounding at the end.
The columns launch, per tile of 64 keys: for each tile of 64 queries sᵀ
and dpᵀ, p from the rows' (m, l, δ), ds likewise, zero where a query or
key lies past L; dv += bf16(p)ᵀ g and dk += dsᵀ q in fp32, one rounding.
These are `_packed_bwd_body`'s rounding points; the design moves none.
(Where L % 64 == 1 the kernel takes the last query row off the tensor
cores, in fp32 with the same rounding points: only the order of its sums
differs, so the emulation keeps it in its tile.)

Tolerance against the Pallas kernels and the plain twins: 2^-7 absolute and
relative, in bf16, as for K3 (test_torch_fused_qkv_hopper.py): sums run in
another order, which can flip a bf16 rounding of p or ds, and the outputs
are rounded to bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mico_tpu.ops import flash_attention as jfa
from mico_tpu_torch.ops import flash_attention as tfa

from test_torch_fused_qkv_hopper import _div_by
from torch_port_common import close, t

BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
NEG_BIG = -1e30
QROWS = 64
KEYS = tfa._QKV_ATTN_KEYS
CHUNK = 64                      # keys of a dp chunk (K4's rows launch)
CLS_CHUNK = tfa._CLS_THREADS    # keys of a CLS-row chunk (K9)


def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    """(B, L, H·D) → (B, H, L, D) fp32."""
    b, l, w = x.shape
    return x.float().view(b, l, nh, w // nh).transpose(1, 2)


def _pad(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zeros past the rows and past D to 64-column chunks (the tensor maps'
    fill)."""
    d = x.shape[-1]
    return F.pad(x, (0, 64 * -(-d // 64) - d, 0, rows - x.shape[-2]))


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------


def emulate_k9(qkv: torch.Tensor, nh: int, scale: float) -> torch.Tensor:
    """K9 on a fused (B, L, 3W) qkv, in torch."""
    b, l, w3 = qkv.shape
    w = w3 // 3
    d = w // nh
    p_rows = l - 1
    q, k, v = (_heads(x, nh) for x in qkv.split(w, dim=-1))
    qc, kc, vc = q[:, :, :1], k[:, :, :1], v[:, :, :1]
    nkb, nqt = -(-p_rows // KEYS), -(-p_rows // QROWS)
    qp = _pad(q[:, :, 1:], nqt * QROWS)
    kp, vp = _pad(k[:, :, 1:], nkb * KEYS), _pad(v[:, :, 1:], nkb * KEYS)
    kcp, vcp = _pad(kc, 1), _pad(vc, 1)
    sc = torch.tensor(scale, dtype=torch.float32)
    valid = torch.arange(nkb * KEYS) < p_rows
    out = torch.empty(b, nh, nqt * QROWS, kp.shape[-1])
    for qt in range(nqt):
        qs = qp[:, :, qt * QROWS:(qt + 1) * QROWS]
        s_pc = (qs * kcp).sum(-1, keepdim=True) * sc
        blocks = []
        for kb in range(nkb):
            keys = slice(kb * KEYS, (kb + 1) * KEYS)
            s = (qs @ kp[:, :, keys].transpose(-1, -2)) * sc
            blocks.append(torch.where(valid[keys], s, NEG_BIG))
        m = torch.stack([s.amax(-1) for s in blocks]).amax(0)[..., None]
        m = torch.maximum(m, s_pc)
        lsum = torch.zeros(b, nh, QROWS, 1)
        o = torch.zeros_like(qs)
        for kb, s in enumerate(blocks):
            p = torch.exp(s - m)
            lsum = lsum + p.sum(-1, keepdim=True)
            o = o + p.bfloat16().float() @ vp[:, :, kb * KEYS:(kb + 1) * KEYS]
        p_pc = torch.exp(s_pc - m)
        out[:, :, qt * QROWS:(qt + 1) * QROWS] = _div_by(o + p_pc * vcp,
                                                         lsum + p_pc)
    patches = out[:, :, :p_rows, :d]
    # the CLS row: fp32, unrounded p, the weighted sum in chunks of keys
    s_cp = (k[:, :, 1:] * qc).sum(-1) * sc                   # (B, H, P)
    s_cc = (qc * kc).sum(-1) * sc                            # (B, H, 1)
    m_c = torch.maximum(s_cp.amax(-1, keepdim=True), s_cc)
    p_cp = torch.exp(s_cp - m_c)
    o_c = torch.zeros(b, nh, d)
    for c0 in range(0, p_rows, CLS_CHUNK):
        rows = slice(c0, c0 + CLS_CHUNK)
        o_c = o_c + (p_cp[..., rows, None] * v[:, :, 1:][:, :, rows]).sum(-2)
    p_cc = torch.exp(s_cc - m_c)
    l_c = p_cp.sum(-1, keepdim=True) + p_cc
    cls = ((o_c + p_cc * vc[:, :, 0]) / l_c)[:, :, None]
    full = torch.cat([cls, patches], dim=2).to(qkv.dtype)
    return full.transpose(1, 2).reshape(b, l, w)


def _pallas_cls(monkeypatch, qkv: np.ndarray, nh: int,
                scale: float) -> np.ndarray:
    """`_packed_qkv_fwd` in interpret mode with `PACKED_CLS_SPLIT` on (it
    reads the flag at trace time: the jit cache is cleared before and
    after)."""
    monkeypatch.setattr(jfa, "PACKED_CLS_SPLIT", True)
    jfa._packed_qkv_fwd.clear_cache()
    try:
        out = jfa._packed_qkv_fwd(jnp.asarray(qkv, jnp.bfloat16), nh, scale,
                                  True)
        return np.asarray(out, np.float32)
    finally:
        monkeypatch.undo()
        jfa._packed_qkv_fwd.clear_cache()


# (B, L, H, D): ViT-g's D 88 and CLIP-L's D 64 at 257 tokens (256 patch
# rows: four tiles, one key block), 385 tokens (the patch keys stream: two
# key blocks) and 513 at D 88
K9_CASES = [(2, 257, 2, 88), (1, 257, 4, 64), (1, 385, 2, 32), (1, 513, 2, 88)]
K9_IDS = ["257x2x88", "257x4x64", "385x2x32", "513x2x88"]


@pytest.mark.parametrize("b,l,nh,d", K9_CASES, ids=K9_IDS)
def test_k9_emulation_matches_pallas(rng, monkeypatch, b, l, nh, d):
    qkv = rng.standard_normal((b, l, 3 * nh * d)).astype(np.float32)
    scale = d ** -0.5
    tqkv = t(qkv).bfloat16()
    got = emulate_k9(tqkv, nh, scale)
    assert got.shape == (b, l, nh * d) and got.dtype == torch.bfloat16
    close(got.float(), _pallas_cls(monkeypatch, qkv, nh, scale), BF16_TOL)
    close(got.float(),
          tfa.packed_qkv_cls_attention_plain(tqkv, nh, scale).float(),
          BF16_TOL)


@pytest.mark.parametrize("l", [2, 50, 300], ids=["L2", "L50", "L300"])
def test_k9_emulation_at_any_length(rng, l):
    """K9 takes any L ≥ 2 (the routing sends it only 128k + 1): the
    emulation against the plain twin where JAX has no CLS-split kernel."""
    qkv = rng.standard_normal((2, l, 3 * 2 * 64)).astype(np.float32)
    tqkv = t(qkv).bfloat16()
    close(emulate_k9(tqkv, 2, 0.125).float(),
          tfa.packed_qkv_cls_attention_plain(tqkv, 2, 0.125).float(),
          BF16_TOL)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


def _k4_rows(qh, kh, vh, gh, l, scale):
    """The rows launch: per-row (m, l, δ) and dq, (B, H, L...) fp32."""
    b, nh, _, d = qh.shape
    nkb, nqt = -(-l // KEYS), -(-l // QROWS)
    q, g = _pad(qh, nqt * QROWS), _pad(gh, nqt * QROWS)
    k, v = _pad(kh, nkb * KEYS), _pad(vh, nkb * KEYS)
    qk2 = torch.tensor(scale * tfa.LOG2E, dtype=torch.float32)
    sc = torch.tensor(scale, dtype=torch.float32)
    key = torch.arange(nkb * KEYS)
    stats = torch.empty(b, nh, nqt * QROWS, 3)
    dq = torch.empty(b, nh, nqt * QROWS, q.shape[-1])
    for qt in range(nqt):
        rows = slice(qt * QROWS, (qt + 1) * QROWS)
        qs, gs = q[:, :, rows], g[:, :, rows]
        s = torch.where(key < l, (qs @ k.transpose(-1, -2)) * qk2, NEG_BIG)
        m = s.amax(-1, keepdim=True)
        e = torch.exp2(s - m)
        lsum = e.sum(-1, keepdim=True)
        p = _div_by(e, lsum)
        delta = torch.zeros(b, nh, QROWS, 1)
        for c0 in range(0, nkb * KEYS, CHUNK):
            keys = slice(c0, c0 + CHUNK)
            dp = gs @ v[:, :, keys].transpose(-1, -2)
            delta = delta + (dp * p[..., keys]).sum(-1, keepdim=True)
        acc = torch.zeros_like(qs)
        for c0 in range(0, nkb * KEYS, CHUNK):
            keys = slice(c0, c0 + CHUNK)
            s_c = torch.where(key[keys] < l,
                              (qs @ k[:, :, keys].transpose(-1, -2)) * qk2,
                              NEG_BIG)
            p_c = _div_by(torch.exp2(s_c - m), lsum)
            dp_c = gs @ v[:, :, keys].transpose(-1, -2)
            ds = (p_c * (dp_c - delta) * sc).bfloat16().float()
            acc = acc + ds @ k[:, :, keys]
        stats[:, :, rows] = torch.cat([m, lsum, delta], dim=-1)
        dq[:, :, rows] = acc
    return stats, dq


def _k4_cols(qh, kh, vh, gh, l, scale, stats):
    """The columns launch: dk, dv of each 64-key tile over all query tiles,
    p and ds from the rows' statistics."""
    nt = -(-l // QROWS)
    q, k, v, g = (_pad(x, nt * QROWS) for x in (qh, kh, vh, gh))
    qk2 = torch.tensor(scale * tfa.LOG2E, dtype=torch.float32)
    sc = torch.tensor(scale, dtype=torch.float32)
    idx = torch.arange(nt * QROWS)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for kt in range(nt):
        keys = slice(kt * QROWS, (kt + 1) * QROWS)
        kk, vv = k[:, :, keys], v[:, :, keys]
        adk, adv = torch.zeros_like(kk), torch.zeros_like(vv)
        for qt in range(nt):
            rows = slice(qt * QROWS, (qt + 1) * QROWS)
            m, lsum, delta = (stats[:, :, rows, i][..., None, :]
                              for i in range(3))
            ok = (idx[keys, None] < l) & (idx[None, rows] < l)
            s_t = (kk @ q[:, :, rows].transpose(-1, -2)) * qk2
            p = torch.where(ok, _div_by(torch.exp2(s_t - m), lsum), 0.0)
            dp_t = vv @ g[:, :, rows].transpose(-1, -2)
            ds = torch.where(ok, p * (dp_t - delta) * sc, 0.0)
            adv = adv + p.bfloat16().float() @ g[:, :, rows]
            adk = adk + ds.bfloat16().float() @ q[:, :, rows]
        dk[:, :, keys], dv[:, :, keys] = adk, adv
    return dk, dv


def emulate_k4(q, k, v, g, nh: int, scale: float):
    """K4 on (B, L, W) q, k, v and g, in torch → (dq, dk, dv) bf16."""
    b, l, w = q.shape
    d = w // nh
    qh, kh, vh, gh = (_heads(x, nh) for x in (q, k, v, g))
    stats, dq = _k4_rows(qh, kh, vh, gh, l, scale)
    dk, dv = _k4_cols(qh, kh, vh, gh, l, scale, stats)
    return tuple(x[:, :, :l, :d].to(q.dtype).transpose(1, 2).reshape(b, l, w)
                 for x in (dq, dk, dv))


# (B, L, H, D): the train pass's L 257 at ViT-g's D 88, the gate's ragged
# (50, 4 x 64), L 300 past one key block (the rows launch streams) and L
# 129 (a lone key in the columns' third tile)
K4_CASES = [(2, 257, 2, 88), (3, 50, 4, 64), (1, 300, 2, 88), (1, 129, 2, 64)]
K4_IDS = ["257x2x88", "50x4x64", "300x2x88", "129x2x64"]


@pytest.mark.parametrize("layout", ["slices", "three"])
@pytest.mark.parametrize("b,l,nh,d", K4_CASES, ids=K4_IDS)
def test_k4_emulation_matches_pallas(rng, b, l, nh, d, layout):
    """Column slices of the fused qkv against `_packed_qkv_bwd`, three
    contiguous tensors against `_packed_bwd`, both in interpret mode, and
    both against the plain twin; the port's check takes each layout."""
    w = nh * d
    qkv = rng.standard_normal((b, l, 3 * w)).astype(np.float32)
    g = rng.standard_normal((b, l, w)).astype(np.float32)
    scale = d ** -0.5
    tqkv, tg = t(qkv).bfloat16(), t(g).bfloat16()
    views = tqkv.chunk(3, dim=-1)
    if layout == "slices":
        kernel = np.asarray(jfa._packed_qkv_bwd(
            jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16),
            nh, scale, True), np.float32)
        kernel = np.split(kernel, 3, axis=-1)
    else:
        views = tuple(x.contiguous() for x in views)
        kernel = [np.asarray(x, np.float32) for x in jfa._packed_bwd(
            *(jnp.asarray(a, jnp.bfloat16) for a in np.split(qkv, 3, -1)),
            jnp.asarray(g, jnp.bfloat16), nh, scale, True)]
    assert tfa._check_k4(*views, tg, nh) == (3 * w if layout == "slices"
                                              else w)
    got = emulate_k4(*views, tg, nh, scale)
    plain = tfa.packed_attention_bwd_plain(*views, tg, nh, scale)
    for x, want, ref in zip(got, kernel, plain):
        assert x.shape == (b, l, w) and x.dtype == torch.bfloat16
        close(x.float(), want, BF16_TOL)
        close(x.float(), ref.float(), BF16_TOL)


def test_k4_delta_is_over_the_fp32_p(rng):
    """δ is Σ dp·p over the fp32 p, as `_packed_bwd_body` takes it
    (:996), not FlashAttention's rowsum(g ∘ o) over the bf16 output: the
    two differ, and only the first is K4's."""
    b, l, nh, d = 1, 257, 1, 64
    q, k, v, g = (t(rng.standard_normal((b, l, nh * d)).astype(np.float32))
                  .bfloat16() for _ in range(4))
    scale = d ** -0.5
    qh, kh, vh, gh = (_heads(x, nh) for x in (q, k, v, g))
    stats, _ = _k4_rows(qh, kh, vh, gh, l, scale)
    s = (qh @ kh.transpose(-1, -2)) * (scale * tfa.LOG2E)
    p = torch.softmax(s * np.log(2), dim=-1)
    want = ((gh @ vh.transpose(-1, -2)) * p).sum(-1)
    close(stats[0, :, :l, 2], want[0].numpy(), dict(rtol=1e-4, atol=1e-5))
    o = tfa.packed_attention_plain(q, k, v, nh, scale)
    flash = (gh * _heads(o, nh)).sum(-1)
    assert (flash - want).abs().max() > 1e-4


# ---------------------------------------------------------------------------
# the wrappers' checks
# ---------------------------------------------------------------------------


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


# every shape the paths give K4, and the L it newly takes (600 at D 88:
# three key blocks; 2000 at D 128)
K4_TAKES = [(32, 257, 16, 88), (64, 257, 16, 88), (3, 50, 4, 64),
            (2, 600, 16, 88), (1, 2000, 1, 128)]


@pytest.mark.parametrize("b,l,nh,d", K4_TAKES,
                         ids=[f"{b}x{l}x{nh}x{d}" for b, l, nh, d in K4_TAKES])
def test_k4_checks_take_any_length(b, l, nh, d):
    w = nh * d
    qkv, g = _bf16(b, l, 3 * w), _bf16(b, l, w)
    assert tfa._check_k4(*qkv.chunk(3, dim=-1), g, nh, _bf16(b, l, 3 * w)) \
        == 3 * w
    three = tuple(x.contiguous() for x in qkv.chunk(3, dim=-1))
    assert tfa._check_k4(*three, g, nh) == w


@pytest.mark.parametrize("what,args,match", [
    ("fp32 g", (*_bf16(1, 9, 768).chunk(3, dim=-1),
                torch.zeros(1, 9, 256), 4), "g must be"),
    ("strided g", (*_bf16(1, 9, 768).chunk(3, dim=-1),
                   _bf16(1, 256, 9).transpose(1, 2), 4), "g must be"),
    ("dqkv shape", (*_bf16(1, 9, 768).chunk(3, dim=-1), _bf16(1, 9, 256), 4,
                    _bf16(1, 9, 512)), "dqkv"),
    ("head dim 136", (*_bf16(1, 9, 816).chunk(3, dim=-1), _bf16(1, 9, 272),
                      2), "head dim"),
])
def test_k4_checks_refuse(what, args, match):
    with pytest.raises(ValueError, match=match):
        tfa._check_k4(*args)


@pytest.mark.parametrize("b,l,nh,d", [(2, 257, 16, 88), (112, 257, 16, 64),
                                      (1, 1025, 1, 128), (1, 2049, 4, 64),
                                      (1, 2, 1, 8)],
                         ids=["257x16x88", "257x16x64", "1025x1x128",
                              "2049x4x64", "2x1x8"])
def test_k9_checks_take_any_length(b, l, nh, d):
    assert tfa._check_cls(_bf16(b, l, 3 * nh * d), nh) == (b, l, nh * d, d)


def test_k9_smem_formula():
    """K9's launch is K3's plus one mbarrier and K9's fp32 scratch (the
    CLS token's q, k, v; a chunk's p, the column sums of three key groups
    and the reductions; the CLS row's scores over a key block; the CLS
    column of two Q tiles); it fits a block at every head dim the checks
    take."""
    floats = (3 * 128 + 3 * tfa._CLS_THREADS + 8 + tfa._QKV_ATTN_KEYS
              + 2 * 64)
    for d in (8, 64, 88, 128):
        extra = tfa._qkv_attn_smem_bytes(d, cls=True) - \
            tfa._qkv_attn_smem_bytes(d)
        assert extra == 16 + 4 * floats
        assert tfa._qkv_attn_smem_bytes(d, cls=True) <= tfa._MAX_SMEM
