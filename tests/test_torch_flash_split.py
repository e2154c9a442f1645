"""The launch plan of K2 and K6 (`mico_tpu_torch/ops/flash_attention.py`
`kv_split_plan`, `flash_plan`, `row_warps`, `_bias_strides`) and the split
algorithm of `csrc/flash_attn.cuh`, emulated in torch here, against the JAX
package's Pallas kernels in interpret mode: `_flash` (both bodies) for K2
and `_flash_kv_tiled_stats` (o and the LSE) for K6.

The emulation deals each split's 64-key chunks round-robin to its key warps
(warp w takes chunks w, w + KW, ...), runs an online softmax per warp at the
body's rounding points, merges the key warps into the first one in order as
the kernel does through shared memory, then combines the splits as
`combine_kernel` does: w_i = exp(m_i − max m), o = Σ acc_i·w_i / Σ l_i·w_i,
lse = max m + log Σ l_i·w_i. Splits are contiguous runs of whole chunks;
only the last may end inside a chunk (a ragged Lk).

Tolerances are those of tests/test_torch_flash_attention.py and
test_torch_kv_tiled_attention.py: fp32 OP_TOL (2e-5; the splits and the
Pallas kernels differ by fp32 summation order only), bf16 2^-7 absolute and
relative (p is rounded against the split's running maximum, the Pallas
kernel's against its own, and both round the output to bf16); the LSE is
an fp32 statistic in both dtypes (OP_TOL)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.ops import flash_attention as jfa
from mico_tpu_torch.ops import flash_attention as tfa

from torch_port_common import OP_TOL, close, t

BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
DTYPES = {"fp32": (jnp.float32, torch.float32, OP_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
NEG_BIG = -1e30
LOG2E = 1.4426950408889634
CHUNK = tfa.KV_CHUNK


def ranges(lk, nsplit, per):
    """The key range [start, end) of each split of a plan."""
    return [(s * per * CHUNK, min(lk, (s + 1) * per * CHUNK))
            for s in range(nsplit)]


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------

PLAN_CASES = [
    # (lq, lk, B·H): below one chunk, one key, whole chunks, ragged
    (10, 1, 12), (30, 40, 36), (30, 64, 36), (30, 257, 36), (10, 1028, 12),
    (128, 128, 24), (128, 8224, 24), (160, 9000, 2), (1, 8224, 24),
    (1, 9000, 1), (64, 4097, 4), (128, 8256, 1),
]


@pytest.mark.parametrize("lq,lk,heads", PLAN_CASES)
@pytest.mark.parametrize("splits", [None, 1, 2, 3, 7, 1000])
def test_plan_covers_every_key_once(lq, lk, heads, splits):
    """No split is empty, the splits are contiguous, start on a chunk and
    cover [0, Lk) exactly once, for the plan's own count and for any count
    asked for (more splits than chunks gives one chunk a split)."""
    nsplit, per = tfa.kv_split_plan(lq, lk, heads, splits=splits)
    chunks = -(-lk // CHUNK)
    assert 1 <= nsplit <= chunks and per >= 1
    assert (nsplit - 1) * per < chunks <= nsplit * per
    covered = np.zeros(lk, np.int64)
    prev_end = 0
    for start, end in ranges(lk, nsplit, per):
        assert start == prev_end and start % CHUNK == 0
        assert start < end <= lk
        covered[start:end] += 1
        prev_end = end
    assert prev_end == lk and (covered == 1).all()
    if splits is not None:
        assert nsplit <= min(splits, chunks)


@pytest.mark.parametrize("lq,lk,heads,want", [
    # the paths' shapes: the long-context cross-attention (K6), the
    # recompute decode and ITM (K2), the long-context causal self-attention
    # (K2), one query row over the long context, the ragged long case
    (128, 8224, 24, (11, 12)),
    (10, 1028, 12, (9, 2)),
    (30, 257, 36, (3, 2)),
    (128, 128, 24, (1, 2)),
    (1, 8224, 24, (11, 12)),
    (160, 9000, 2, (47, 3)),
    (30, 40, 36, (1, 1)),
    (10, 1, 12, (1, 1)),
])
def test_plan_at_path_shapes(lq, lk, heads, want):
    """About two blocks per SM of 132, with SPLIT_CHUNKS chunks a split at
    least: up to two chunks of keys take one split."""
    assert tfa.kv_split_plan(lq, lk, heads) == want
    nsplit, per = want
    assert nsplit == 1 or per >= tfa.SPLIT_CHUNKS


def test_plan_ragged_last_split_ends_inside_a_chunk():
    """9000 = 140·64 + 40: the last split ends 40 keys into its last chunk,
    every other boundary is on a chunk."""
    nsplit, per = tfa.kv_split_plan(160, 9000, 2)
    bounds = ranges(9000, nsplit, per)
    assert bounds[-1][1] == 9000 and 9000 % CHUNK == 40
    assert all(end % CHUNK == 0 for _, end in bounds[:-1])


@pytest.mark.parametrize("lq,nw", [(1, 1), (10, 1), (16, 1), (17, 2),
                                   (30, 2), (33, 3), (64, 4), (70, 5),
                                   (128, 8), (160, 8)])
def test_row_warps(lq, nw):
    """Warps of 16 rows a block: one block holds a head's rows up to 128."""
    assert tfa.row_warps(lq) == nw


@pytest.mark.parametrize("args,want", [
    # (lq, lk, B·H, D, bias rows) -> (row warps, key warps, splits, per):
    # ITM: 3 splits of 2 chunks, a key warp per chunk; the decode and one
    # query row: 9 splits of 2 chunks, 2 key warps; the long-context causal
    # self-attention: 2 key warps over its 2 chunks; K6 at the long-context
    # step: 264 blocks, one warp a row tile; the ragged long case at D 88
    # (8 warps a block at most, 47 splits: the combine's second pass of 32);
    # a per-row bias at 70 x 70
    ((30, 257, 36, 64, 0), (2, 2, 3, 2)),
    ((10, 1028, 12, 64, 0), (1, 2, 9, 2)),
    ((1, 1028, 24, 64, 0), (1, 2, 9, 2)),
    ((128, 128, 24, 64, -1), (8, 2, 1, 2)),
    ((128, 8224, 24, 64, 0), (8, 1, 11, 12)),
    ((128, 8224, 24, 64, 1), (8, 1, 11, 12)),
    ((160, 9000, 2, 88, 0), (8, 1, 47, 3)),
    ((70, 70, 48, 64, -1), (5, 2, 1, 2)),
])
def test_flash_plan_at_path_shapes(args, want):
    assert tfa.flash_plan(*args) == want


@pytest.mark.parametrize("d", [8, 64, 88, 128])
@pytest.mark.parametrize("lq,lk,bias_rows", [(1, 9000, 0), (30, 257, -1),
                                             (128, 1028, -1), (10, 640, 1)])
@pytest.mark.parametrize("key_warps", [None, 1, 3, 64])
def test_flash_plan_fits_the_block(d, lq, lk, bias_rows, key_warps):
    """Up to 16 warps a block at D ≤ 64 and 8 above; the Q tile and one
    round of key-warp chunk slots fit in 227 KB; no more key warps than a
    split has chunks."""
    rw, kw, nsplit, per = tfa.flash_plan(lq, lk, 4, d, bias_rows,
                                         key_warps=key_warps)
    assert rw * kw <= (16 if d <= 64 else 8) and 1 <= kw <= per
    dp = -(-d // 16) * 16
    rows = 16 * rw if bias_rows < 0 else bias_rows
    slot = 4 * CHUNK * (dp + 8) + 4 * rows * (CHUNK + 8)
    assert 32 * rw * (dp + 8) + kw * slot <= 232448
    if key_warps == 1:
        assert kw == 1


def test_bias_strides_broadcast_as_expand():
    q = torch.zeros(2, 3, 5, 8)
    for shape in ((2, 1, 1, 7), (1, 3, 5, 7), (2, 3, 1, 7), (1, 1, 1, 7)):
        bias = torch.randn(shape)
        got, strides = tfa._bias_strides(bias, q, 7)
        assert got is bias
        assert list(strides) == [0 if n == 1 else st
                                 for n, st in zip(shape, bias.stride())]
    got, _ = tfa._bias_strides(torch.zeros(2, 1, 1, 7, dtype=torch.bfloat16),
                               q, 7)
    assert got.dtype == torch.float32
    assert tfa._bias_strides(None, q, 7) == (None, (0, 0, 0, 0))
    for bad in (torch.zeros(2, 2, 1, 7), torch.zeros(2, 1, 7),
                torch.zeros(2, 1, 1, 6)):
        with pytest.raises(ValueError, match="bias"):
            tfa._bias_strides(bad, q, 7)


# ---------------------------------------------------------------------------
# (b) the split algorithm against the Pallas kernels
# ---------------------------------------------------------------------------


def _online(qs, k, v, bias, scale, body, exp, chunks):
    """One warp's online softmax over the given key chunks: (m, l, acc)."""
    m = torch.full((*qs.shape[:3], 1), NEG_BIG)
    l = torch.zeros_like(m)
    acc = torch.zeros(*qs.shape[:3], v.shape[-1])
    for c0, c1 in chunks:
        s = torch.matmul(qs, k[:, :, c0:c1].float().transpose(-1, -2))
        if body == "k6":
            s = s * scale
        if bias is not None:
            s = s + bias[..., c0:c1].float()
        mx = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = exp(m - mx)
        p = exp(s - mx)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(),
                                         v[:, :, c0:c1].float())
        m = mx
    return m, l, acc


def _merge(part, other, exp):
    """Key warp `other` merged into `part` (the kernel's hand-off)."""
    (m, l, acc), (pm, pl, pacc) = part, other
    mn = torch.maximum(m, pm)
    a, b = exp(m - mn), exp(pm - mn)
    return mn, l * a + pl * b, acc * a + pacc * b


def split_attention(q, k, v, bias, scale, body, splits, key_warps=1):
    """The kernel's arithmetic in torch. body "k2": q·scale·log2e rounded to
    k's dtype, base-2 scores; "k2_bias": q·scale rounded, + bias, natural
    exp; "k6": q unscaled, fp32 scores × scale + bias, natural exp. Per
    split and key warp an online softmax over 64-key chunks (p rounded to
    v's dtype for PV, the row sum over the unrounded p), the key warps
    merged, then the splits combined. → (o, lse)."""
    exp = torch.exp2 if body == "k2" else torch.exp
    if body == "k6":
        qs = q.to(k.dtype).float()
    else:
        qscale = scale * LOG2E if body == "k2" else scale
        qs = (q.float() * qscale).to(k.dtype).float()
    lk = k.shape[2]
    nsplit, per = tfa.kv_split_plan(q.shape[2], lk, 1, splits=splits)
    parts = []
    for start, end in ranges(lk, nsplit, per):
        chunks = [(c0, min(end, c0 + CHUNK))
                  for c0 in range(start, end, CHUNK)]
        warps = [_online(qs, k, v, bias, scale, body, exp,
                         chunks[w::key_warps]) for w in range(key_warps)]
        part = warps[0]
        for other in warps[1:]:
            part = _merge(part, other, exp)
        parts.append(part)
    big_m = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    w = [exp(m - big_m) for m, _, _ in parts]
    total_l = sum(l * wi for (_, l, _), wi in zip(parts, w))
    total = sum(acc * wi for (_, _, acc), wi in zip(parts, w))
    return (total / total_l).to(q.dtype), big_m + torch.log(total_l)


SHAPE = (1, 2, 20, 300, 32)   # 300 keys: 4 chunks of 64 and one of 44


def _inputs(bias_kind):
    """q, k, v and the bias, fp32 numpy from seed 7. The (B, 1, 1, Lk)
    padding bias masks every key of the middle split at 3 splits
    ([128, 256)) and a third of the others; (B, 1, Lq, Lk) masks a third of
    each row."""
    rng = np.random.default_rng(7)
    b, h, lq, lk, d = SHAPE
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d)))
    if bias_kind == "none":
        return q, k, v, None
    keep = rng.random((b, lq if bias_kind == "b1qk" else 1, lk)) > 0.3
    keep[..., 0] = True
    if bias_kind == "b11k":
        keep[..., 128:256] = False
    return q, k, v, ((1.0 - keep.astype(np.float32)) * -10000.0)[:, None]


@functools.lru_cache(maxsize=None)
def _pallas(kernel, bias_kind, dtype):
    """The Pallas kernel's (o, lse or None) in interpret mode, fp32 numpy."""
    jdt = DTYPES[dtype][0]
    q, k, v, bias = _inputs(bias_kind)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    scale = SHAPE[-1] ** -0.5
    if kernel == "k2":
        o = jfa._flash(jq, jk, jv, jb, scale=scale, block_q=jfa.DEFAULT_TQ,
                       interpret=True)
        return np.asarray(o, np.float32), None
    o, lse = jfa._flash_kv_tiled_stats(jq, jk, jv, jb, scale, 32, 128, True)
    return np.asarray(o, np.float32), np.asarray(lse)


@pytest.mark.parametrize("key_warps", [1, 3])
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("bias_kind", ["none", "b11k", "b1qk"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k2_split_matches_pallas_flash(dtype, bias_kind, splits, key_warps):
    """K2's bodies: `_kernel` with no bias (base 2), `_kernel_bias` with
    one. The b11k bias masks chunks 2 and 3 (keys 128..255): at 3 splits
    the whole middle split, and at 1 split with 3 key warps all of warp
    2's keys (warp w takes chunks w, w + 3)."""
    _, tdt, tol = DTYPES[dtype]
    q, k, v, bias = _inputs(bias_kind)
    want, _ = _pallas("k2", bias_kind, dtype)
    body = "k2" if bias is None else "k2_bias"
    got, _ = split_attention(*(t(a).to(tdt) for a in (q, k, v)),
                             None if bias is None else t(bias),
                             SHAPE[-1] ** -0.5, body, splits, key_warps)
    assert got.dtype == tdt
    close(got.float(), want, tol)


@pytest.mark.parametrize("key_warps", [1, 3])
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("bias_kind", ["none", "b11k", "b1qk"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k6_split_matches_pallas_kv_tiled_stats(dtype, bias_kind, splits,
                                                key_warps):
    """K6's body with the LSE; at 3 splits the b11k bias masks the whole
    middle split, whose weight exp(m_1 − m) is then ~exp(−10000) = 0."""
    _, tdt, tol = DTYPES[dtype]
    q, k, v, bias = _inputs(bias_kind)
    want, want_lse = _pallas("k6", bias_kind, dtype)
    got, lse = split_attention(*(t(a).to(tdt) for a in (q, k, v)),
                               None if bias is None else t(bias),
                               SHAPE[-1] ** -0.5, "k6", splits, key_warps)
    close(got.float(), want, tol)
    close(lse, want_lse, OP_TOL)
