"""K6b's launch plan (`mico_tpu_torch/ops/flash_attention.py` `k6b_plan`
and the `chunk_splits` layout it takes) and the split algorithm of
`csrc/kv_tiled_attn_bwd.cu`, emulated in torch here, against the JAX
package's `_flash_kv_tiled_bwd` in interpret mode.

The emulation walks what the kernel's blocks do: the keys split into
contiguous runs of whole 64-key chunks (only the last ends at Lk); a block
takes its split's chunks for each group of 128 queries, with
p = exp(s − lse), dp = g·vᵀ, ds = bf16(p·(dp − δ)·scale); a chunk's dV =
bf16(p)ᵀ·g and dK = dsᵀ·q are fp32 sums over the groups, rounded once;
each split's dQ = Σ ds·k over its chunks is an fp32 partial, and dq is the
sum of the partials in split order, rounded once (the combine launch).

Tolerances are test_torch_kv_tiled_attention.py's: fp32 OP_TOL (2e-5; the
splits and the Pallas kernels differ by fp32 summation order only), bf16
2^-7 absolute and relative (both round ds, bf16(p) and the outputs to
bf16, from sums in other orders)."""

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
CHUNK = tfa.KV_CHUNK
GROUP = tfa.K6B_GROUP


def ranges(lk, nsplit, per):
    """The key range [start, end) of each split of a plan."""
    return [(s * per * CHUNK, min(lk, (s + 1) * per * CHUNK))
            for s in range(nsplit)]


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------

PLAN_CASES = [
    # (lk, B·H): one key, one chunk, a ragged second, the long-context
    # step's, ragged and long, more heads than SMs
    (1, 24), (64, 24), (65, 2), (300, 1), (8224, 24), (9000, 2),
    (8256, 1), (4097, 200),
]


def assert_covers_every_key_once(lk, nsplit, per):
    """No split is empty, the splits are contiguous, start on a chunk and
    cover [0, Lk) exactly once; only the last may end inside a chunk."""
    chunks = -(-lk // CHUNK)
    assert 1 <= nsplit <= chunks and per >= 1
    assert (nsplit - 1) * per < chunks <= nsplit * per
    covered = np.zeros(lk, np.int64)
    prev_end = 0
    for start, end in ranges(lk, nsplit, per):
        assert start == prev_end and start % CHUNK == 0
        assert start < end <= lk
        assert end == lk or end % CHUNK == 0
        covered[start:end] += 1
        prev_end = end
    assert prev_end == lk and (covered == 1).all()


@pytest.mark.parametrize("lk,heads", PLAN_CASES)
@pytest.mark.parametrize("sms", [132, 1, 16, 78, 100000])
def test_k6b_plan_covers_every_key_once(lk, heads, sms):
    """On a card of `sms` SMs the plan covers every key once and fills the
    card in one wave where the heads allow (a block takes an SM), with two
    chunks a split at least."""
    nsplit, per = tfa.k6b_plan(lk, heads, sms)
    assert_covers_every_key_once(lk, nsplit, per)
    assert nsplit * heads <= max(sms, heads)
    assert per >= min(tfa.SPLIT_CHUNKS, -(-lk // CHUNK))


@pytest.mark.parametrize("lk", [1, 65, 300, 8224, 9000])
@pytest.mark.parametrize("splits", [1, 2, 3, 11, 1000])
def test_chunk_splits_covers_every_key_once(lk, splits):
    """The layout the split emulation below and the benchmark's sweep ask
    for by count: every key once, and no more splits than asked."""
    nsplit, per = tfa.chunk_splits(lk, splits)
    assert_covers_every_key_once(lk, nsplit, per)
    assert nsplit <= min(splits, -(-lk // CHUNK))


def test_k6b_plan_at_the_long_context_step():
    """(2, 12, 128) queries over 8,224 keys: 129 chunks in 5 splits of 26
    (the last 25, its last chunk 32 keys), 120 blocks on 132 SMs."""
    assert tfa.k6b_plan(8224, 24) == (5, 26)
    assert ranges(8224, 5, 26)[-1] == (4 * 26 * 64, 8224)


# ---------------------------------------------------------------------------
# (b) the split algorithm against `_flash_kv_tiled_bwd`
# ---------------------------------------------------------------------------


def split_bwd(q, k, v, g, lse, delta, bias, scale, splits):
    """The kernel's arithmetic in torch. → (dq, dk, dv) in q's dtype."""
    _, _, lq, d = q.shape
    lk = k.shape[2]
    kf, vf = k.float(), v.float()
    qf, gf = q.float(), g.float()
    nsplit, per = tfa.chunk_splits(lk, splits)
    dk = torch.zeros(kf.shape)
    dv = torch.zeros(vf.shape)
    partials = []
    for start, end in ranges(lk, nsplit, per):
        part = torch.zeros(qf.shape)
        for c0 in range(start, end, CHUNK):
            c1 = min(end, c0 + CHUNK)
            for g0 in range(0, lq, GROUP):
                g1 = min(lq, g0 + GROUP)
                s = torch.matmul(qf[:, :, g0:g1],
                                 kf[:, :, c0:c1].transpose(-1, -2)) * scale
                if bias is not None:
                    bq = slice(None) if bias.shape[2] == 1 else slice(g0, g1)
                    s = s + bias[:, :, bq, c0:c1]
                p = torch.exp(s - lse[:, :, g0:g1])
                dp = torch.matmul(gf[:, :, g0:g1],
                                  vf[:, :, c0:c1].transpose(-1, -2))
                ds = (p * (dp - delta[:, :, g0:g1]) * scale).to(
                    k.dtype).float()
                dv[:, :, c0:c1] += torch.matmul(
                    p.to(v.dtype).float().transpose(-1, -2), gf[:, :, g0:g1])
                dk[:, :, c0:c1] += torch.matmul(ds.transpose(-1, -2),
                                                qf[:, :, g0:g1])
                part[:, :, g0:g1] += torch.matmul(ds, kf[:, :, c0:c1])
        partials.append(part)
    dq = partials[0]
    for part in partials[1:]:
        dq = dq + part
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# 150 queries: a group of 128 and one of 22; 300 keys: 4 chunks of 64 and
# one of 44 (at 3 splits [0, 128), [128, 256), [256, 300))
SHAPE = (1, 2, 150, 300, 32)


def _inputs(bias_kind):
    """q, k, v, g and the bias, fp32 numpy from seed 11. The (B, 1, 1, Lk)
    padding bias masks every key of the middle split at 3 splits ([128,
    256)) and a third of the others; (1, H, Lq, Lk) is dense."""
    rng = np.random.default_rng(11)
    b, h, lq, lk, d = SHAPE
    q, k, v, g = (rng.standard_normal(s).astype(np.float32)
                  for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d),
                            (b, h, lq, d)))
    if bias_kind == "none":
        return q, k, v, g, None
    if bias_kind == "1hqk":
        return q, k, v, g, rng.standard_normal((1, h, lq, lk)).astype(
            np.float32)
    keep = rng.random((b, lk)) > 0.3
    keep[:, :4] = True
    keep[:, 128:256] = False
    return q, k, v, g, ((1.0 - keep) * -10000.0).astype(
        np.float32)[:, None, None, :]


@functools.lru_cache(maxsize=None)
def _pallas(bias_kind, dtype):
    """JAX's lse and δ (from `_flash_kv_tiled_stats`) and
    `_flash_kv_tiled_bwd`'s (dq, dk, dv), interpret mode, fp32 numpy."""
    jdt = DTYPES[dtype][0]
    q, k, v, g, bias = _inputs(bias_kind)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jb = None if bias is None else jnp.asarray(bias)
    scale = SHAPE[-1] ** -0.5
    out, lse = jfa._flash_kv_tiled_stats(jq, jk, jv, jb, scale, 32, 128, True)
    delta = jnp.sum(jg.astype(jnp.float32) * out.astype(jnp.float32),
                    axis=-1, keepdims=True)
    grads = jfa._flash_kv_tiled_bwd(jq, jk, jv, jg, lse, delta, scale, 32,
                                    128, True, bias=jb)
    return (np.asarray(lse), np.asarray(delta),
            tuple(np.asarray(x, np.float32) for x in grads))


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("bias_kind", ["none", "b11k", "1hqk"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k6b_split_matches_pallas_kv_tiled_bwd(dtype, bias_kind, splits):
    """dq from per-split fp32 partials summed in order, dK and dV per key
    split over two query groups; at 3 splits the b11k bias masks the whole
    middle split, whose dK and dV are then 0 and whose partial adds 0."""
    _, tdt, tol = DTYPES[dtype]
    q, k, v, g, bias = _inputs(bias_kind)
    lse, delta, want = _pallas(bias_kind, dtype)
    got = split_bwd(*(t(a).to(tdt) for a in (q, k, v, g)), t(lse), t(delta),
                    None if bias is None else t(bias), SHAPE[-1] ** -0.5,
                    splits)
    for x, w in zip(got, want):
        assert x.dtype == tdt
        close(x.float(), w, tol)
    if bias_kind == "b11k" and splits == 3:
        for x in got[1:]:
            assert not x[:, :, 128:256].float().any()
