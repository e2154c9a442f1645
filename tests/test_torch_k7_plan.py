"""K7's launch plan and its fast plan's algorithm on the CPU
(`mico_tpu_torch/ops/int8_attention.py`, `csrc/int8_cross_attn.cu`).

`k7_plan` is held to its contract: every (batch row, head) item goes to
exactly one CTA, the query rows are padded to an n8 or n16 tile, and the
large plan is taken exactly where the fast plan's shared memory does not
fit (or nh is not a multiple of 4). The fast plan's algorithm is emulated
in torch as its CTAs walk it (stages of K7_STAGE_ROWS keys, 16 a warp; S by
stage, the full-row max, bf16 p, each warp's partial O and l over its
stages in order, then the warps' sums in order) and held to the Pallas body
`_int8_cross_call` in interpret mode, in fp32 at OP_TOL and in bf16 at the
kernel's tolerance, at Lk that are not multiples of a stage. The tensor-map
cache's key is held to change with pointer, shape or stride."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.ops import int8_attention as ji8
from mico_tpu_torch.ops import int8_attention as ti8
from mico_tpu_torch.ops.flash_attention import _MAX_SMEM

from torch_port_common import OP_TOL, close, t

# the card's kernel-vs-plain gate, for bf16 inputs (chip_smoke.py)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_MEAN_MAX = 2e-3

# chip_smoke.py's four decode shapes, then ragged and edge ones: (B, nh, Lq,
# Lk)
SHAPES = [(64, 12, 6, 2056), (64, 12, 2, 2056), (128, 12, 6, 514),
          (1, 12, 6, 1028), (1, 12, 6, 257), (3, 12, 6, 257),
          (4, 12, 6, 9108), (64, 12, 1, 2056), (64, 12, 9, 2056),
          (64, 12, 16, 2056), (2, 6, 6, 1028), (8, 12, 16, 4000)]


@pytest.mark.parametrize("sms", [132, 7, 100_000])
@pytest.mark.parametrize("b,nh,lq,lk", SHAPES)
def test_plan_covers_every_item_once(b, nh, lq, lk, sms):
    plan = ti8.k7_plan(b, nh, lq, lk, sms)
    assert plan.n_tile == (8 if lq <= 8 else 16)
    fast_fits = (nh % 4 == 0 and ti8._k7_fast_smem_bytes(
        plan.n_tile, lk, ti8.K7_MIN_STAGES) <= _MAX_SMEM)
    assert plan.route == ("fast" if fast_fits else "large")
    if plan.route == "large":
        assert (plan.ctas, plan.stages) == (b * nh, 0)
        return
    assert plan.ctas == min(b * nh, sms)
    walks = ti8.k7_items(plan, b, nh)
    assert len(walks) == plan.ctas and all(walks)
    flat = [i for walk in walks for i in walk]
    assert sorted(flat) == list(range(b * nh))
    # the deepest ring that fits
    assert ti8.K7_MIN_STAGES <= plan.stages <= ti8.K7_MAX_STAGES
    assert ti8._k7_fast_smem_bytes(plan.n_tile, lk, plan.stages) <= _MAX_SMEM
    assert (plan.stages == ti8.K7_MAX_STAGES or ti8._k7_fast_smem_bytes(
        plan.n_tile, lk, plan.stages + 1) > _MAX_SMEM)


def test_plan_domain_is_the_wrappers():
    """Every shape the fast plan takes, the wrapper takes (its check is the
    large plan's shared memory), and the deployment shapes take the fast
    plan."""
    for lq in range(1, ti8.K7_MAX_Q + 1):
        for lk in range(1, 12_000, 37):
            plan = ti8.k7_plan(2, 12, lq, lk)
            if plan.route == "fast":
                assert ti8._k7_smem_bytes(lq, lk) <= _MAX_SMEM
    for b, nh, lq, lk in SHAPES[:4]:
        assert ti8.k7_plan(b, nh, lq, lk).route == "fast"


def emulate_fast(q, k8, ks, v8, vs, nh, scale, plan):
    """The fast plan in torch, item by item as the CTAs walk them: K and V
    dequantised and rounded to q's dtype, zero past Lk (TMA's fill); S by
    stage and warp in fp32 times scale, -inf past Lk; the full-row max; p =
    exp(s - m) in fp32; each warp's l and fp32 O += bf16(p) V over its
    stages in order; the warps' sums in order; out = (o / l) in q's
    dtype."""
    b, lq, h = q.shape
    lk, d = k8.shape[1], ti8.K7_HEAD_DIM
    rows, warps = ti8.K7_STAGE_ROWS, ti8.K7_FAST_WARPS
    step = rows // warps
    nst = -(-lk // rows)
    lkp = nst * rows
    out = torch.full_like(q, float("nan"))

    def dq(x8, s, bi, hi):
        x = torch.zeros(lkp, d)
        x[:lk] = x8[bi, :, hi * d:(hi + 1) * d].float() * s[bi, :, hi, None]
        return x.to(q.dtype).float()

    def chunks():
        """(warp, its 16 keys of a stage), stage by stage."""
        for st in range(nst):
            for w in range(warps):
                k0 = st * rows + w * step
                yield w, slice(k0, k0 + step)

    for walk in ti8.k7_items(plan, b, nh):
        for item in walk:
            bi, hi = divmod(item, nh)
            qh = q[bi, :, hi * d:(hi + 1) * d].float()
            kd, vd = dq(k8, ks, bi, hi), dq(v8, vs, bi, hi)
            s = torch.empty(lq, lkp)
            for _, keys in chunks():
                s[:, keys] = (qh @ kd[keys].T) * scale
            s[:, lk:] = float("-inf")
            m = s.amax(-1, keepdim=True)
            o_w = torch.zeros(warps, lq, d)
            l_w = torch.zeros(warps, lq)
            for w, keys in chunks():
                p = torch.exp(s[:, keys] - m)
                l_w[w] += p.sum(-1)
                o_w[w] += p.to(q.dtype).float() @ vd[keys]
            o, l = o_w[0], l_w[0]
            for w in range(1, warps):
                o, l = o + o_w[w], l + l_w[w]
            out[bi, :, hi * d:(hi + 1) * d] = (o / l[:, None]).to(q.dtype)
    return out


def _inputs(rng, b, lq, lk, nh):
    h = nh * ti8.K7_HEAD_DIM
    q = rng.standard_normal((b, lq, h)).astype(np.float32)
    k = (2.0 * rng.standard_normal((b, lk, h))).astype(np.float32)
    v = rng.standard_normal((b, lk, h)).astype(np.float32)
    k8, ks = ji8.quantize_kv(jnp.asarray(k), nh)
    v8, vs = ji8.quantize_kv(jnp.asarray(v), nh)
    return q, k8, ks, v8, vs


def _torch(*xs):
    return [t(np.asarray(x)) for x in xs]


# Lk off the stage (K7_STAGE_ROWS) and warp (16) grid, in one stage and
# two; Lq 1, 6, 9, 16 (both tiles); few SMs, so that CTAs walk several
# items
@pytest.mark.parametrize("b,lq,lk,sms", [
    (2, 6, 300, 3), (1, 1, 257, 132), (2, 9, 140, 5), (1, 16, 77, 2),
])
def test_fast_plan_matches_pallas_body_fp32(rng, b, lq, lk, sms):
    nh = 4
    q, k8, ks, v8, vs = _inputs(rng, b, lq, lk, nh)
    plan = ti8.k7_plan(b, nh, lq, lk, sms)
    assert plan.route == "fast" and plan.ctas == min(b * nh, sms)
    want = ji8._int8_cross_call(jnp.asarray(q), k8, ks, v8, vs, nh, 0.125,
                                True)
    got = emulate_fast(*_torch(q, k8, ks, v8, vs), nh, 0.125, plan)
    close(got, want, OP_TOL)


@pytest.mark.parametrize("b,lq,lk,sms", [(2, 6, 300, 3), (1, 12, 200, 132)])
def test_fast_plan_matches_pallas_body_bf16(rng, b, lq, lk, sms):
    """bf16 q: both round k, v, p and the output to bf16; held at the
    kernel tolerance (the fp32 sums run in another order)."""
    nh = 4
    q, k8, ks, v8, vs = _inputs(rng, b, lq, lk, nh)
    plan = ti8.k7_plan(b, nh, lq, lk, sms)
    want = ji8._int8_cross_call(jnp.asarray(q, jnp.bfloat16), k8, ks, v8, vs,
                                nh, 0.125, True)
    qt, k8t, kst, v8t, vst = _torch(q, k8, ks, v8, vs)
    got = emulate_fast(qt.to(torch.bfloat16), k8t, kst, v8t, vst, nh, 0.125,
                       plan)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, **BF16_TOL)
    assert np.abs(got - want).mean() <= BF16_MEAN_MAX


def test_map_key_follows_pointer_shape_and_stride():
    """The tensor maps are kept by each tensor's (pointer, shape, strides):
    the key changes with any of them, and the same tensors give the same
    key."""
    base = torch.zeros(2, 10, 256, dtype=torch.int8)
    k8 = base[:, :5]
    ks = torch.zeros(2, 5, 4)
    v8, vs = torch.zeros_like(k8), torch.zeros_like(ks)
    key = ti8._k7_map_key(k8, ks, v8, vs)
    assert key == ti8._k7_map_key(k8, ks, v8, vs)
    other_ptr = ti8._k7_map_key(k8.clone(), ks, v8, vs)
    other_shape = ti8._k7_map_key(base[:, :4], ks, v8, vs)
    # same pointer and shape as k8, rows 256 bytes apart instead of 2560
    other_stride = ti8._k7_map_key(
        base.view(-1)[:2 * 5 * 256].view(2, 5, 256), ks, v8, vs)
    assert k8.data_ptr() == base.data_ptr()
    assert len({key, other_ptr, other_shape, other_stride}) == 4
    assert key != ti8._k7_map_key(k8, ks.clone(), v8, vs)
    assert key != ti8._k7_map_key(k8, ks, v8, vs[:, :4])
