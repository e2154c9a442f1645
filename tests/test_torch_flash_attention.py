"""The plain versions of the port's kernels K1 and K2
(`mico_tpu_torch/ops/flash_attention.py`) against the JAX package's Pallas
kernels run in interpret mode and their plain references, and the attention
routing of `mico_tpu_torch/ops/attention.py`. On the CPU each wrapper takes
its plain version and launches nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.ops import flash_attention as jfa
from mico_tpu.ops.attention import xla_attention
from mico_tpu_torch.ops import attention as tattn
from mico_tpu_torch.ops import flash_attention as tfa
from mico_tpu_torch.ops.fused_mlp import fused_mlp
from mico_tpu_torch.ops.int8_attention import int8_cross_attention

from torch_port_common import OP_TOL, close, t


def _k1_inputs(rng, b=2, l=257, nh=4, d=88):
    """The shapes of tests/test_attention.py::test_fused_ln_qkv_kernel."""
    w = nh * d
    x = rng.standard_normal((b, l, w)).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(w)).astype(np.float32)
    b0 = (0.1 * rng.standard_normal(w)).astype(np.float32)
    wq = (rng.standard_normal((w, 3 * w)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(3 * w) * 0.05).astype(np.float32)
    return (x, g, b0, wq, bias), nh, d ** -0.5, 1e-6


@pytest.mark.parametrize("affine", [True, False])
def test_k1_plain_matches_pallas_interpret(rng, affine):
    arrays, nh, scale, eps = _k1_inputs(rng)
    jargs = [jnp.asarray(a) for a in arrays]
    kernel = jfa._fused_ln_qkv_attn_fwd(*jargs, nh, scale, eps, affine, True)
    reference = jfa._fused_ln_qkv_reference(*jargs, nh, scale, eps, affine)
    before = tfa.fused_ln_qkv_self_attention.launches
    got = tfa.fused_ln_qkv_self_attention(*[t(a) for a in arrays], nh, scale,
                                          eps, affine)
    assert got.shape == arrays[0].shape
    assert tfa.fused_ln_qkv_self_attention.launches == before
    close(got, kernel, OP_TOL)
    close(got, reference, OP_TOL)


def test_k1_plain_ignores_affine_when_off(rng):
    """affine=False reads neither g nor b0 (the folded layout passes None)."""
    arrays, nh, scale, eps = _k1_inputs(rng, b=1, l=17)
    x, g, b0, w, bias = (t(a) for a in arrays)
    a = tfa.fused_ln_qkv_plain(x, None, None, w, bias, nh, scale, eps, False)
    b = tfa.fused_ln_qkv_plain(x, g, b0, w, bias, nh, scale, eps, False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _qkv(rng, b, h, lq, lk, d):
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d)))


def _padding_bias(rng, b, lq, lk, per_query):
    keep = rng.random((b, lq if per_query else 1, lk)) > 0.3
    keep[..., 0] = True
    return ((1.0 - keep.astype(np.float32)) * -10000.0)[:, None]


@pytest.mark.parametrize("bias_kind", ["none", "b11k", "b1qk"])
def test_k2_plain_matches_pallas_interpret(rng, bias_kind):
    b, h, lq, lk, d = 2, 3, 30, 257, 64
    q, k, v = _qkv(rng, b, h, lq, lk, d)
    bias = None if bias_kind == "none" else _padding_bias(
        rng, b, lq, lk, per_query=bias_kind == "b1qk")
    jb = None if bias is None else jnp.asarray(bias)
    kernel = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 bias=jb, interpret=True)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(t(q), t(k), t(v),
                              bias=None if bias is None else t(bias))
    assert tfa.flash_attention.launches == before
    close(got, kernel, OP_TOL)
    # and the plain twin agrees with the softmax reference of xla_attention
    close(got, xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             bias=jb), OP_TOL)


def test_k2_plain_bf16_scale_placement(rng):
    """In bf16 the bias-free body rounds q·scale·log2(e) to bf16 before the
    product and the biased body q·scale: both as the Pallas bodies do."""
    q, k, v = (a.astype(np.float32) for a in _qkv(rng, 1, 2, 8, 40, 16))
    bias = _padding_bias(rng, 1, 8, 40, per_query=False)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    targs = [t(a).bfloat16() for a in (q, k, v)]
    for jb, tb in ((None, None), (jnp.asarray(bias), t(bias))):
        want = jfa.flash_attention(*args, bias=jb, interpret=True)
        got = tfa.flash_attention(*targs, bias=tb)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2 ** -7, atol=2 ** -7)


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = []
        real_flash, real_plain = tfa.flash_attention, tattn.plain_attention

        def flash(*a, **kw):
            self.calls.append("flash")
            return real_flash(*a, **kw)

        def plain(*a, **kw):
            self.calls.append("plain")
            return real_plain(*a, **kw)

        monkeypatch.setattr(tfa, "flash_attention", flash)
        monkeypatch.setattr(tattn, "plain_attention", plain)


@pytest.mark.parametrize("lq,lk,route", [(64, 64, "plain"), (30, 136, "plain"),
                                         (30, 137, "flash"),
                                         (65, 64, "flash")])
def test_routing_threshold(rng, monkeypatch, lq, lk, route):
    """Lq·Lk ≤ 64·64 stays plain under 'flash' (attention.py:95); above it
    the call goes to K2 — and both routes compute the same attention."""
    spy = _Spy(monkeypatch)
    q, k, v = _qkv(rng, 1, 2, lq, lk, 8)
    out = tattn.multi_head_attention(t(q), t(k), t(v), impl="flash")
    assert spy.calls == [route]
    close(out, xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)),
          OP_TOL)


def test_long_kv_routes(rng, monkeypatch):
    """Past 8192 KV rows: fewer than 128 query rows take plain math
    (`_flash_diff`, flash_attention.py:639-643); more take K6 (its plain
    twin here), where the port once raised NotImplementedError."""
    q, k, v = _qkv(rng, 1, 1, 4, 8193, 8)
    spy = _Spy(monkeypatch)
    out = tfa.flash_attention(t(q), t(k), t(v))
    assert spy.calls == ["flash", "plain"]
    close(out, xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)),
          OP_TOL)
    big_q = rng.standard_normal((1, 1, 128, 8)).astype(np.float32)
    out = tfa.flash_attention(t(big_q), t(k), t(v))
    assert spy.calls == ["flash", "plain", "flash"]
    close(out, xla_attention(jnp.asarray(big_q), jnp.asarray(k),
                             jnp.asarray(v)), OP_TOL)


def test_unknown_impl_raises():
    x = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError):
        tattn.multi_head_attention(x, x, x, impl="xformers")


def test_launch_counters_reset():
    tfa.fused_ln_qkv_self_attention.launches = 3
    tfa.flash_attention.launches = 5
    tfa.packed_attention.launches = 9
    tfa.packed_attention_bwd.launches = 11
    tfa.fused_qkv_self_attention.launches = 13
    tfa.fused_qkv_attn_proj.launches = 17
    tfa.kv_tiled_attention.launches = 19
    tfa.kv_tiled_attention_bwd.launches = 23
    int8_cross_attention.launches = 7
    tfa.packed_qkv_cls_attention.launches = 29
    fused_mlp.launches = 31
    assert tfa.launch_counts() == {"K1": 3, "K2": 5, "K3": 9, "K4": 11,
                                   "K5": 13, "K6": 19, "K6b": 23, "K7": 7,
                                   "K8": 17, "K9": 29, "P1": 31}
    tfa.reset_launch_counts()
    assert tfa.launch_counts() == {"K1": 0, "K2": 0, "K3": 0, "K4": 0,
                                   "K5": 0, "K6": 0, "K6b": 0, "K7": 0,
                                   "K8": 0, "K9": 0, "P1": 0}
