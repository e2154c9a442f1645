"""The port's int8 cross-attention (`mico_tpu_torch/ops/int8_attention.py`,
kernel K7's plain twin) against `mico_tpu.ops.int8_attention` on the CPU:
`quantize_kv`, the plain twin against the Pallas body run in interpret mode
(fp32 and bf16 inputs), and the int8 decode route of `generation.py` against
JAX's, whose cross-attention then runs the Pallas body in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu import generation as jgen
from mico_tpu.ops import int8_attention as ji8
from mico_tpu_torch import generation as tgen
from mico_tpu_torch.ops import flash_attention as tfa
from mico_tpu_torch.ops import int8_attention as ti8

from torch_port_common import OP_TOL, close, decoder_setup, question_batch, t

# the card's kernel-vs-plain gate, for bf16 inputs (chip_smoke.py)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_MEAN_MAX = 2e-3


def _qkv(rng, b, lq, lk, h, scale=1.0):
    q = rng.standard_normal((b, lq, h)).astype(np.float32)
    k = (scale * rng.standard_normal((b, lk, h))).astype(np.float32)
    v = (scale * rng.standard_normal((b, lk, h))).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,lk,h,nh,scale", [
    (2, 9, 32, 4, 3.0), (3, 257, 128, 2, 0.5), (1, 40, 64, 1, 1e-12),
])
def test_quantize_kv_matches_jax(rng, b, lk, h, nh, scale):
    """Same int8 values; scales within 1 ulp (a zero row takes 1e-8/127)."""
    x = (scale * rng.standard_normal((b, lk, h))).astype(np.float32)
    x[0, 0] = 0.0
    want8, want_s = ji8.quantize_kv(jnp.asarray(x), nh)
    got8, got_s = ti8.quantize_kv(t(x), nh)
    assert got8.dtype == torch.int8 and tuple(got_s.shape) == (b, lk, nh)
    np.testing.assert_array_max_ulp(got_s.numpy(), np.asarray(want_s), 1)
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))


@pytest.mark.parametrize("b,lq,lk,h,nh", [
    (3, 6, 17, 32, 4),          # the JAX test's geometry, d = 8
    (2, 6, 257, 128, 2),        # beam rows over one frame, d = 64 as K7's
    (2, 2, 514, 128, 2),        # greedy rows over two frames
])
def test_plain_matches_pallas_body_fp32(rng, b, lq, lk, h, nh):
    q, k, v = _qkv(rng, b, lq, lk, h)
    k8, ks = ji8.quantize_kv(jnp.asarray(k), nh)
    v8, vs = ji8.quantize_kv(jnp.asarray(v), nh)
    scale = float(h // nh) ** -0.5
    want = ji8._int8_cross_call(jnp.asarray(q), k8, ks, v8, vs, nh, scale, True)
    got = ti8.int8_cross_attention_plain(
        t(q), t(np.asarray(k8)), t(np.asarray(ks)), t(np.asarray(v8)),
        t(np.asarray(vs)), nh, scale)
    close(got, want, OP_TOL)


@pytest.mark.parametrize("b,lq,lk", [(2, 6, 257), (1, 10, 300)])
def test_plain_matches_pallas_body_bf16(rng, b, lq, lk):
    """bf16 q: both round the dequantised K/V, p and the output to bf16;
    held at the kernel tolerance (fp32 sums in another order can move a
    bf16 rounding by one ulp)."""
    h, nh = 128, 2
    q, k, v = _qkv(rng, b, lq, lk, h)
    k8, ks = ji8.quantize_kv(jnp.asarray(k), nh)
    v8, vs = ji8.quantize_kv(jnp.asarray(v), nh)
    qb = jnp.asarray(q, jnp.bfloat16)
    want = ji8._int8_cross_call(qb, k8, ks, v8, vs, nh, 0.125, True)
    got = ti8.int8_cross_attention_plain(
        t(q).to(torch.bfloat16), t(np.asarray(k8)), t(np.asarray(ks)),
        t(np.asarray(v8)), t(np.asarray(vs)), nh, 0.125)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, **BF16_TOL)
    assert np.abs(got - want).mean() <= BF16_MEAN_MAX


def test_wrapper_on_cpu_takes_the_plain_twin(rng):
    """On CPU tensors the wrapper runs the plain twin and launches nothing."""
    q, k, v = _qkv(rng, 2, 6, 33, 64)
    k8, ks = ti8.quantize_kv(t(k), 1)
    v8, vs = ti8.quantize_kv(t(v), 1)
    tfa.reset_launch_counts()
    got = ti8.int8_cross_attention(t(q), k8, ks, v8, vs, 1)
    want = ti8.int8_cross_attention_plain(t(q), k8, ks, v8, vs, 1, 0.125)
    assert torch.equal(got, want)
    assert tfa.launch_counts()["K7"] == 0


@pytest.fixture(scope="module")
def decoders():
    return decoder_setup()


@pytest.fixture(scope="module")
def questions():
    return question_batch()


@pytest.fixture
def pallas_interpret(monkeypatch):
    """JAX's int8 route through the Pallas body in interpret mode; the flag
    is read at trace time, so compiled programs are dropped before and
    after."""
    jax.clear_caches()
    monkeypatch.setattr(ji8, "FORCE_KERNEL_INTERPRET", True)
    yield
    jax.clear_caches()


CASES = [("caption", "greedy"), ("caption", "beam"), ("qa", "greedy"),
         ("qa", "beam")]


@pytest.mark.parametrize("entry,mode", CASES)
def test_int8_route_tokens_match_jax(decoders, questions, pallas_interpret,
                                     monkeypatch, entry, mode):
    """The port's int8 route (K7's plain twin) gives JAX's tokens exactly,
    and every cached step's cross-attention goes through the K7 wrapper."""
    jparams, jcfg, model, cond = decoders
    calls = []
    real = tgen.int8_cross_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tgen, "int8_cross_attention", spy)
    n = 7
    kw = dict(max_new_tokens=n, mode=mode, num_beams=3, int8_cross_kv=True)
    if entry == "caption":
        want = jgen.generate(jparams, jcfg, jnp.asarray(cond), **kw)
        got = tgen.generate(model, t(cond), **kw)
    else:
        ids, mask = questions
        want = jgen.generate_answers(jparams, jcfg, jnp.asarray(ids),
                                     jnp.asarray(mask), jnp.asarray(cond), **kw)
        got = tgen.generate_answers(model, t(ids), t(mask), t(cond), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = 2 * (3 if mode == "beam" else 1)
    assert calls == [(cond.shape[0], rows, 64)] * (n * jcfg.num_hidden_layers)
