"""The port's long-context attention (`mico_tpu_torch/ops/flash_attention.py`):
K6's and K6b's plain versions against the JAX package's Pallas kernels
`_flash_kv_tiled`, `_flash_kv_tiled_stats` and `_flash_kv_tiled_bwd` run in
interpret mode (as tests/test_attention.py runs them), and the public
`flash_attention` past MAX_RESIDENT_KV against JAX's, forward and gradients.
On the CPU every wrapper takes its plain version and launches nothing.

Tolerances: fp32 OP_TOL (2e-5; the Pallas kernels' online softmax and the
full-row twins differ by summation order only: ≤ 2e-6 measured). bf16
2^-7 absolute and relative: the twins round p against the row's maximum,
the Pallas kernel against its running maximum, and both round the output
to bf16 (2^-9 relative; ≤ 2e-3 measured on outputs up to 1). The public
entry at (1, 1, 160, 8256, 32): 5e-4, as
`test_long_context_grad_routes_through_pallas_bwd`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.ops import flash_attention as jfa
from mico_tpu.ops.attention import xla_attention
from mico_tpu_torch.ops import attention as tattn
from mico_tpu_torch.ops import flash_attention as tfa

from torch_port_common import OP_TOL, close, no_launch, t

BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
LONG_TOL = dict(rtol=5e-4, atol=5e-4)
DTYPES = {"fp32": (jnp.float32, torch.float32, OP_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _arrays(rng, b, h, lq, lk, d, scale=1.0):
    """q, k, v and an output gradient g, fp32 numpy."""
    return tuple((scale * rng.standard_normal(s)).astype(np.float32)
                 for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d),
                           (b, h, lq, d)))


def _bias(rng, kind, b, h, lq, lk):
    """None, a (B, 1, 1, Lk) padding mask or a (1, H, Lq, Lk) dense bias."""
    if kind == "none":
        return None
    if kind == "b11k":
        keep = rng.random((b, lk)) > 0.3
        keep[:, :4] = True
        return ((1.0 - keep) * -10000.0).astype(np.float32)[:, None, None, :]
    return rng.standard_normal((1, h, lq, lk)).astype(np.float32)


def _both(a, jdt, tdt):
    return jnp.asarray(a, jdt), t(a).to(tdt)


# ragged q and k tails at 32 / 128 tiles (100 = 3·32 + 4, 290 = 2·128 + 34)
SMALL = (1, 2, 100, 290, 32)


@pytest.mark.parametrize("bias_kind", ["none", "b11k", "1hqk"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k6_plain_matches_pallas_interpret(rng, dtype, bias_kind):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, _ = _arrays(rng, *SMALL)
    bias = _bias(rng, bias_kind, *SMALL[:4])
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, jdt, tdt) for a in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else t(bias)
    scale = SMALL[-1] ** -0.5
    want = jfa._flash_kv_tiled(jq, jk, jv, jb, scale, 32, 128, True)
    want_s, want_lse = jfa._flash_kv_tiled_stats(jq, jk, jv, jb, scale, 32,
                                                 128, True)
    got = no_launch(lambda: tfa.kv_tiled_attention(tq, tk, tv, tb, scale))
    got_s, got_lse = no_launch(lambda: tfa.kv_tiled_attention(
        tq, tk, tv, tb, scale, return_lse=True))
    assert got.dtype == tdt and got_lse.dtype == torch.float32
    assert got_lse.shape == (*SMALL[:3], 1)
    for g, w in ((got, want), (got_s, want_s), (got_s, want)):
        close(g.float(), np.asarray(w, np.float32), tol)
    # the LSE is an fp32 statistic in both dtypes
    close(got_lse, want_lse, OP_TOL)


@pytest.mark.parametrize("bias_kind", ["none", "b11k", "1hqk"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k6b_plain_matches_pallas_interpret(rng, dtype, bias_kind):
    """Both backwards from JAX's own LSE and δ (the stats forward's)."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _arrays(rng, *SMALL)
    bias = _bias(rng, bias_kind, *SMALL[:4])
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (_both(a, jdt, tdt)
                                              for a in arrays)
    jb = None if bias is None else jnp.asarray(bias)
    scale = SMALL[-1] ** -0.5
    out, lse = jfa._flash_kv_tiled_stats(jq, jk, jv, jb, scale, 32, 128, True)
    delta = jnp.sum(jg.astype(jnp.float32) * out.astype(jnp.float32),
                    axis=-1, keepdims=True)
    want = jfa._flash_kv_tiled_bwd(jq, jk, jv, jg, lse, delta, scale, 32, 128,
                                   True, bias=jb)
    got = no_launch(lambda: tfa.kv_tiled_attention_bwd(
        tq, tk, tv, tg, t(np.asarray(lse)), t(np.asarray(delta)),
        None if bias is None else t(bias), scale))
    for x, w, like in zip(got, want, (tq, tk, tv)):
        assert x.dtype == tdt and x.shape == like.shape
        close(x.float(), np.asarray(w, np.float32), tol)


LONG = (1, 1, 160, 8256, 32)     # lk > MAX_RESIDENT_KV, lq >= KV_TILED_MIN_Q


class _Calls:
    """Spies on the port's attention entries: the K6/K6b plain twins (with
    K6's `return_lse`) and plain math."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = {n: getattr(tfa, n) for n in (
            "kv_tiled_attention_plain", "kv_tiled_attention_bwd_plain")}
        real_plain = tattn.plain_attention

        def k6(*a, **kw):
            lse = a[5] if len(a) > 5 else kw.get("return_lse", False)
            self.calls.append("K6+lse" if lse else "K6")
            return real["kv_tiled_attention_plain"](*a, **kw)

        def k6b(*a, **kw):
            self.calls.append("K6b")
            return real["kv_tiled_attention_bwd_plain"](*a, **kw)

        def plain(*a, **kw):
            self.calls.append("plain")
            return real_plain(*a, **kw)

        monkeypatch.setattr(tfa, "kv_tiled_attention_plain", k6)
        monkeypatch.setattr(tfa, "kv_tiled_attention_bwd_plain", k6b)
        monkeypatch.setattr(tattn, "plain_attention", plain)


def _pad_bias(rng, lk):
    mask = (rng.uniform(size=(1, lk)) > 0.2).astype(np.float32)
    mask[:, :8] = 1.0
    return ((1.0 - mask) * -10000.0)[:, None, None, :]


@pytest.mark.parametrize("with_bias", [False, True])
def test_long_context_forward_and_grads_match_jax(rng, monkeypatch,
                                                  with_bias):
    """The public `flash_attention` past the resident cliff: forward and
    the gradients of a sum of squares equal jax.grad of JAX's
    `flash_attention(..., interpret=True)` (its stats forward and Pallas
    backward); the route is K6 with LSE then K6b; the bias gets a zero
    gradient (KV_TILED_BIAS_IS_MASK)."""
    q, k, v, _ = _arrays(rng, *LONG, scale=0.2)
    bias = _pad_bias(rng, LONG[3]) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)

    def loss(q, k, v, b):
        return jnp.sum(jnp.square(jfa.flash_attention(q, k, v, bias=b,
                                                      interpret=True)))

    jargs = [jnp.asarray(a) for a in (q, k, v)]
    want_out = jfa.flash_attention(*jargs, bias=jb, interpret=True)
    want = jax.grad(loss, argnums=(0, 1, 2))(*jargs, jb)
    calls = _Calls(monkeypatch)
    xs = [t(a).requires_grad_(True) for a in (q, k, v)]
    tb = None if bias is None else t(bias).requires_grad_(True)
    out = no_launch(lambda: tfa.flash_attention(*xs, bias=tb))
    no_launch(lambda: out.square().sum().backward())
    assert calls.calls == ["K6+lse", "K6b"]
    close(out, want_out, LONG_TOL)
    for x, g in zip(xs, want):
        close(x.grad, g, LONG_TOL)
    if with_bias:
        assert tb.grad is not None and not tb.grad.any()


def test_long_context_no_grad_runs_k6_without_lse(rng, monkeypatch):
    q, k, v, _ = _arrays(rng, 1, 1, 128, 8200, 16, scale=0.5)
    want = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               interpret=True)
    calls = _Calls(monkeypatch)
    xs = [t(a).requires_grad_(True) for a in (q, k, v)]
    with torch.no_grad():
        out = no_launch(lambda: tfa.flash_attention(*xs))
    assert calls.calls == ["K6"]
    close(out, want, OP_TOL)


def test_long_context_learned_bias_takes_recompute_backward(rng,
                                                            monkeypatch):
    """With KV_TILED_BIAS_IS_MASK off, a biased call under autograd runs K6
    without LSE and the plain recompute backward: the bias gets its true
    gradient, as JAX's XLA-recompute backward gives it."""
    shape = (1, 1, 128, 8200, 16)
    q, k, v, w = _arrays(rng, *shape, scale=0.5)
    bias = 0.3 * rng.standard_normal((1, 1, 1, shape[3])).astype(np.float32)
    jax.clear_caches()
    monkeypatch.setattr(jfa, "KV_TILED_BIAS_IS_MASK", False)
    monkeypatch.setattr(tfa, "KV_TILED_BIAS_IS_MASK", False)
    try:
        want = jax.grad(lambda q, k, v, b: jnp.sum(jfa.flash_attention(
            q, k, v, bias=b, interpret=True) * jnp.asarray(w)),
            argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, bias)))
    finally:
        jax.clear_caches()
    calls = _Calls(monkeypatch)
    xs = [t(a).requires_grad_(True) for a in (q, k, v, bias)]
    out = no_launch(lambda: tfa.flash_attention(*xs[:3], bias=xs[3]))
    (out * t(w)).sum().backward()
    assert calls.calls[0] == "K6" and "K6b" not in calls.calls
    assert xs[3].grad.abs().max() > 0
    for x, g in zip(xs, want):
        close(x.grad, g, LONG_TOL)


def test_short_q_at_long_context_takes_plain_math(rng, monkeypatch):
    """Lq 64 < KV_TILED_MIN_Q at Lk 8256: plain math, as `_flash_diff`
    routes it (flash_attention.py:639-643), forward and backward."""
    q, k, v, w = _arrays(rng, 1, 1, 64, 8256, 32, scale=0.2)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    want = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, interpret=True) * jnp.asarray(w)), argnums=(0, 1, 2))(*jargs)
    calls = _Calls(monkeypatch)
    xs = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = no_launch(lambda: tfa.flash_attention(*xs))
    (out * t(w)).sum().backward()
    assert calls.calls == ["plain"]
    close(out, xla_attention(*jargs), OP_TOL)
    for x, g in zip(xs, want):
        close(x.grad, g, OP_TOL)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _stats(b=1, h=2, lq=16):
    return torch.zeros(b, h, lq, 1), torch.zeros(b, h, lq, 1)


@pytest.mark.parametrize("what,args,match", [
    ("fp32 q", (torch.zeros(1, 2, 16, 32), _bf16(1, 2, 40, 32),
                _bf16(1, 2, 40, 32)), "bf16"),
    ("head dim 12", (_bf16(1, 2, 16, 12), _bf16(1, 2, 40, 12),
                     _bf16(1, 2, 40, 12)), "head dim"),
    ("head dim 136", (_bf16(1, 2, 16, 136), _bf16(1, 2, 40, 136),
                      _bf16(1, 2, 40, 136)), "head dim"),
    ("k/v shapes", (_bf16(1, 2, 16, 32), _bf16(1, 2, 40, 32),
                    _bf16(1, 2, 41, 32)), "k/v shape"),
    ("strided D", (_bf16(1, 2, 32, 16).transpose(2, 3),
                   _bf16(1, 2, 40, 32), _bf16(1, 2, 40, 32)), "unit last"),
    ("misaligned rows", (_bf16(1, 2, 16, 36)[..., :32], _bf16(1, 2, 40, 32),
                         _bf16(1, 2, 40, 32)), "aligned"),
])
def test_kernel_input_checks(what, args, match):
    """What K6 and K6b refuse before a launch on the card (the checks are
    device-independent, so they run here on CPU tensors)."""
    for name in ("K6", "K6b"):
        with pytest.raises(ValueError, match=match):
            tfa._check_heads(name, *args)


def test_k6b_input_checks():
    q, k = _bf16(1, 2, 16, 32), _bf16(1, 2, 40, 32)
    with pytest.raises(ValueError, match="bf16"):
        tfa._check_heads("K6b", q, k, k, torch.zeros(1, 2, 16, 32))
    with pytest.raises(ValueError, match="g shape"):
        tfa._check_heads("K6b", q, k, k, _bf16(1, 2, 17, 32))
    lse, delta = _stats()
    tfa._check_row_stats(q, lse, delta)
    for bad in (lse.double(), torch.zeros(1, 2, 16),
                torch.zeros(1, 16, 2, 1).transpose(1, 2)):
        with pytest.raises(ValueError, match="lse and delta"):
            tfa._check_row_stats(q, bad, delta)


def test_kernel_input_checks_accept_main_path_layout():
    """BERT's cross-attention layout passes: q, k, v (and g) as
    (B, L, H, D) linear outputs viewed as (B, H, L, D)."""
    b, lq, lk, h, d = 2, 128, 8224, 12, 64
    q = _bf16(b, lq, h, d).transpose(1, 2)
    kv = _bf16(b, lk, 2, h, d)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    tfa._check_heads("K6b", q, k, v, _bf16(b, lq, h, d).transpose(1, 2))
    tfa._check_row_stats(q, *_stats(b, h, lq))


def test_cpu_calls_launch_nothing(rng):
    q, k, v, g = (t(a) for a in _arrays(rng, 1, 2, 20, 70, 16))
    before = tfa.launch_counts()
    o, lse = tfa.kv_tiled_attention(q, k, v, None, 0.25, return_lse=True)
    tfa.kv_tiled_attention_bwd(q, k, v, g, lse, (g * o).sum(-1, keepdim=True),
                               None, 0.25)
    assert tfa.launch_counts() == before
    assert before.keys() >= {"K6", "K6b"}
