"""K9 (`mico_tpu_torch/ops/flash_attention.py`): the plain twin of the
CLS-split packed attention against the Pallas body `_packed_qkv_cls_kernel`
run in interpret mode (through `_packed_qkv_fwd` with `PACKED_CLS_SPLIT` on,
as `tests/test_attention.py` runs it); the routing of
`packed_qkv_self_attention` under the flag; the gradient under the flag
(K4's) against `jax.grad`; and the wrapper's checks. On the CPU the wrapper
takes its plain twin and launches nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.ops import flash_attention as jfa
from mico_tpu_torch.ops import flash_attention as tfa

from torch_port_common import OP_TOL, close, no_launch, t

# bf16: one ulp at the outputs' magnitudes, for sums taken in another order
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, b, l, nh, d):
    return np.random.default_rng(seed).standard_normal(
        (b, l, 3 * nh * d)).astype(np.float32)


def _pallas_cls(qkv: np.ndarray, nh: int, d: int, dtype) -> np.ndarray:
    """`_packed_qkv_fwd` in interpret mode with the flag on: the CLS-split
    body; the flag and the jit cache restored after."""
    try:
        jfa.PACKED_CLS_SPLIT = True
        jfa._packed_qkv_fwd.clear_cache()
        out = jfa._packed_qkv_fwd(jnp.asarray(qkv, dtype), nh, d ** -0.5,
                                  True)
        return np.asarray(out, np.float32)
    finally:
        jfa.PACKED_CLS_SPLIT = False
        jfa._packed_qkv_fwd.clear_cache()


@pytest.mark.parametrize("b,l,nh,d", [(2, 257, 4, 88), (1, 257, 2, 64),
                                      (1, 385, 2, 32)])
def test_k9_twin_matches_pallas_interpret(b, l, nh, d):
    qkv = _qkv(0, b, l, nh, d)
    want = _pallas_cls(qkv, nh, d, jnp.float32)
    got = no_launch(lambda: tfa.packed_qkv_cls_attention(t(qkv), nh,
                                                         d ** -0.5))
    assert got.shape == (b, l, nh * d) and got.dtype == torch.float32
    close(got, want, OP_TOL)
    # the same function as the general kernel's reference
    close(got, jfa._packed_qkv_reference(jnp.asarray(qkv), nh, d ** -0.5),
          OP_TOL)


def test_k9_twin_bf16_rounding_points_match_pallas():
    """In bf16 the twin rounds where the CLS-split body does: only p_pp
    for the PV product, each row once after the division."""
    b, l, nh, d = 1, 257, 2, 64
    qkv = _qkv(1, b, l, nh, d)
    want = _pallas_cls(qkv, nh, d, jnp.bfloat16)
    got = tfa.packed_qkv_cls_attention(t(qkv).bfloat16(), nh, d ** -0.5)
    assert got.dtype == torch.bfloat16
    close(got.float(), want, BF16_TOL)


def test_k9_twin_is_not_k3s():
    """K9's rounding points differ from K3's (natural exp and the fp32 CLS
    terms, against exp2 and a bf16 p everywhere): in bf16 the two twins
    differ on some outputs, and the K9 twin is the one at the CLS-split
    body's values."""
    b, l, nh, d = 1, 257, 2, 64
    qkv = _qkv(2, b, l, nh, d)
    want = _pallas_cls(qkv, nh, d, jnp.bfloat16)
    x = t(qkv).bfloat16()
    k9 = tfa.packed_qkv_cls_attention_plain(x, nh, d ** -0.5).float()
    k3 = tfa.packed_attention_plain(*x.chunk(3, dim=-1), nh, d ** -0.5).float()
    assert not torch.equal(k9, k3)
    assert (k9 - t(want)).abs().sum() < (k3 - t(want)).abs().sum()


def _spy(monkeypatch):
    calls = []
    for name in ("packed_qkv_cls_attention_plain", "packed_attention_plain"):
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))
    return calls


@pytest.mark.parametrize("l,route", [(257, "packed_qkv_cls_attention_plain"),
                                     (385, "packed_qkv_cls_attention_plain"),
                                     (256, "packed_attention_plain"),
                                     (200, "packed_attention_plain")])
def test_flag_routes_packed_qkv_to_k9(monkeypatch, l, route):
    """With `PACKED_CLS_SPLIT` on, `packed_qkv_self_attention` takes K9 at
    L = 128k + 1 (JAX's condition, flash_attention.py:1144) and K3
    elsewhere; off, K3 at every L."""
    nh, d = 2, 16
    x = t(_qkv(3, 2, l, nh, d))
    calls = _spy(monkeypatch)
    monkeypatch.setattr(tfa, "PACKED_CLS_SPLIT", True)
    got = no_launch(lambda: tfa.packed_qkv_self_attention(x, nh, d ** -0.5))
    assert calls == [route]
    close(got, jfa._packed_qkv_reference(jnp.asarray(x.numpy()), nh,
                                         d ** -0.5), OP_TOL)
    calls.clear()
    monkeypatch.setattr(tfa, "PACKED_CLS_SPLIT", False)
    tfa.packed_qkv_self_attention(x, nh, d ** -0.5)
    assert calls == ["packed_attention_plain"]


def test_three_input_packed_never_takes_k9(monkeypatch):
    """`packed_self_attention` (JAX's `_packed_fwd`, :885) has no CLS
    split: K3 whatever the flag says."""
    nh, d = 2, 16
    q, k, v = t(_qkv(4, 2, 257, nh, d)).chunk(3, dim=-1)
    calls = _spy(monkeypatch)
    monkeypatch.setattr(tfa, "PACKED_CLS_SPLIT", True)
    tfa.packed_self_attention(q, k, v, nh, d ** -0.5)
    assert calls == ["packed_attention_plain"]


def test_grads_under_the_flag_match_jax(monkeypatch):
    """Under the flag the forward is K9's and the backward K4's, as in JAX
    (`_packed_qkv_vjp_bwd`, :1199): values and gradients equal
    `jax.grad` through `packed_qkv_self_attention`."""
    b, l, nh, d = 2, 257, 2, 16
    qkv = _qkv(5, b, l, nh, d)
    w = np.random.default_rng(6).standard_normal((b, l, nh * d)).astype(
        np.float32)

    def loss(x):
        return jnp.sum(jfa.packed_qkv_self_attention(x, nh, d ** -0.5) ** 2
                       * jnp.asarray(w))

    want = jax.grad(loss)(jnp.asarray(qkv))
    calls = _spy(monkeypatch)
    monkeypatch.setattr(tfa, "PACKED_CLS_SPLIT", True)
    x = t(qkv).requires_grad_(True)
    out = tfa.packed_qkv_self_attention(x, nh, d ** -0.5)
    assert calls == ["packed_qkv_cls_attention_plain"]
    close(out, jfa.packed_qkv_self_attention(jnp.asarray(qkv), nh, d ** -0.5),
          GRAD_TOL)
    no_launch(lambda: (out ** 2 * t(w)).sum().backward())
    close(x.grad, want, GRAD_TOL)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("what,qkv,nh,match", [
    pytest.param("fp32", torch.zeros(2, 257, 768), 4, "bf16",
                 id="fp32-qkv0-4-bf16"),
    pytest.param("2-D", _bf16(257, 768), 4, "must be",
                 id="2-D-qkv1-4-must be"),
    pytest.param("head dim 12", _bf16(2, 257, 72), 2, "head dim",
                 id="head dim 12-qkv2-2-head dim"),
    pytest.param("head dim 136", _bf16(2, 257, 816), 2, "head dim",
                 id="head dim 136-qkv3-2-head dim"),
    pytest.param("one token", _bf16(2, 1, 768), 4, "no patch token",
                 id="one token-qkv4-4-no patch token"),
    # L 1025 at D 128: K9's shared memory no longer grows with L (its
    # patch keys stream past one key block, as K3's do), so it is taken
    pytest.param("shared memory", _bf16(1, 1025, 384), 1, None,
                 id="shared memory-qkv5-1-shared memory"),
    pytest.param("strided", _bf16(2, 768, 257).transpose(1, 2), 4,
                 "contiguous", id="strided-qkv6-4-contiguous"),
])
def test_k9_input_checks(what, qkv, nh, match):
    """What the K9 wrapper refuses before a launch on the card (the checks
    are device-independent, so they run here on CPU tensors); a case with
    no match is one the check takes."""
    if match is None:
        b, l, w3 = qkv.shape
        assert tfa._check_cls(qkv, nh) == (b, l, w3 // 3, w3 // 3 // nh)
        return
    with pytest.raises(ValueError, match=match):
        tfa._check_cls(qkv, nh)


def test_k9_input_checks_accept_the_paths_shapes():
    """The shapes the paths give K9 pass: ViT-g's train pass (16 x 88),
    CLIP-L/14 (16 x 64), bigE's head width (16 x 112), 385 and 513 tokens;
    each fits one block's 232,448 bytes of shared memory (K3's launch, one
    mbarrier and the CLS row's scratch: 210,224 bytes at D 88)."""
    for b, l, nh, d in ((2, 257, 16, 88), (2, 257, 16, 64), (1, 257, 16, 112),
                        (1, 385, 4, 64), (1, 513, 4, 88)):
        assert tfa._check_cls(_bf16(b, l, 3 * nh * d), nh) == (b, l, nh * d,
                                                               d)
    assert tfa._qkv_attn_smem_bytes(88, cls=True) == 210224 <= tfa._MAX_SMEM


def test_k9_is_counted_and_cpu_launches_nothing():
    """K9 is in the launch counts; a CPU call takes the twin."""
    assert "K9" in tfa.launch_counts() and "P1" in tfa.launch_counts()
    tfa.reset_launch_counts()
    no_launch(lambda: tfa.packed_qkv_cls_attention(t(_qkv(7, 1, 257, 2, 8)),
                                                   2, 8 ** -0.5))
    assert set(tfa.launch_counts().values()) == {0}
