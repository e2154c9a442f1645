"""K3 and K4 (`mico_tpu_torch/ops/flash_attention.py`): the plain twins of
the packed self-attention forward and backward against the Pallas kernels
`_packed_qkv_fwd` / `_packed_fwd` and `_packed_qkv_bwd` / `_packed_bwd` run
in interpret mode and against the JAX reference's vjp; the autograd
Functions `packed_qkv_self_attention` / `packed_self_attention` against
`jax.grad`; and the rounding points in bf16. On the CPU each wrapper takes
its plain twin and launches nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.ops import flash_attention as jfa
from mico_tpu_torch.ops import flash_attention as tfa

from torch_port_common import close, no_launch, t

FWD_TOL = dict(rtol=2e-5, atol=2e-5)     # tests/test_attention.py:103-117
BWD_TOL = dict(rtol=2e-4, atol=2e-4)     # tests/test_attention.py:143-174
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: one ulp at the outputs' magnitudes, for sums taken in another order
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_k3_twin_matches_pallas_interpret():
    b, l, nh, d = 2, 257, 4, 88
    scale = d ** -0.5
    qkv, = _arrays(0, (b, l, 3 * nh * d))
    q, k, v = np.split(qkv, 3, axis=-1)
    want = jfa._packed_qkv_fwd(jnp.asarray(qkv), nh, scale, True)
    tq, tk, tv = t(qkv).chunk(3, dim=-1)
    got = no_launch(lambda: tfa.packed_attention(tq, tk, tv, nh, scale))
    assert got.shape == (b, l, nh * d)
    close(got, want, FWD_TOL)
    want3 = jfa._packed_fwd(*(jnp.asarray(x) for x in (q, k, v)), nh, scale,
                            True)
    close(tfa.packed_attention_plain(t(q), t(k), t(v), nh, scale), want3,
          FWD_TOL)
    close(got, jfa._packed_qkv_reference(jnp.asarray(qkv), nh, scale), FWD_TOL)


def test_k4_twin_matches_pallas_interpret():
    b, l, nh, d = 2, 257, 4, 88
    scale = d ** -0.5
    q, k, v, g = _arrays(0, *[(b, l, nh * d)] * 4)
    qkv = np.concatenate([q, k, v], axis=-1)
    got = no_launch(lambda: tfa.packed_attention_bwd(
        t(q), t(k), t(v), t(g), nh, scale))
    want = jfa._packed_bwd(*(jnp.asarray(x) for x in (q, k, v, g)), nh, scale,
                           True)
    for gi, wi in zip(got, want):
        close(gi, wi, BWD_TOL)
    want_qkv = jfa._packed_qkv_bwd(jnp.asarray(qkv), jnp.asarray(g), nh, scale,
                                   True)
    _, vjp = jax.vjp(lambda x: jfa._packed_qkv_reference(x, nh, scale),
                     jnp.asarray(qkv))
    (want_ref,) = vjp(jnp.asarray(g))
    dqkv = torch.empty(b, l, 3 * nh * d)
    views = tfa.packed_attention_bwd(t(q), t(k), t(v), t(g), nh, scale, dqkv)
    assert all(x.data_ptr() == dqkv[..., i * nh * d:].data_ptr()
               for i, x in enumerate(views))
    close(dqkv, want_qkv, BWD_TOL)
    close(dqkv, want_ref, BWD_TOL)


def test_packed_qkv_function_grads_match_jax():
    b, l, nh, d = 2, 33, 4, 16
    scale = d ** -0.5
    qkv, w = _arrays(1, (b, l, 3 * nh * d), (b, l, nh * d))

    def loss(x):
        return jnp.sum(jfa.packed_qkv_self_attention(x, nh, scale) ** 2
                       * jnp.asarray(w))

    want = jax.grad(loss)(jnp.asarray(qkv))
    x = t(qkv).requires_grad_(True)
    out = tfa.packed_qkv_self_attention(x, nh, scale)
    close(out, jfa.packed_qkv_self_attention(jnp.asarray(qkv), nh, scale),
          GRAD_TOL)
    no_launch(lambda: (out ** 2 * t(w)).sum().backward())
    close(x.grad, want, GRAD_TOL)


def test_packed_function_grads_match_jax():
    b, l, nh, d = 2, 33, 4, 16
    scale = d ** -0.5
    q, k, v = _arrays(2, *[(b, l, nh * d)] * 3)

    def loss(q, k, v):
        return jnp.sum(jfa.packed_self_attention(q, k, v, nh, scale) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                for a in (q, k, v)))
    xs = [t(a).requires_grad_(True) for a in (q, k, v)]
    (tfa.packed_self_attention(*xs, nh, scale) ** 2).sum().backward()
    for x, w in zip(xs, want):
        close(x.grad, w, GRAD_TOL)


@pytest.mark.parametrize("l,nh,d", [(257, 4, 88), (50, 4, 64)])
def test_bf16_rounding_points_match_pallas(l, nh, d):
    """In bf16 the twins round where the Pallas bodies do: the forward's
    unnormalised p and o / l, the backward's normalised p, ds and the
    outputs."""
    scale = d ** -0.5
    qkv, g = _arrays(3, (2, l, 3 * nh * d), (2, l, nh * d))
    jq = jnp.asarray(qkv, jnp.bfloat16)
    jg = jnp.asarray(g, jnp.bfloat16)
    tq = t(qkv).bfloat16()
    tg = t(g).bfloat16()
    want = jfa._packed_qkv_fwd(jq, nh, scale, True)
    got = tfa.packed_attention(*tq.chunk(3, dim=-1), nh, scale)
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(want, np.float32), BF16_TOL)
    want = jfa._packed_qkv_bwd(jq, jg, nh, scale, True)
    got = torch.cat(tfa.packed_attention_bwd(*tq.chunk(3, dim=-1), tg, nh,
                                             scale), dim=-1)
    close(got.float(), np.asarray(want, np.float32), BF16_TOL)


def test_k4_shared_memory_at_vit_g():
    """K3 is the attention of K1, K5 and K8, one key block of K and V at
    any L (205,888 bytes of the 232,448 one block may take, at D 88); K4's
    rows launch holds the same key block and four 64-row tiles, its columns
    launch 64-row tiles only, so K4 too takes L past one key block at
    ViT-g's D 88 (three contiguous tensors here)."""
    assert tfa._qkv_attn_smem_bytes(88) == 205888 <= tfa._MAX_SMEM
    for l in (257, 600):
        q, k, v, g = (torch.zeros(2, l, 16 * 88, dtype=torch.bfloat16)
                      for _ in range(4))
        assert tfa._check_k4(q, k, v, g, 16) == 16 * 88
