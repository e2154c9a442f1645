"""The plain versions of the port's K5 (`fused_qkv_self_attention`) and K8
(`fused_qkv_attn_proj`) in `mico_tpu_torch/ops/flash_attention.py` against
the JAX package's Pallas kernels run in interpret mode and their plain
references; the wrappers on CPU tensors launch nothing (their
differentiated routes are held to `jax.grad` in `tests/test_torch_scst.py`);
the input checks the wrappers make before a launch on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.ops import flash_attention as jfa
from mico_tpu_torch.ops import flash_attention as tfa

from torch_port_common import OP_TOL, close, no_launch, t

# (B, L, H, D): the ViT-g head dim with a 257-token tail, and bigE's 112
CASES = [(2, 257, 4, 88), (2, 50, 4, 112)]
IDS = ["257x4x88", "50x4x112"]


def _inputs(rng, b, l, nh, d):
    w = nh * d
    x = rng.standard_normal((b, l, w)).astype(np.float32)
    wq = (rng.standard_normal((w, 3 * w)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(3 * w) * 0.05).astype(np.float32)
    wp = (rng.standard_normal((w, w)) * 0.05).astype(np.float32)
    bp = (rng.standard_normal(w) * 0.05).astype(np.float32)
    return x, wq, bias, wp, bp


@pytest.mark.parametrize("b,l,nh,d", CASES, ids=IDS)
def test_k5_plain_matches_pallas_interpret(rng, b, l, nh, d):
    x, wq, bias, _, _ = _inputs(rng, b, l, nh, d)
    jargs = [jnp.asarray(a) for a in (x, wq, bias)]
    scale = d ** -0.5
    kernel = jfa._fused_qkv_attn_fwd(*jargs, nh, scale, True)
    reference = jfa._fused_qkv_reference(*jargs, nh, scale)
    got = no_launch(lambda: tfa.fused_qkv_self_attention(
        t(x), t(wq), t(bias), nh, scale))
    assert got.shape == x.shape
    close(got, kernel, OP_TOL)
    close(got, reference, OP_TOL)


@pytest.mark.parametrize("b,l,nh,d", CASES, ids=IDS)
def test_k8_plain_matches_pallas_interpret(rng, b, l, nh, d):
    arrays = _inputs(rng, b, l, nh, d)
    jargs = [jnp.asarray(a) for a in arrays]
    scale = d ** -0.5
    kernel = jfa._fused_qkv_attn_proj_fwd(*jargs, nh, scale, True)
    reference = jfa._fused_qkv_attn_proj_reference(*jargs, nh, scale)
    got = no_launch(lambda: tfa.fused_qkv_attn_proj(
        *[t(a) for a in arrays], nh, scale))
    assert got.shape == arrays[0].shape
    close(got, kernel, OP_TOL)
    close(got, reference, OP_TOL)


def test_k8_plain_is_k5_then_projection(rng):
    """K8's twin is K5's twin followed by the projection, rounded once."""
    x, wq, bias, wp, bp = (t(a).bfloat16() for a in _inputs(rng, 1, 17, 2, 16))
    o = tfa.fused_qkv_plain(x, wq, bias, 2, 0.25)
    want = (o.float() @ wp.float() + bp.float()).bfloat16()
    got = tfa.fused_qkv_attn_proj_plain(x, wq, bias, wp, bp, 2, 0.25)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card: what a wrapper does
    with a card tensor, short of a launch."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("kernel", ["K1", "K5", "K8"])
def test_differentiated_routes_check_card_inputs(rng, kernel):
    """Under autograd a card tensor the kernels do not take (fp32 here)
    raises in the wrapper, as the same call does under no_grad: the
    differentiated route never computes the plain twin on the card."""
    x, wq, bias, wp, bp = (t(a) for a in _inputs(rng, 1, 9, 2, 16))
    x = x.as_subclass(_OnCard).requires_grad_(True)
    fn = {"K1": lambda: tfa.fused_ln_qkv_self_attention(
              x, None, None, wq, bias, 2, 0.25, 1e-6, False),
          "K5": lambda: tfa.fused_qkv_self_attention(x, wq, bias, 2, 0.25),
          "K8": lambda: tfa.fused_qkv_attn_proj(x, wq, bias, wp, bp, 2,
                                                0.25)}[kernel]
    for grad in (True, False):
        with torch.set_grad_enabled(grad), pytest.raises(
                ValueError, match=f"{kernel} takes bf16 x and w"):
            fn()


@pytest.mark.parametrize("what,args,match", [
    ("fp32 x", (torch.zeros(2, 9, 256), _bf16(256, 768), torch.zeros(768),
                4), "bf16"),
    ("w shape", (_bf16(2, 9, 256), _bf16(256, 512), torch.zeros(768), 4),
     "w must be"),
    ("head dim 136", (_bf16(2, 9, 272), _bf16(272, 816), torch.zeros(816),
                      2), "head dim"),
    # taken (match None): W 80, two heads of 40 (the GEMM needs W % 8,
    # which D % 8 gives), and K1 at L 2000, D 128 (its attention streams
    # key blocks past 272 keys)
    pytest.param("W % 32", (_bf16(2, 9, 80), _bf16(80, 240),
                            torch.zeros(240), 2), None,
                 id="W % 32-args3-W % 32"),
    pytest.param("shared memory", (_bf16(1, 2000, 256), _bf16(256, 768),
                                   torch.zeros(768), 2), None,
                 id="shared memory-args4-shared memory"),
    ("strided x", (_bf16(2, 256, 9).transpose(1, 2), _bf16(256, 768),
                   torch.zeros(768), 4), "contiguous"),
])
def test_kernel_input_checks(what, args, match):
    """What the wrappers refuse before a launch on the card (the checks
    are device-independent, so they run here on CPU tensors), and two
    cases they take (match None). The L 2000 case is K1's."""
    name = "K1" if what == "shared memory" else "K5"
    if match is None:
        b, l, w = args[0].shape
        assert tfa._check_fused_qkv(name, *args) == (b, l, w, w // args[3])
        return
    with pytest.raises(ValueError, match=match):
        tfa._check_fused_qkv(name, *args)


def test_kernel_input_checks_accept_main_path_shapes():
    """The shapes the main paths give the kernels pass: bigE's 16 x 112,
    ViT-g's 16 x 88 (K1 and K5) and the ragged (3, 50, 4 x 64), each within
    the attention's shared memory (`_qkv_attn_smem_bytes`, which K1 and K5
    share)."""
    for b, l, nh, d in ((1, 257, 16, 112), (1, 257, 16, 88), (3, 50, 4, 64)):
        w = nh * d
        for name in ("K1", "K5"):
            assert tfa._check_fused_qkv(
                name, _bf16(b, l, w), _bf16(w, 3 * w), torch.zeros(3 * w),
                nh) == (b, l, w, d)
        assert tfa._qkv_attn_smem_bytes(d) <= tfa._MAX_SMEM
    assert tfa._qkv_attn_smem_bytes(112) == 205888
