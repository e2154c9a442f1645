"""P1 (`mico_tpu_torch/ops/fused_mlp.py`): the plain twin of the fused ViT
MLP against the probe's Pallas body `mlp_kernel`
(`scripts/pallas_matmul_probe.py:24`) under a `pl.pallas_call` built here in
interpret mode at a small ragged geometry (`pallas_mlp` itself fixes K and N
from the script's globals and takes no `interpret`), in fp32 and bf16; the
wrapper's checks; and the probe script's chain. On the CPU the wrapper
takes its plain twin and launches nothing."""

import importlib.util
import os
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mico_tpu_torch.ops import fused_mlp as tmlp

from torch_port_common import OP_TOL, close, no_launch, t

ROOT = Path(__file__).resolve().parent.parent
# bf16: one ulp at the outputs' magnitudes (~1), for sums in another order
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _load(name: str, rel: str):
    """A script imported by path, with `os.environ` restored after: the
    JAX probe sets TPU_ACCELERATOR_TYPE and TPU_WORKER_HOSTNAMES at import
    (pallas_matmul_probe.py:11-12)."""
    with mock.patch.dict(os.environ):
        spec = importlib.util.spec_from_file_location(name, ROOT / rel)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probe():
    before = dict(os.environ)
    mod = _load("pallas_matmul_probe", "scripts/pallas_matmul_probe.py")
    assert dict(os.environ) == before
    return mod


def _pallas_mlp(probe, x, w1, w2, tile_m):
    """`pallas_mlp`'s call at this geometry, in interpret mode."""
    m, k = x.shape
    n = w1.shape[1]
    return pl.pallas_call(
        probe.mlp_kernel,
        grid=(pl.cdiv(m, tile_m),),
        in_specs=[pl.BlockSpec((tile_m, k), lambda i: (i, 0)),
                  pl.BlockSpec((k, n), lambda i: (0, 0)),
                  pl.BlockSpec((n, k), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((tile_m, k), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True,
    )(x, w1, w2)


def _inputs(seed, m, k, n):
    """x unit-std, W1 and W2 at std 1/sqrt(fan-in): the MLP branch is as
    large as the residual."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32),
            (rng.standard_normal((n, k)) * n ** -0.5).astype(np.float32))


@pytest.mark.parametrize("m,k,n,tile_m", [(200, 64, 256, 64),
                                          (77, 128, 192, 32)])
def test_p1_twin_matches_pallas_interpret_fp32(probe, m, k, n, tile_m):
    arrays = _inputs(0, m, k, n)
    want = _pallas_mlp(probe, *(jnp.asarray(a) for a in arrays), tile_m)
    got = no_launch(lambda: tmlp.fused_mlp(*(t(a) for a in arrays)))
    assert got.shape == (m, k) and got.dtype == torch.float32
    close(got, want, OP_TOL)


def test_p1_twin_bf16_rounding_points_match_pallas(probe):
    """In bf16 the twin rounds where `mlp_kernel` does: h after GELU on the
    fp32 product, y once, then the bf16 residual add."""
    arrays = _inputs(1, 200, 64, 256)
    want = _pallas_mlp(probe, *(jnp.asarray(a, jnp.bfloat16)
                                for a in arrays), 64)
    got = tmlp.fused_mlp(*(t(a).bfloat16() for a in arrays))
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(want, np.float32), BF16_TOL)
    # the branch alone, out - x, so the residual cannot hide it
    x = arrays[0]
    close(got.float() - t(x).bfloat16().float(),
          np.asarray(want, np.float32) - np.asarray(
              jnp.asarray(x, jnp.bfloat16), np.float32), BF16_TOL)


def test_p1_twin_gelu_is_the_tanh_form_on_fp32():
    """GELU is the tanh form applied to the fp32 product, before any
    rounding: with W2 = I the output is x + bf16(gelu_tanh(x W1))."""
    x, w1, _ = _inputs(2, 16, 64, 64)
    got = tmlp.fused_mlp_plain(t(x), t(w1), torch.eye(64))
    h = t(x) @ t(w1)
    want = t(x) + 0.5 * h * (1 + torch.tanh(
        (2 / np.pi) ** 0.5 * (h + 0.044715 * h ** 3)))
    close(got, want.numpy(), OP_TOL)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("what,args,match", [
    ("fp32", (torch.zeros(8, 64), _bf16(64, 128), _bf16(128, 64)), "bf16"),
    ("w1 fp32", (_bf16(8, 64), torch.zeros(64, 128), _bf16(128, 64)),
     "bf16"),
    ("w2 shape", (_bf16(8, 64), _bf16(64, 128), _bf16(64, 128)),
     "do not fit"),
    ("K % 8", (_bf16(8, 100), _bf16(100, 128), _bf16(128, 100)), "K=100"),
    ("N % 8", (_bf16(8, 64), _bf16(64, 100), _bf16(100, 64)), "N=100"),
    ("1-D x", (_bf16(64), _bf16(64, 128), _bf16(128, 64)), "2-D"),
    ("strided", (_bf16(64, 8).T, _bf16(64, 128), _bf16(128, 64)),
     "contiguous"),
])
def test_p1_input_checks(what, args, match):
    """What the P1 wrapper refuses before a launch on the card (the checks
    are device-independent, so they run here on CPU tensors): K and N must
    be multiples of 8, the 16-byte row strides of the GEMMs' tensor maps."""
    with pytest.raises(ValueError, match=match):
        tmlp._check(*args)


@pytest.mark.parametrize("m,k,n", [(28784, 1408, 6144), (200, 128, 256),
                                   (8, 1600, 64), (1, 8, 8)])
def test_p1_input_checks_accept_the_probe_geometry(m, k, n):
    """The probe's x (28784, 1408), W1 (1408, 6144), W2 (6144, 1408) pass,
    as do the small check geometry, a K above 1536 (no shared-memory cap:
    the GEMMs stream K) and the smallest multiples of 8."""
    assert tmlp._check(_bf16(m, k), _bf16(k, n), _bf16(n, k)) == (m, k, n)


def test_probe_chain_on_cpu(probe):
    """`scripts/torch_mlp_probe.py`'s chain at a small geometry equals the
    JAX probe's scan body applied DEPTH times, and launches nothing here."""
    port = _load("torch_mlp_probe", "scripts/torch_mlp_probe.py")
    assert (port.M, port.K, port.N, port.DEPTH) == (probe.M, probe.K,
                                                    probe.N, probe.DEPTH)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    w1s = (rng.standard_normal((3, 64, 128)) * 0.125).astype(np.float32)
    w2s = (rng.standard_normal((3, 128, 64)) * 0.09).astype(np.float32)
    got = no_launch(lambda: port.mlp_chain(t(x), t(w1s), t(w2s)))
    want = jnp.asarray(x)
    for w1, w2 in zip(w1s, w2s):
        want = _pallas_mlp(probe, want, jnp.asarray(w1), jnp.asarray(w2), 8)
    close(got, want, OP_TOL)
