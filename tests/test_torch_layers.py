"""The port's elementary ops (`mico_tpu_torch/ops/layers.py`,
`ops/interpolate.py`) against `mico_tpu.ops` on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.ops import interpolate as jax_interp
from mico_tpu.ops import layers as jax_layers
from mico_tpu_torch.ops import interpolate as torch_interp
from mico_tpu_torch.ops import layers as torch_layers

from torch_port_common import OP_TOL, close, t


@pytest.mark.parametrize("with_bias", [True, False])
def test_linear(rng, with_bias):
    x = rng.standard_normal((3, 7, 48)).astype(np.float32)
    w = rng.standard_normal((48, 40)).astype(np.float32) * 0.1
    b = rng.standard_normal(40).astype(np.float32) if with_bias else None
    want = jax_layers.linear(jnp.asarray(x), jnp.asarray(w),
                             None if b is None else jnp.asarray(b))
    got = torch_layers.linear(t(x), t(w), None if b is None else t(b))
    assert got.dtype == torch.float32
    close(got, want, OP_TOL)


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm(rng, affine):
    x = (3.0 + 2.0 * rng.standard_normal((4, 9, 64))).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    args = (g, b) if affine else (None, None)
    want = jax_layers.layer_norm(
        jnp.asarray(x), *[None if a is None else jnp.asarray(a) for a in args],
        1e-6)
    got = torch_layers.layer_norm(
        t(x), *[None if a is None else t(a) for a in args], 1e-6)
    close(got, want, OP_TOL)


def test_layer_norm_bf16_rounds_once(rng):
    """bf16 input: fp32 statistics and affine, one rounding (the same bf16
    values as JAX, up to one ulp where fp32 sums tie-break differently)."""
    x = rng.standard_normal((4, 64)).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = jax_layers.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g),
                                 jnp.asarray(b), 1e-6)
    got = torch_layers.layer_norm(t(x).bfloat16(), t(g), t(b), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -8, atol=2 ** -8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu(rng, dtype):
    """Exact erf GELU in fp32; the tanh approximation in bf16 (compared in
    bf16, where one ulp is 2^-8 relative)."""
    x = (3.0 * rng.standard_normal((5, 33))).astype(np.float32)
    want = np.asarray(jax_layers.gelu(jnp.asarray(x, dtype)), np.float32)
    got = torch_layers.gelu(t(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = OP_TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -8)
    close(got.float(), want, tol)


@pytest.mark.parametrize("in_len,out_len", [(4, 1), (4, 2), (2, 4), (3, 7),
                                            (4, 4)])
def test_interp_nearest_1d(rng, in_len, out_len):
    x = rng.standard_normal((1, 6, in_len)).astype(np.float32)
    want = jax_interp.interp_nearest_1d(jnp.asarray(x), out_len)
    got = torch_interp.interp_nearest_1d(t(x), out_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
