"""`mico_tpu_torch/ops/interpolate.py` against `mico_tpu/ops/interpolate.py`
on the CPU: the bilinear resize (align_corners=False, no antialias) on odd
and even sizes, up and down, per axis and both, and against torch's own
`F.interpolate` of the same sampling rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mico_tpu.ops.interpolate import interp_bilinear_2d as jax_bilinear
from mico_tpu_torch.ops.interpolate import interp_bilinear_2d

from torch_port_common import OP_TOL, close, t


@pytest.mark.parametrize("in_hw,out_hw", [
    ((7, 9), (14, 18)),    # odd, up
    ((8, 6), (16, 12)),    # even, up
    ((9, 7), (4, 3)),      # odd, down
    ((16, 16), (5, 5)),    # even, down
    ((2, 2), (3, 3)),      # the CLIP loader's grid resize, up
    ((6, 5), (6, 8)),      # one axis kept
])
def test_bilinear_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(0).standard_normal(
        (2, 3) + in_hw).astype(np.float32)
    got = interp_bilinear_2d(t(x), out_hw)
    assert got.shape == (2, 3) + out_hw
    close(got, jax_bilinear(jnp.asarray(x), out_hw), OP_TOL)
    close(got, F.interpolate(t(x), out_hw, mode="bilinear",
                             align_corners=False).numpy(), OP_TOL)


def test_bilinear_same_size_is_identity():
    x = torch.randn(1, 2, 5, 5)
    assert interp_bilinear_2d(x, (5, 5)) is x


def test_bilinear_keeps_dtype():
    x = torch.randn(3, 4, 4).bfloat16()
    assert interp_bilinear_2d(x, (6, 6)).dtype == torch.bfloat16
