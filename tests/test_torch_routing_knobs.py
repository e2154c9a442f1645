"""JAX's ViT attention-routing knobs in the port
(`mico_tpu_torch/ops/flash_attention.py`: `FUSED_QKV_PROJ`, `FUSED_LN_QKV`,
`FUSED_ATTN_PROJ`; `mico_tpu_torch/ops/layers.py`: `LN_STATS_DTYPE`) set
the same way in both packages: on the tiny pre-norm and post-norm towers
each combination takes JAX's route (spies name the wrapper each block
calls: K1, K5, K8, or the linear qkv into `packed_qkv_self_attention`) and
gives JAX's output; the defaults are JAX's; the knobs are restored after."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.models import eva_vit as jvit
from mico_tpu.ops import flash_attention as jfa
from mico_tpu.ops import layers as jlayers
from mico_tpu_torch.models import eva_vit as tvit
from mico_tpu_torch.ops import flash_attention as tfa
from mico_tpu_torch.ops import layers as tlayers

from torch_port_common import MODEL_TOL, close, configs, perturbed_params, \
    port_model, t

KNOBS = ("FUSED_QKV_PROJ", "FUSED_LN_QKV", "FUSED_ATTN_PROJ")
WRAPPERS = ("fused_ln_qkv_self_attention", "fused_qkv_self_attention",
            "fused_qkv_attn_proj", "packed_qkv_self_attention")
# bf16 LayerNorm: one bf16 ulp at the outputs' magnitudes (|y| < 4)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -6)


def test_defaults_are_jaxs():
    for name in KNOBS + ("PACKED_CLS_SPLIT",):
        assert getattr(tfa, name) == getattr(jfa, name), name
    assert tlayers.LN_STATS_DTYPE == torch.float32
    assert jlayers.LN_STATS_DTYPE == jnp.float32


@pytest.fixture(scope="module", params=[False, True],
                ids=["prenorm", "postnorm"])
def towers(request):
    jcfg, tcfg = configs(eva=dict(postnorm=request.param))
    params = perturbed_params(jcfg, seed=4)
    return params["vision_encoder"], jcfg.eva_config, port_model(params, tcfg)


def _route(postnorm, qkv_proj, ln_qkv, attn_proj):
    """JAX's choice (eva_vit.py:314-353, 438-449) for one block."""
    if not postnorm and ln_qkv and qkv_proj:
        return "fused_ln_qkv_self_attention"
    if not qkv_proj:
        return "packed_qkv_self_attention"
    return "fused_qkv_attn_proj" if attn_proj else "fused_qkv_self_attention"


@pytest.mark.parametrize("qkv_proj,ln_qkv,attn_proj", [
    (True, True, False), (True, True, True), (True, False, False),
    (True, False, True), (False, True, False), (False, False, True)],
    ids=["defaults", "attn-proj", "no-ln", "no-ln-attn-proj", "no-qkv-proj",
         "no-qkv-proj-attn-proj"])
def test_knobs_route_as_jax(rng, towers, monkeypatch, qkv_proj, ln_qkv,
                            attn_proj):
    jparams, jcfg, model = towers
    jax.clear_caches()
    for name, value in zip(KNOBS, (qkv_proj, ln_qkv, attn_proj)):
        monkeypatch.setattr(jfa, name, value)
        monkeypatch.setattr(tfa, name, value)
    calls = []
    for name in WRAPPERS:
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))
    px = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    want = jvit.eva_vit_forward(jparams, jcfg, jnp.asarray(px),
                                attn_impl="flash")
    got = tvit.eva_vit_forward(model.vision_encoder, t(px), attn_impl="flash")
    assert calls == [_route(jcfg.postnorm, qkv_proj, ln_qkv,
                            attn_proj)] * jcfg.layers
    close(got, want, MODEL_TOL)
    jax.clear_caches()


def test_training_route_ignores_the_knobs(rng, towers, monkeypatch):
    """Training keeps its route (linear qkv → K3/K4) whatever the knobs say,
    as JAX's `is_train` gates (eva_vit.py:316, 448)."""
    import torch

    _, _, model = towers
    calls = []
    for name in WRAPPERS:
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))
    px = t(rng.standard_normal((1, 3, 28, 28)).astype(np.float32))
    for qkv_proj in (True, False):
        monkeypatch.setattr(tfa, "FUSED_QKV_PROJ", qkv_proj)
        calls.clear()
        tvit.eva_vit_forward(model.vision_encoder, px, attn_impl="flash",
                             train_rng=torch.Generator().manual_seed(0))
        assert calls == ["packed_qkv_self_attention"] * 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
def test_ln_stats_dtype_bf16_matches_jax(monkeypatch, dtype, affine):
    """`LN_STATS_DTYPE` = bf16 (perf_lab's ln_bf16 variant): statistics and
    affine in bf16 in both packages, the output in the input's dtype."""
    rng = np.random.default_rng(8)
    x = (1.5 + 2.0 * rng.standard_normal((3, 7, 96))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    b = (0.1 * rng.standard_normal(96)).astype(np.float32)
    monkeypatch.setattr(jlayers, "LN_STATS_DTYPE", jnp.bfloat16)
    monkeypatch.setattr(tlayers, "LN_STATS_DTYPE", torch.bfloat16)
    args = (w, b) if affine else (None, None)
    want = jlayers.layer_norm(jnp.asarray(x, dtype),
                              *(None if a is None else jnp.asarray(a)
                                for a in args), 1e-6)
    got = tlayers.layer_norm(t(x).to(getattr(torch, dtype)),
                             *(None if a is None else t(a) for a in args),
                             1e-6)
    assert str(got.dtype) == f"torch.{dtype}"
    close(got.float(), np.asarray(want, np.float32), BF16_TOL)
    # and it is not the fp32-statistics LayerNorm
    monkeypatch.setattr(tlayers, "LN_STATS_DTYPE", torch.float32)
    fp32 = tlayers.layer_norm(t(x), *(None if a is None else t(a)
                                      for a in args), 1e-6)
    assert (fp32 - got.float()).abs().max() > 1e-4
