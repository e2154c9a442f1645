"""The port's EVA ViT (`mico_tpu_torch/models/eva_vit.py`) against
`mico_tpu.models.eva_vit` on the CPU: the forward on the K1 route ('flash')
and on the unfused route, unfolded and folded, with LayerScale."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.models import eva_vit as jvit
from mico_tpu_torch.config import EvaVitConfig
from mico_tpu_torch.models import eva_vit as tvit
from mico_tpu_torch.ops import flash_attention as tfa

from torch_port_common import MODEL_TOL, close, configs, perturbed_params, \
    port_model, t

IMPLS = {"flash": "flash", "plain": "xla"}


@pytest.fixture(scope="module", params=[None, 0.1], ids=["eva01", "layerscale"])
def towers(request):
    """(JAX ViT params, JAX EvaVitConfig, port MiCo) of the tiny config."""
    jcfg, tcfg = configs(eva=dict(ls_init_value=request.param))
    params = perturbed_params(jcfg)
    return params["vision_encoder"], jcfg.eva_config, port_model(params, tcfg)


@pytest.mark.parametrize("folded", [False, True], ids=["canonical", "folded"])
@pytest.mark.parametrize("impl", ["flash", "plain"])
def test_forward_matches_jax(rng, towers, folded, impl):
    jparams, jcfg, model = towers
    vit = model.vision_encoder
    if folded:
        jparams = jvit.fold_inference_params(jparams, jcfg)
        vit = copy.deepcopy(vit)
        vit.fold_inference_params()
        assert vit.blocks[0].get("norm1_w") is None
        assert vit.blocks[0].get("qkv_bias") is not None
    px = rng.standard_normal((3, 3, 28, 28)).astype(np.float32)
    want = jvit.eva_vit_forward(jparams, jcfg, jnp.asarray(px),
                                attn_impl=IMPLS[impl])
    got = tvit.eva_vit_forward(vit, t(px), attn_impl=impl)
    assert got.shape == (3, 5, 64)
    close(got, want, MODEL_TOL)


def test_k1_route_on_cpu_launches_nothing(rng, towers):
    """'flash' takes the K1 wrapper, which on CPU tensors runs its plain
    version: the launch count does not move."""
    tfa.reset_launch_counts()
    px = t(rng.standard_normal((1, 3, 28, 28)).astype(np.float32))
    tvit.eva_vit_forward(towers[2].vision_encoder, px, attn_impl="flash")
    assert tfa.launch_counts() == {"K1": 0, "K2": 0, "K7": 0}


def test_pooled_output(rng, towers):
    jparams, jcfg, model = towers
    px = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    want = jvit.eva_vit_forward(jparams, jcfg, jnp.asarray(px),
                                return_all_features=False)
    got = tvit.eva_vit_forward(model.vision_encoder, t(px),
                               return_all_features=False)
    assert got.shape == (2, 64)
    close(got, want, MODEL_TOL)


def test_patch_embed_order(rng):
    """The patch matmul flattens (c, dy, dx) — the conv weight's order."""
    cfg = EvaVitConfig(image_size=28, patch_size=14, layers=1, width=8,
                       head_width=4)
    kernel = torch.from_numpy(rng.standard_normal((3 * 14 * 14, 8)).astype(
        np.float32))
    pe = tvit.ParamGroup(kernel=kernel, bias=torch.zeros(8))
    px = torch.from_numpy(rng.standard_normal((1, 3, 28, 28)).astype(np.float32))
    got = tvit.patch_embed(pe, cfg, px)
    conv = torch.nn.functional.conv2d(
        px, kernel.T.reshape(8, 3, 14, 14), stride=14)
    torch.testing.assert_close(got, conv.flatten(2).transpose(1, 2),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("feature", ["rope", "naiveswiglu", "subln",
                                     "postnorm", "use_rel_pos_bias"])
def test_unported_features_raise(feature):
    cfg = EvaVitConfig(image_size=28, patch_size=14, layers=1, width=8,
                       head_width=4, **{feature: True})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tvit.check_supported(cfg)
