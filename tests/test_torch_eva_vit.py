"""The port's EVA ViT (`mico_tpu_torch/models/eva_vit.py`) against
`mico_tpu.models.eva_vit` on the CPU, pre-norm (EVA01) and post-norm
(EVA02-CLIP-bigE) blocks, with and without LayerScale: the forward on the
'flash' route (K1 for pre-norm, K5 or, with `FUSED_ATTN_PROJ`, K8 for
post-norm) and on the unfused route, unfolded and folded, and the training
route."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.models import eva_vit as jvit
from mico_tpu.ops import flash_attention as jfa
from mico_tpu_torch.config import EvaVitConfig
from mico_tpu_torch.models import eva_vit as tvit
from mico_tpu_torch.ops import flash_attention as tfa

from torch_port_common import MODEL_TOL, close, configs, perturbed_params, \
    port_model, t

IMPLS = {"flash": "flash", "plain": "xla"}


@pytest.fixture(scope="module",
                params=[(False, None), (False, 0.1), (True, None), (True, 0.1)],
                ids=["eva01", "layerscale", "postnorm", "postnorm-layerscale"])
def towers(request):
    """(JAX ViT params, JAX EvaVitConfig, port MiCo) of the tiny config."""
    postnorm, ls = request.param
    jcfg, tcfg = configs(eva=dict(postnorm=postnorm, ls_init_value=ls))
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
        blk = vit.blocks[0]
        assert blk.get("gamma_1") is None and blk.get("gamma_2") is None
        # a post-norm block's LNs feed no matmul: they stay, unfolded
        assert (blk.get("norm1_w") is None) != jcfg.postnorm
        assert (blk.get("qkv_bias") is None) == jcfg.postnorm
    px = rng.standard_normal((3, 3, 28, 28)).astype(np.float32)
    want = jvit.eva_vit_forward(jparams, jcfg, jnp.asarray(px),
                                attn_impl=IMPLS[impl])
    got = tvit.eva_vit_forward(vit, t(px), attn_impl=impl)
    assert got.shape == (3, 5, 64)
    close(got, want, MODEL_TOL)


def test_k1_route_on_cpu_launches_nothing(rng, towers):
    """'flash' takes the K1 wrapper (K5's for a post-norm tower), which on
    CPU tensors runs its plain version: the launch counts do not move."""
    tfa.reset_launch_counts()
    px = t(rng.standard_normal((1, 3, 28, 28)).astype(np.float32))
    tvit.eva_vit_forward(towers[2].vision_encoder, px, attn_impl="flash")
    assert tfa.launch_counts() == {"K1": 0, "K2": 0, "K3": 0, "K4": 0,
                                   "K5": 0, "K6": 0, "K6b": 0, "K7": 0,
                                   "K8": 0, "K9": 0, "P1": 0}


@pytest.mark.parametrize("fused_proj,folded",
                         [(False, False), (True, False), (True, True)],
                         ids=["k5", "k8", "k8-folded"])
def test_flash_inference_wrappers(rng, towers, monkeypatch, folded,
                                  fused_proj):
    """Which wrapper each block's 'flash' inference calls: K1 for a
    pre-norm block whatever `FUSED_ATTN_PROJ` says; K5 then the output
    projection for a post-norm block, or K8 when `FUSED_ATTN_PROJ` is on
    (mirrored in the JAX package) — and the output equals JAX's."""
    import jax

    jparams, jcfg, model = towers
    vit = model.vision_encoder
    if folded:
        jparams = jvit.fold_inference_params(jparams, jcfg)
        vit = copy.deepcopy(vit)
        vit.fold_inference_params()
    jax.clear_caches()
    monkeypatch.setattr(jfa, "FUSED_ATTN_PROJ", fused_proj)
    monkeypatch.setattr(tfa, "FUSED_ATTN_PROJ", fused_proj)
    calls = []
    for name in ("fused_ln_qkv_self_attention", "fused_qkv_self_attention",
                 "fused_qkv_attn_proj"):
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))
    px = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    want = jvit.eva_vit_forward(jparams, jcfg, jnp.asarray(px),
                                attn_impl="flash")
    got = tvit.eva_vit_forward(vit, t(px), attn_impl="flash")
    if not jcfg.postnorm:
        route = "fused_ln_qkv_self_attention"
    else:
        route = "fused_qkv_attn_proj" if fused_proj else \
            "fused_qkv_self_attention"
    assert calls == [route] * jcfg.layers
    close(got, want, MODEL_TOL)


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


# ---------------------------------------------------------------------------
# the training route (train_rng): K3/K4 attention, DropPath, PatchDropout
# ---------------------------------------------------------------------------


def test_training_route_matches_jax(rng, towers, monkeypatch):
    """With a train generator and the regularizers' rates at 0, the block
    takes (LN →) qkv → `packed_qkv_self_attention` (never K1, K5 or K8),
    and the output and the gradients of a scalar loss equal JAX's training
    route."""
    import jax

    jparams, jcfg, model = towers
    vit = copy.deepcopy(model.vision_encoder).requires_grad_(True)
    px = rng.standard_normal((3, 3, 28, 28)).astype(np.float32)
    w = rng.standard_normal((3, 5, 64)).astype(np.float32)

    def loss(p):
        out = jvit.eva_vit_forward(p, jcfg, jnp.asarray(px), attn_impl="flash",
                                   train_rng=jax.random.PRNGKey(0))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), want_grads = jax.value_and_grad(loss, has_aux=True)(jparams)
    calls = []
    real = tfa.packed_qkv_self_attention
    monkeypatch.setattr(tfa, "packed_qkv_self_attention",
                        lambda *a: calls.append(1) or real(*a))
    got = tvit.eva_vit_forward(vit, t(px), attn_impl="flash",
                               train_rng=torch.Generator().manual_seed(0))
    assert len(calls) == jcfg.layers
    close(got, want, MODEL_TOL)
    (got * t(w)).sum().backward()
    for name, p in vit.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            ref = want_grads["blocks"][parts[2]][int(parts[1])]
        else:
            ref = want_grads[parts[0]]
            for part in parts[1:]:
                ref = ref[part]
        # the CLIP head is not on this path: JAX's gradient is zero there
        close(torch.zeros_like(p) if p.grad is None else p.grad, ref,
              MODEL_TOL)


def test_drop_path_schedule_and_contract():
    cfg = EvaVitConfig(image_size=28, patch_size=14, layers=5, width=8,
                       head_width=4, drop_path_rate=0.4)
    rates = tvit.drop_path_rates(cfg)
    np.testing.assert_allclose(rates, np.linspace(0.0, 0.4, 5, dtype=np.float32),
                               rtol=0, atol=0)
    y = torch.randn(6, 3, 8)
    keep = torch.tensor([True, False, True, True, False, True])
    out = tvit.drop_path(y, keep, torch.tensor(0.6))
    for i in range(6):
        want = y[i] / 0.6 if keep[i] else torch.zeros_like(y[i])
        torch.testing.assert_close(out[i], want)
    # bf16: 1 / keep in bf16, as JAX divides by keep cast to the dtype
    yb = y.bfloat16()
    kb = torch.tensor(0.6).bfloat16().item()
    torch.testing.assert_close(tvit.drop_path(yb, keep, torch.tensor(0.6))[0],
                               yb[0] / kb)


def test_patch_dropout_contract():
    x = torch.arange(2 * 17 * 4, dtype=torch.float32).reshape(2, 17, 4)
    out = tvit.patch_dropout(x, 0.5, torch.Generator().manual_seed(0))
    n_keep = max(1, int(16 * 0.5))
    assert out.shape == (2, 1 + n_keep, 4)
    assert torch.equal(out[:, 0], x[:, 0])            # CLS exempt
    for b in range(2):
        rows = [int(r[0].item() - x[b, 0, 0].item()) // 4 for r in out[b, 1:]]
        assert len(set(rows)) == n_keep and all(1 <= r <= 16 for r in rows)
        for r, got in zip(rows, out[b, 1:]):
            assert torch.equal(got, x[b, r])


def test_regularized_training_forward_and_remat():
    """DropPath 0.4 and PatchDropout 0.25 run in training, the draws follow
    the generator's seed, and a rematerialised forward (each block under
    torch.utils.checkpoint) recomputes with the same masks: equal output
    and gradients."""
    cfg = EvaVitConfig(image_size=28, patch_size=14, layers=3, width=64,
                       head_width=32, embed_dim=64, drop_path_rate=0.4,
                       patch_dropout=0.25)
    vit = tvit.EvaVisionTransformer(
        cfg, tvit.Init(torch.Generator().manual_seed(0))).requires_grad_(True)
    px = torch.randn(4, 3, 28, 28, generator=torch.Generator().manual_seed(1))
    results = []
    for remat in (False, True):
        vit.zero_grad()
        out = tvit.eva_vit_forward(vit, px, attn_impl="flash", remat=remat,
                                   train_rng=torch.Generator().manual_seed(3))
        out.square().sum().backward()
        results.append((out.detach(), {n: p.grad.clone()
                                       for n, p in vit.named_parameters()
                                       if p.grad is not None}))
    assert results[0][0].shape == (4, 1 + 3, 64)
    torch.testing.assert_close(results[1][0], results[0][0], rtol=0, atol=0)
    for name, g in results[0][1].items():
        torch.testing.assert_close(results[1][1][name], g, rtol=1e-6,
                                   atol=1e-7)
    other = tvit.eva_vit_forward(vit, px, attn_impl="flash",
                                 train_rng=torch.Generator().manual_seed(4))
    assert not torch.equal(other, results[0][0])
    with torch.no_grad():
        evaluated = tvit.eva_vit_forward(vit, px, attn_impl="flash")
    assert evaluated.shape == (4, 5, 64)


@pytest.mark.parametrize("kw,item", [(dict(pipeline_stages=2), "parallelism")])
def test_unported_training_options_raise(towers, kw, item):
    """Pipeline stages are ported: a whole tower on one process cannot
    hold two stages, and the error names the mesh they need."""
    with pytest.raises(ValueError,
                       match=f"{item}: .*mesh's model axis.*model=2"):
        tvit.eva_vit_forward(towers[2].vision_encoder,
                             torch.zeros(1, 3, 28, 28), **kw)
