"""`remat_policy` and `unroll_blocks` of the port's EVA ViT
(`mico_tpu_torch/models/eva_vit.py`) on the CPU at the tiny fp32 config:
every policy's gradients equal the run's without remat, on the training
route (K3/K4's plain twins, DropPath) and on the inference route under
grad (K1's differentiated route, as SCST's `finetune_encoder` runs it); the
inference route's gradients under a policy equal `jax.grad` of the JAX
tower under the same policy; a policy that keeps the products runs none of
the forward's products again in the backward; an unknown name raises;
`unroll_blocks` changes nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mico_tpu.models import eva_vit as jvit
from mico_tpu_torch.models import eva_vit as tvit
from mico_tpu_torch.models import mico as tmico

from torch_port_common import MODEL_TOL, configs, perturbed_params, \
    port_model, t

POLICIES = [None, "nothing_saveable", "everything_saveable", "save:attn_out",
            "save:qkv,mlp_hidden", "dots_saveable",
            "dots_with_no_batch_dims_saveable",
            "checkpoint_dots_with_no_batch_dims"]


@pytest.fixture(scope="module")
def tower():
    jcfg, tcfg = configs(eva=dict(drop_path_rate=0.2))
    params = perturbed_params(jcfg, seed=6)
    model = port_model(params, tcfg)
    for p in model.parameters():
        p.requires_grad_(True)
    return params["vision_encoder"], jcfg.eva_config, model


def _pixels(seed=2, b=3):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, 28, 28)).astype(np.float32)


def _grads(vit, px, cot, train, **kw):
    vit.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(5) if train else None
    out = tvit.eva_vit_forward(vit, t(px), attn_impl="flash", train_rng=gen,
                               **kw)
    (out * cot).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in vit.named_parameters()
                          if p.grad is not None}


@pytest.mark.parametrize("policy", POLICIES, ids=str)
@pytest.mark.parametrize("train", [True, False], ids=["train", "inference"])
def test_policies_keep_the_gradients(tower, policy, train):
    """remat with each policy: the output and every parameter's gradient
    equal the run's without remat (the training route with its DropPath
    draws, and the inference route under grad)."""
    vit = tower[2].vision_encoder
    px = _pixels()
    cot = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(1))
    out0, g0 = _grads(vit, px, cot, train)
    out, g = _grads(vit, px, cot, train, remat=True, remat_policy=policy)
    torch.testing.assert_close(out, out0, rtol=0, atol=0)
    assert g.keys() == g0.keys() and len(g) >= 30
    for name, want in g0.items():
        torch.testing.assert_close(g[name], want, rtol=1e-6, atol=1e-7)


def _jax_path_grad(jg, name):
    parts = name.split(".")
    if parts[0] == "blocks":         # JAX stacks the blocks' leaves
        return jg["blocks"][parts[2]][int(parts[1])]
    node = jg
    for p in parts:
        node = node[p]
    return node


@pytest.mark.parametrize("policy", [None, "save:attn_out",
                                    "dots_with_no_batch_dims_saveable"],
                         ids=str)
def test_inference_route_under_policy_matches_jax(tower, policy):
    """The tower's inference route under grad with remat and a policy (K1's
    differentiated route): gradients equal `jax.grad` of the JAX tower with
    the same remat policy (its fused route's custom VJP)."""
    jparams, jcfg, model = tower
    vit = model.vision_encoder
    px = _pixels(3)
    cot = np.random.default_rng(4).standard_normal((3, 5, 64)).astype(
        np.float32)

    def jloss(p):
        out = jvit.eva_vit_forward(p, jcfg, jnp.asarray(px), attn_impl="flash",
                                   remat=True, remat_policy=policy)
        return jnp.sum(out * cot)

    jg = jax.grad(jloss)(jparams)
    _, g = _grads(vit, px, t(cot), False, remat=True, remat_policy=policy)
    for name, got in g.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(
            _jax_path_grad(jg, name)), **MODEL_TOL, err_msg=name)


class _CountProducts(TorchDispatchMode):
    """Counts the aten products (mm, addmm) dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_products(vit, px, **kw):
    vit.zero_grad(set_to_none=True)
    out = tvit.eva_vit_forward(vit, t(px), attn_impl="flash",
                               train_rng=torch.Generator().manual_seed(5),
                               **kw)
    with _CountProducts() as count:
        out.square().sum().backward()
    return count.n


def test_policies_choose_what_the_backward_recomputes(tower):
    """The backward's products: a plain checkpoint runs the forward's again;
    a products policy runs none of them again (as many as without remat);
    `save:` of the tagged matmul outputs sits between."""
    vit = tower[2].vision_encoder
    px = _pixels()
    plain = _backward_products(vit, px)
    full = _backward_products(vit, px, remat=True)
    dots = _backward_products(vit, px, remat=True,
                              remat_policy="dots_with_no_batch_dims_saveable")
    tagged = _backward_products(vit, px, remat=True,
                                remat_policy="save:qkv,attn_out,mlp_hidden")
    assert dots == plain < tagged < full, (plain, dots, tagged, full)


@pytest.mark.parametrize("train", [True, False], ids=["train", "inference"])
def test_save_policy_keeps_only_the_tagged_product(tower, monkeypatch, train):
    """`save:attn_out` with fp32 weights and bf16 compute keeps one tensor a
    block, the out-projection's product (B·L, W), as JAX's
    `save_only_these_names` keeps the named output: not the bf16 copies
    of the weights and bias that `linear` casts on the way in."""
    vit = tower[2].vision_encoder
    kept = []
    make = tvit.remat_context

    def recording(policy):
        policy_fn = make(policy).args[0]

        def record(ctx, op, *args, **kwargs):
            decision = policy_fn(ctx, op, *args, **kwargs)
            if not ctx.is_recompute and decision.name == "MUST_SAVE":
                kept.append((op.overloadpacket,
                             (args[-2].shape[0], args[-1].shape[1])))
            return decision
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        return lambda: create_selective_checkpoint_contexts(record)

    monkeypatch.setattr(tvit, "remat_context", recording)
    gen = torch.Generator().manual_seed(5) if train else None
    out = tvit.eva_vit_forward(vit, t(_pixels(b=2)), attn_impl="flash",
                               compute_dtype=torch.bfloat16, train_rng=gen,
                               remat=True, remat_policy="save:attn_out")
    out.float().square().sum().backward()
    vit.zero_grad(set_to_none=True)
    assert all(p.dtype == torch.float32 for p in vit.parameters())
    seq = out.shape[1]
    assert kept == [(torch.ops.aten.mm, (2 * seq, 64))] * 2, kept


def test_unknown_policy_raises(tower):
    vit = tower[2].vision_encoder
    with pytest.raises(ValueError, match="'offload_dots'"):
        tvit.eva_vit_forward(vit, torch.zeros(1, 3, 28, 28), remat=True,
                             remat_policy="offload_dots")
    # as in JAX, the policy is read only when the blocks are rematerialized
    with torch.no_grad():
        tvit.eva_vit_forward(vit, torch.zeros(1, 3, 28, 28),
                             remat_policy="offload_dots")


def test_unroll_blocks_changes_nothing(tower):
    vit = tower[2].vision_encoder
    px = _pixels(5)
    cot = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(2))
    out0, g0 = _grads(vit, px, cot, True)
    out, g = _grads(vit, px, cot, True, unroll_blocks=True)
    torch.testing.assert_close(out, out0, rtol=0, atol=0)
    for name, want in g0.items():
        torch.testing.assert_close(g[name], want, rtol=0, atol=0)


def test_model_config_reaches_the_tower(tower):
    """`checkpointing` with `remat_policy` and `unroll_blocks` in the model
    config run through `forward_vision_encoder` with the gradients of the
    run without them."""
    import dataclasses

    model = tower[2]
    px = np.random.default_rng(7).standard_normal(
        (2, 2, 3, 28, 28)).astype(np.float32)
    grads, base = [], model.cfg
    try:
        for cfg in (base, dataclasses.replace(
                base, checkpointing=True, unroll_blocks=True,
                remat_policy="save:attn_out")):
            model.cfg = cfg
            model.zero_grad(set_to_none=True)
            out = tmico.forward_vision_encoder(
                model, t(px), train_rng=torch.Generator().manual_seed(3))
            out.square().sum().backward()
            grads.append({n: p.grad.clone() for n, p in
                          model.vision_encoder.named_parameters()
                          if p.grad is not None})
    finally:
        model.cfg = base
    for name, want in grads[0].items():
        torch.testing.assert_close(grads[1][name], want, rtol=1e-6,
                                   atol=1e-7)
