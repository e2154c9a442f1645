"""SCST in the port (`mico_tpu_torch/train/scst.py`, `generate_scst`, the
differentiated routes of K1, K5 and K8) against the JAX package on the CPU
at the tiny fp32 config:

  - K1's, K5's and K8's differentiated routes: the output and every input's
    gradient against `jax.grad` through the JAX wrappers' custom VJPs;
  - `generate_scst` on the cached and the recompute path, with JAX's
    sampled tokens injected: each step's logp against JAX's under the same
    key, zero after [SEP], and the REINFORCE gradient of the BERT
    parameters for fixed advantages against `jax.grad`;
  - the full-softmax sampler's frequencies against the softmax;
  - the task groups and the refusals; the fp32-output product's backward.
`make_scst_step` against JAX's and the CLI on an `scst%tv` corpus are
`tests/test_torch_scst_step.py`'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu import generation as jgen
from mico_tpu.ops import flash_attention as jfa
from mico_tpu_torch import generation as tgen
from mico_tpu_torch.config import BERT_PAD_ID, BERT_SEP_ID
from mico_tpu_torch.ops import flash_attention as tfa
from mico_tpu_torch.ops import layers as tlayers
from mico_tpu_torch.train import scst

from torch_port_common import MODEL_TOL, close, decoder_setup, no_launch, t

ROUTE_TOL = dict(rtol=1e-4, atol=1e-5)


class TokStub:
    """Decodes ids as their numbers up to [SEP] or [PAD]: a tokenizer both
    packages' steps can share (tests/test_training.py's `_TokStub`)."""

    def batch_decode(self, rows):
        out = []
        for row in np.asarray(rows):
            words = []
            for tok in row[1:]:
                if tok in (BERT_PAD_ID, BERT_SEP_ID):
                    break
                words.append(str(int(tok)))
            out.append(" ".join(words))
        return out


# ---------------------------------------------------------------------------
# the differentiated routes of K1, K5 and K8
# ---------------------------------------------------------------------------


def _route_inputs(seed, b, l, nh, d):
    rng = np.random.default_rng(seed)
    w = nh * d
    f = np.float32
    return dict(
        x=rng.standard_normal((b, l, w)).astype(f),
        g=(1.0 + 0.1 * rng.standard_normal(w)).astype(f),
        b0=(0.1 * rng.standard_normal(w)).astype(f),
        w=(0.05 * rng.standard_normal((w, 3 * w))).astype(f),
        bias=(0.05 * rng.standard_normal(3 * w)).astype(f),
        wp=(0.05 * rng.standard_normal((w, w))).astype(f),
        bp=(0.05 * rng.standard_normal(w)).astype(f),
        cot=rng.standard_normal((b, l, w)).astype(f))


ROUTES = {
    "K1": (("x", "g", "b0", "w", "bias"),
           lambda m, a, nh, s, aff: m.fused_ln_qkv_self_attention(
               *a, nh, s, 1e-6, aff)),
    "K5": (("x", "w", "bias"),
           lambda m, a, nh, s, aff: m.fused_qkv_self_attention(*a, nh, s)),
    "K8": (("x", "w", "bias", "wp", "bp"),
           lambda m, a, nh, s, aff: m.fused_qkv_attn_proj(*a, nh, s)),
}


@pytest.mark.parametrize("kernel,affine,l", [
    ("K1", True, 17), ("K1", False, 17), ("K1", True, 50),
    ("K5", True, 17), ("K5", True, 50), ("K8", True, 17), ("K8", True, 50)])
def test_differentiated_routes_match_jax_grad(kernel, affine, l):
    """Under autograd the wrappers take their differentiated routes; the
    output and the gradient of every input equal `jax.grad` of the JAX
    wrappers (their custom VJPs: the unfused composition, K4's backward)
    on the same inputs, and nothing launches on the CPU."""
    names, call = ROUTES[kernel]
    nh, d = 2, 32
    a = _route_inputs(3, 2, l, nh, d)
    scale = d ** -0.5

    def jloss(*args):
        out = call(jfa, args, nh, scale, affine)
        return jnp.sum(out * a["cot"]), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True)(
        *[jnp.asarray(a[n]) for n in names])
    targs = [t(a[n]).requires_grad_(True) for n in names]
    out = no_launch(lambda: call(tfa, targs, nh, scale, affine))
    assert out.grad_fn is not None
    grads = torch.autograd.grad((out * t(a["cot"])).sum(), targs,
                                materialize_grads=True)
    close(out, jout, ROUTE_TOL)
    for n, got, want in zip(names, grads, jgrads):
        if kernel == "K1" and not affine and n in ("g", "b0"):
            assert not np.asarray(want).any() and not got.any(), n
            continue
        close(got, want, ROUTE_TOL)
    with torch.no_grad():
        close(call(tfa, targs, nh, scale, affine), jout, ROUTE_TOL)


# ---------------------------------------------------------------------------
# generate_scst
# ---------------------------------------------------------------------------


# added to [SEP]'s MLM bias on top of `decoder_setup`'s: under the whole
# softmax over 30522 tokens rows then end inside an 8-step decode
SCST_SEP_BIAS = 8.0


@pytest.fixture(scope="module")
def decoders():
    jparams, jcfg, model, cond = decoder_setup()
    head = dict(jparams["mlm_head"])
    head["decoder_b"] = head["decoder_b"].at[BERT_SEP_ID].add(SCST_SEP_BIAS)
    with torch.no_grad():
        model.mlm_head.get("decoder_b")[BERT_SEP_ID] += SCST_SEP_BIAS
    return dict(jparams, mlm_head=head), jcfg, model, cond


def _jax_scst(decoders, key=5, max_new=8):
    jparams, jcfg, _, cond = decoders
    return jgen.generate_scst(jparams, jcfg, jnp.asarray(cond),
                              max_new_tokens=max_new,
                              rng=jax.random.PRNGKey(key), use_cache=True)


@pytest.mark.parametrize("use_cache", [True, False],
                         ids=["cached", "recompute"])
def test_generate_scst_logp_matches_jax(decoders, use_cache):
    """JAX's sampled tokens committed through `tokens=`: the port's per-step
    logp equals JAX's `generate_scst` under the same key within 1e-5, on
    both paths, and is 0 after [SEP]; the tokens come back unchanged."""
    jparams, jcfg, model, cond = decoders
    jtok, jlogp = _jax_scst(decoders)
    jtok_r, jlogp_r = jgen.generate_scst(
        jparams, jcfg, jnp.asarray(cond), max_new_tokens=8,
        rng=jax.random.PRNGKey(5), use_cache=False)
    np.testing.assert_array_equal(np.asarray(jtok_r), np.asarray(jtok))
    tok, logp = no_launch(lambda: tgen.generate_scst(
        model, t(cond), max_new_tokens=8, use_cache=use_cache,
        tokens=t(np.asarray(jtok)).long()))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert logp.shape == (4, 8) and logp.dtype == torch.float32
    close(logp, jlogp, dict(rtol=0, atol=1e-5))
    finished = False
    for row, lp in zip(tok.numpy(), logp.detach().numpy()):
        sep = np.flatnonzero(row == BERT_SEP_ID)
        if sep.size:
            finished = True
            assert (lp[sep[0]:] == 0).all() and (lp[:sep[0]] < 0).all()
    assert finished          # some row ends inside the decode


def test_generate_scst_draws_and_modes(decoders):
    """A free draw: the cached and recompute paths draw the same tokens from
    equally seeded generators with the same logp; `generate(mode="scst")`
    returns those tokens; the logp of a drawn token is its log softmax."""
    _, _, model, cond = decoders
    c = t(cond)

    def gen():
        return torch.Generator().manual_seed(4)

    tok, logp = tgen.generate_scst(model, c, max_new_tokens=8,
                                   generator=gen(), use_cache=True)
    tok_r, logp_r = tgen.generate_scst(model, c, max_new_tokens=8,
                                       generator=gen(), use_cache=False)
    assert torch.equal(tok, tok_r)
    close(logp_r, logp.detach().numpy(), MODEL_TOL)
    assert torch.equal(tgen.generate(model, c, max_new_tokens=8, mode="scst",
                                     generator=gen()), tok)
    with torch.no_grad():
        _, logits = tgen.cached_generate(model, c, max_new_tokens=8,
                                         teacher_tokens=tok[:, 1:],
                                         return_logits=True)
    want = torch.log_softmax(logits, -1).gather(2, tok[:, 1:, None])[..., 0]
    live = torch.cat([torch.ones(4, 1, dtype=torch.bool),
                      (tok[:, 1:-1] != BERT_SEP_ID).cumprod(1).bool()], 1)
    close(logp, torch.where(live, want, 0.0).numpy(), MODEL_TOL)


@pytest.mark.parametrize("grad_mode,cond_grad,param_grad,want", [
    (False, True, True, False), (True, False, False, False),
    (True, True, False, True), (True, False, True, True)],
    ids=["no_grad", "nothing_wanted", "cond", "param"])
def test_cached_decode_records_only_a_wanted_gradient(
        decoders, monkeypatch, grad_mode, cond_grad, param_grad, want):
    """The cached decode takes its out-of-place cache writes only when
    autograd records it: grad mode on and the condition or a decoder
    parameter requiring a gradient (a frozen decoder under grad mode keeps
    the in-place buffers); decided once a call, with the same tokens."""
    _, _, model, cond = decoders
    seen = []
    step = tgen._cached_layer_step

    def spy(*a, record=False, **kw):
        seen.append(record)
        return step(*a, record=record, **kw)

    monkeypatch.setattr(tgen, "_cached_layer_step", spy)
    with torch.no_grad():
        base = tgen.cached_generate(model, t(cond), max_new_tokens=4)
    seen.clear()
    w = model.mlm_head.get("decoder_b")
    try:
        w.requires_grad_(param_grad)
        with torch.set_grad_enabled(grad_mode):
            tok = tgen.cached_generate(
                model, t(cond).requires_grad_(cond_grad), max_new_tokens=4)
    finally:
        w.requires_grad_(False)
    assert seen == [want] * (4 * len(model.layers))
    assert torch.equal(tok, base)


@pytest.mark.parametrize("use_cache", [True, False],
                         ids=["cached", "recompute"])
def test_reinforce_gradient_matches_jax(decoders, use_cache):
    """−mean(adv · Σ logp) for fixed advantages: the gradient of every BERT
    parameter equals `jax.grad` (JAX re-draws the trajectory under its key;
    the port scores JAX's tokens)."""
    jparams, jcfg, model, cond = decoders
    jtok, _ = _jax_scst(decoders, key=9, max_new=6)
    adv = np.array([1.0, -0.5, 0.25, 2.0], np.float32)

    def jloss(p):
        _, lp = jgen.generate_scst(p, jcfg, jnp.asarray(cond),
                                   max_new_tokens=6,
                                   rng=jax.random.PRNGKey(9),
                                   use_cache=use_cache)
        return -jnp.mean(jnp.asarray(adv) * lp.sum(-1))

    jloss_v, jgrad = jax.jit(jax.value_and_grad(jloss))(jparams)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
        p.grad = None
    try:
        _, logp = tgen.generate_scst(model, t(cond), max_new_tokens=6,
                                     use_cache=use_cache,
                                     tokens=t(np.asarray(jtok)).long())
        loss = -(t(adv) * logp.sum(-1)).mean()
        loss.backward()
        close(loss, float(jloss_v), MODEL_TOL)
        moved = 0.0
        for name, p in named.items():
            parts = name.split(".")
            if parts[0] == "layers":     # JAX stacks the layers' leaves
                want = jgrad["layers"][parts[2]][int(parts[1])]
            else:
                want = jgrad[parts[0]][parts[1]]
            close(p.grad, want, dict(rtol=1e-4, atol=1e-6))
            moved = max(moved, float(p.grad.abs().max()))
        assert moved > 1e-2
    finally:
        for p in named.values():
            p.requires_grad_(False)
            p.grad = None


def test_scst_sampler_follows_the_softmax():
    """Draws over the whole softmax of a fixed logit vector (a token far
    outside any top-k included) land with the softmax's frequencies."""
    logits = torch.tensor([[2.0, 0.5, -1.0, 1.0, 0.0, -3.0, 1.5, -0.5]])
    n = 40000
    draws = tgen._next_token(logits.expand(n, -1), "scst", 10,
                             torch.Generator().manual_seed(0))
    freq = torch.bincount(draws, minlength=8).double() / n
    p = torch.softmax(logits[0].double(), -1)
    sigma = (p * (1 - p) / n).sqrt()
    assert ((freq - p).abs() <= 5 * sigma + 1e-4).all(), (freq, p)
    assert freq[5] > 0                       # the tail is drawn too


def test_scst_groups_and_refusals():
    assert scst._groups("scst%tv") == ["v"]
    assert scst._groups("scst%tv%tva") == ["v", "va"]
    with pytest.raises(ValueError, match="not an scst task"):
        scst._groups("cap%tv")
    # K7 still has no backward
    from mico_tpu_torch.ops import int8_attention as ti8

    q = torch.randn(1, 2, 128, requires_grad=True)
    k8, ks = ti8.quantize_kv(torch.randn(1, 7, 128), 2)
    with pytest.raises(RuntimeError, match="K7.*no backward"):
        ti8.int8_cross_attention(q, k8, ks, k8, ks, 2)


def test_fp32_scores_backward(monkeypatch):
    """The card's differentiable q·kᵀ with an fp32 output
    (`ops/layers._MatmulF32`, whose forward is CUDA's bf16 product with an
    fp32 result, as the decoder's scores take it) has the gradient of the
    fp32 product of the same bf16 values, rounded to the operands' dtype;
    here its forward runs that fp32 product."""
    monkeypatch.setattr(tlayers, "_mm_out_f32", lambda a, b: torch.matmul(
        a.float(), b.float()))
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 3, 2, 8, generator=g).bfloat16().requires_grad_(True)
    k = torch.randn(2, 3, 9, 8, generator=g).bfloat16().requires_grad_(True)
    cot = torch.randn(2, 3, 2, 9, generator=g)
    s = tlayers._MatmulF32.apply(q, k.transpose(-1, -2))
    assert s.dtype == torch.float32
    dq, dk = torch.autograd.grad((s * cot).sum(), (q, k))
    qf, kf = (x.detach().float().requires_grad_(True) for x in (q, k))
    want_q, want_k = torch.autograd.grad(
        (torch.matmul(qf, kf.transpose(-1, -2)) * cot).sum(), (qf, kf))
    assert dq.dtype == dk.dtype == torch.bfloat16
    torch.testing.assert_close(dq, want_q.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(dk, want_k.bfloat16(), rtol=0, atol=0)
