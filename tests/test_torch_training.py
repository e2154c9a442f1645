"""The port's training (`mico_tpu_torch/train/`) against `mico_tpu.train`
on the CPU at the tiny fp32 config: `task_losses` values and gradients for
'ret%tva_cap%tva' and 'qa%tv' with JAX's own draws injected, the masker
contract, the schedules, the param groups, three AdamW updates against the
optax chain, a descending step, the long-context caption loss on the
KV-tiled route (K6, K6b); and the repairs: K7 refuses to run under
autograd, K2 has the gradient of `_flash_diff`."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mico_tpu.ops import flash_attention as jfa
from mico_tpu.train import masker as jmasker
from mico_tpu.train import objectives as jobj
from mico_tpu.train import optim as joptim
from mico_tpu.train import sched as jsched
from mico_tpu_torch.config import BERT_MASK_ID
from mico_tpu_torch.convert import params_from_jax
from mico_tpu_torch.models.mico import MiCo
from mico_tpu_torch.ops import flash_attention as tfa
from mico_tpu_torch.ops import int8_attention as ti8
from mico_tpu_torch.ops import layers as tlayers
from mico_tpu_torch.train import masker, objectives, optim, sched
from mico_tpu_torch.train.train_step import make_train_step

from torch_port_common import MODEL_TOL, OP_TOL, close, configs, \
    no_launch, perturbed_params, port_model, replace, t, to_numpy

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _batch(rng, b, frames, size, cap_len=12):
    ids = rng.integers(200, 20000, (b, cap_len)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((b, cap_len), np.int32)
    mask[1, cap_len - 3:] = 0
    ids[1, cap_len - 3:] = 0
    qmask = np.ones((b, 10), np.int32)
    qmask[0, 8:] = 0
    amask = np.ones((b, 6), np.int32)
    amask[2 % b, 4:] = 0
    return {
        "vision_pixels": rng.standard_normal(
            (b, frames, 3, size, size)).astype(np.float32),
        "audio_spectrograms": rng.standard_normal(
            (b, 2, size, size)).astype(np.float32),
        "caption_ids": ids, "caption_mask": mask,
        "question_ids": rng.integers(200, 20000, (b, 10)).astype(np.int32),
        "question_mask": qmask,
        "answer_ids": rng.integers(200, 20000, (b, 6)).astype(np.int32),
        "answer_mask": amask,
    }


def _torch_batch(batch):
    return {k: t(v) if v.dtype == np.float32 else t(v).long()
            for k, v in batch.items()}


@pytest.mark.parametrize("task,size,frames", [
    ("ret%tva_cap%tva", 28, 2),
    # 4 frames at 112 px: 260 condition tokens, so the QA cross-attention
    # (16 x 260 > 4096) takes K2 and its backward
    ("qa%tv", 112, 4),
])
def test_task_losses_and_grads_match_jax(monkeypatch, task, size, frames):
    jcfg, tcfg = configs(eva=dict(image_size=size), bert=NO_DROPOUT)
    params = perturbed_params(jcfg, seed=1)
    batch = _batch(np.random.default_rng(5), 3, frames, size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(4)

    # JAX's own draws, recorded in a forward-only call: the wrappers collect
    # the draws, which the jitted call returns beside the losses
    masks, cats = [], []
    with monkeypatch.context() as m:
        real_mask, real_cat = jobj.mask_tokens, jax.random.categorical

        def record_mask(*a, **kw):
            out = real_mask(*a, **kw)
            masks.append(out)
            return out

        def record_cat(*a, **kw):
            out = real_cat(*a, **kw)
            cats.append(out)
            return out

        m.setattr(jobj, "mask_tokens", record_mask)
        m.setattr(jax.random, "categorical", record_cat)
        want, masks, cats = jax.jit(lambda p: (
            jobj.task_losses(key, p, jcfg, jbatch, task), masks, cats))(params)
    want_grads = jax.jit(jax.grad(lambda p: sum(
        jobj.task_losses(key, p, jcfg, jbatch, task).values())))(params)

    model = port_model(params, tcfg).requires_grad_(True)
    draws = objectives.Draws(
        masks=[tuple(t(np.asarray(x)) for x in pair) for pair in masks],
        negatives=[(t(np.asarray(cats[i])), t(np.asarray(cats[i + 1])))
                   for i in range(0, len(cats), 2)])
    got = objectives.task_losses(model, tcfg, _torch_batch(batch), task,
                                 torch.Generator().manual_seed(0),
                                 draws=draws)
    assert sorted(got) == sorted(want) and not draws.masks \
        and not draws.negatives
    for name in want:
        close(got[name], want[name], dict(rtol=1e-5, atol=1e-6))
    sum(got.values()).backward()
    sd = params_from_jax(to_numpy(want_grads), tcfg)
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        close(g, sd[name], MODEL_TOL)


@pytest.fixture
def kv_tiled_at_tiny(monkeypatch):
    """Both packages take the KV-tiled route (K6, K6b) at the tiny config:
    a resident cliff of 256 keys under the 260 condition tokens of 4 frames
    at 112 px, and a KV_TILED_MIN_Q of 16 query rows. JAX reads both at
    trace time, so compiled programs are dropped before and after."""
    jax.clear_caches()
    for mod in (jfa, tfa):
        monkeypatch.setattr(mod, "MAX_RESIDENT_KV", 256)
        monkeypatch.setattr(mod, "KV_TILED_MIN_Q", 16)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("grad", [True, False])
def test_long_context_caption_matches_jax(monkeypatch, kv_tiled_at_tiny,
                                          grad):
    """Long-context captioning at the tiny config: 'cap%tv' with 16-token
    captions over 260 condition tokens, the cross-attention (16 x 260 >
    64 x 64) on the KV-tiled route in both packages (the Pallas kernels in
    interpret mode, the port's K6/K6b plain twins). With JAX's mask draws
    injected the loss equals JAX's and, under autograd, so do the
    gradients; each layer runs K6 with LSE and K6b once. The no-grad
    forward runs K6 without LSE and no K6b."""
    task, size, frames = "cap%tv", 112, 4
    jcfg, tcfg = configs(eva=dict(image_size=size), bert=NO_DROPOUT)
    params = perturbed_params(jcfg, seed=6)
    batch = _batch(np.random.default_rng(8), 3, frames, size, cap_len=16)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(5)
    jax_calls = []     # JAX's KV-tiled entries, each time one is traced
    for name in ("_flash_kv_tiled", "_flash_kv_tiled_stats",
                 "_flash_kv_tiled_bwd"):
        def jspy(*a, _real=getattr(jfa, name), _name=name, **kw):
            jax_calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(jfa, name, jspy)
    masks = []
    with monkeypatch.context() as m:
        real_mask = jobj.mask_tokens
        m.setattr(jobj, "mask_tokens",
                  lambda *a, **kw: masks.append(real_mask(*a, **kw))
                  or masks[-1])
        want, masks = jax.jit(lambda p: (
            jobj.task_losses(key, p, jcfg, jbatch, task), masks))(params)

    calls = []
    for name, tag in (("kv_tiled_attention_plain", "K6"),
                      ("kv_tiled_attention_bwd_plain", "K6b")):
        def spy(*a, _real=getattr(tfa, name), _tag=tag, **kw):
            calls.append(_tag + ("+lse" if len(a) > 5 and a[5] is True
                                 else ""))
            return _real(*a, **kw)
        monkeypatch.setattr(tfa, name, spy)
    model = port_model(params, tcfg).requires_grad_(grad)
    draws = objectives.Draws(
        masks=[tuple(t(np.asarray(x)) for x in pair) for pair in masks])
    nl = tcfg.bert_config.num_hidden_layers
    with torch.set_grad_enabled(grad):
        got = no_launch(lambda: objectives.task_losses(
            model, tcfg, _torch_batch(batch), task,
            torch.Generator().manual_seed(0), draws=draws))
    assert sorted(got) == sorted(want) == ["loss_cap"] and not draws.masks
    close(got["loss_cap"], want["loss_cap"], dict(rtol=1e-5, atol=1e-6))
    if not grad:
        assert calls == ["K6"] * nl
        assert set(jax_calls) == {"_flash_kv_tiled"}
        return
    assert calls == ["K6+lse"] * nl
    no_launch(lambda: got["loss_cap"].backward())
    assert calls == ["K6+lse"] * nl + ["K6b"] * nl
    want_grads = jax.jit(jax.grad(lambda p: jobj.task_losses(
        key, p, jcfg, jbatch, task)["loss_cap"]))(params)
    assert set(jax_calls) == {"_flash_kv_tiled", "_flash_kv_tiled_stats",
                              "_flash_kv_tiled_bwd"}
    sd = params_from_jax(to_numpy(want_grads), tcfg)
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        close(g, sd[name], MODEL_TOL)


def test_masker_contract():
    rng = np.random.default_rng(0)
    toks = rng.integers(200, 20000, (4, 16))
    toks[:, 0] = 101
    toks[:, -3:] = 0
    toks = t(toks).long()
    out, labels = masker.mask_tokens(toks, 0.6, torch.Generator().manual_seed(1))
    assert (labels[:, 0] == -100).all() and (labels[:, -3:] == -100).all()
    assert ((labels != -100).sum(dim=1) > 0).all()
    m = labels != -100
    assert torch.equal(labels[m], toks[m])
    assert torch.equal(out[~m], toks[~m])
    # [MASK] for about 80% of the masked positions, random ids in range
    changed = out[m]
    assert (changed == BERT_MASK_ID).float().mean() > 0.5
    assert ((changed == BERT_MASK_ID)
            | ((changed >= 106) & (changed < 30522))).all()
    # a row with no draw under p gets exactly one forced masked position,
    # a valid one; an all-pad row gets none
    toks[3, 1:] = 0
    out, labels = masker.mask_tokens(toks, 1e-9, torch.Generator().manual_seed(2))
    n = (labels != -100).sum(dim=1)
    assert n.tolist() == [1, 1, 1, 0]
    assert (labels[:, 0] == -100).all() and (labels[:, -3:] == -100).all()
    # recorded draws pass through
    drawn = (out, labels)
    got = masker.mask_tokens(toks, 0.6, None, drawn=drawn)
    assert all(torch.equal(a, b) for a, b in zip(got, drawn))


@pytest.mark.parametrize("name", ["warmup_linear", "warmup_cosine",
                                  "warmup_constant"])
def test_schedules_match_jax(name):
    for step in (0, 3, 9, 10, 11, 57, 100):
        want = float(jsched.lr_schedule_ratio(step, 100, 0.1, name))
        got = sched.lr_schedule_ratio(step, 100, 0.1, name)
        assert abs(got - want) < 1e-6, (step, got, want)


def test_param_group_labels_match_jax():
    jcfg, tcfg = configs()
    params = perturbed_params(jcfg)
    model = port_model(params, tcfg)
    kw = dict(new_params_name=("contra_head", "itm"),
              frozen_prefixes=("depth_frame_embedding",))
    jl = joptim.param_group_labels(params, **kw)
    labels = optim.param_group_labels(model, **kw)
    flat = {".".join(joptim._path_names(path)): lab
            for path, lab in jax.tree_util.tree_leaves_with_path(jl)}
    assert {optim.jax_path(n) for n in labels} == {
        tuple(k.split(".")) for k in flat}
    for name, lab in labels.items():
        assert lab == flat[".".join(optim.jax_path(name))], name
    assert labels["vision_encoder.blocks.1.qkv_w"] == "vision"
    assert labels["bert.layers.0.q_b"] == "basic_nd"
    assert labels["contra_head_v.kernel"] == "new"
    assert labels["depth_frame_embedding"] == "frozen"


def test_optimizer_matches_optax():
    """Three updates with the same synthetic gradients, clipped every time,
    one frozen prefix, the warmup's zero first rate: the port's parameters
    equal the optax chain's."""
    jcfg, tcfg = configs()
    params = perturbed_params(jcfg, seed=2)
    oc = dict(learning_rate=3e-2, clip_lr=1e-2, new_lr=5e-2,
              new_params_name=("contra_head",), frozen_prefixes=("itm_head",),
              num_train_steps=4, warmup_ratio=0.3)
    rng = np.random.default_rng(3)
    np_grads = jax.tree.map(
        lambda a: (3.0 * rng.standard_normal(a.shape)).astype(np.float32),
        to_numpy(params))
    labels = joptim.param_group_labels(params, oc["new_params_name"],
                                       oc["frozen_prefixes"])
    norm = float(np.sqrt(sum(
        float(np.sum(np.square(g))) for g, lab in zip(
            jax.tree.leaves(np_grads), jax.tree.leaves(labels))
        if lab != "frozen")))
    assert norm > 2.0       # the clip triggers
    opt = joptim.build_optimizer(params, joptim.OptimConfig(**oc))
    grads = jax.tree.map(jnp.asarray, np_grads)

    @jax.jit
    def update(state, p):
        updates, state = opt.update(grads, state, p)
        return state, optax.apply_updates(p, updates)

    state, p = opt.init(params), params
    for _ in range(3):
        state, p = update(state, p)

    model = port_model(params, tcfg)
    topt = optim.build_optimizer(model, optim.OptimConfig(**oc))
    assert not model._modules["itm_head"].fc1_w.requires_grad
    tgrads = params_from_jax(np_grads, tcfg)
    named = dict(model.named_parameters())
    for _ in range(3):
        topt.zero_grad()
        for name, prm in named.items():
            prm.grad = tgrads[name].clone()
        got_norm = topt.clip_()
        topt.step()
        assert abs(got_norm.item() - norm) < 1e-4 * norm
    want = params_from_jax(to_numpy(p), tcfg)
    for name, prm in named.items():
        close(prm.detach(), want[name], dict(rtol=1e-6, atol=1e-6))


def test_train_step_descends():
    """Ten steps on one batch with the same draws each step lower the
    total by more than 0.3 (tests/test_training.py:100-115)."""
    _, tcfg = configs(max_vision_sample_num=2)
    model = MiCo(tcfg, device="cpu", seed=0)
    opt = optim.build_optimizer(model, optim.OptimConfig(
        learning_rate=1e-3, clip_lr=1e-3, num_train_steps=100,
        warmup_ratio=0.01))
    step = make_train_step(tcfg, opt, "cap%tv")
    batch = _torch_batch(_batch(np.random.default_rng(0), 8, 2, 28))
    vals = [step(model, batch, torch.Generator().manual_seed(2))[
        "loss_total"].item() for _ in range(10)]
    assert vals[-1] < vals[0] - 0.3, vals


def test_train_step_matches_jax(monkeypatch):
    """Three updates of the port's `make_train_step` and of
    `mico_tpu.train.train_step.make_train_step` from the same params and
    batch, with JAX's draws of each step recorded and injected: the losses
    and then the parameters agree after every update. Adam's eps is raised
    to 1e-3 so that the update is not scale-free: the clip on the total
    (which triggers) then shows in it, and gradients that are zero up to
    rounding (BERT's key bias) move nothing. The large weight decay shows
    that unused parameters are decayed as JAX's dense zero gradients decay
    them; the warm-up gives the first update a zero learning rate."""
    task = "ret%tva_cap%tva"
    jcfg, tcfg = configs(bert=NO_DROPOUT)
    params = perturbed_params(jcfg, seed=3)
    batch = _batch(np.random.default_rng(7), 3, 2, 28)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    oc = dict(learning_rate=1e-2, clip_lr=5e-3, new_lr=2e-2,
              new_params_name=("contra_head",), weight_decay=0.5, eps=1e-3,
              grad_norm=0.5, num_train_steps=4, warmup_ratio=0.3)
    from mico_tpu.train import train_step as jtrain_step

    jopt = joptim.build_optimizer(params, joptim.OptimConfig(**oc))
    jstep = jtrain_step.make_train_step(jcfg, jopt, task, donate=False)
    masks, cats = [], []
    with monkeypatch.context() as m:
        real_mask, real_cat = jobj.mask_tokens, jax.random.categorical
        m.setattr(jobj, "mask_tokens",
                  lambda *a, **kw: masks.append(real_mask(*a, **kw))
                  or masks[-1])
        m.setattr(jax.random, "categorical",
                  lambda *a, **kw: cats.append(real_cat(*a, **kw)) or cats[-1])
        record = jax.jit(lambda p, k: (
            jobj.task_losses(k, p, jcfg, jbatch, task), masks, cats))
        record(params, jax.random.PRNGKey(0))

    model = port_model(params, tcfg)
    topt = optim.build_optimizer(model, optim.OptimConfig(**oc))
    step = make_train_step(tcfg, topt, task)
    tbatch = _torch_batch(batch)
    state, p0 = jopt.init(params), to_numpy(params)
    moved = 0.0
    for i in range(3):
        key = jax.random.PRNGKey(i)
        _, jmasks, jcats = record(params, key)
        draws = objectives.Draws(
            masks=[tuple(t(np.asarray(x)) for x in pair) for pair in jmasks],
            negatives=[(t(np.asarray(jcats[j])), t(np.asarray(jcats[j + 1])))
                       for j in range(0, len(jcats), 2)])
        params, state, want = jstep(params, state, jbatch, key)
        got = step(model, tbatch, torch.Generator().manual_seed(i),
                   draws=draws)
        assert not draws.masks and not draws.negatives
        assert got["grad_norm"].item() > oc["grad_norm"]      # the clip
        for name in want:
            close(got[name], want[name], dict(rtol=1e-5, atol=1e-6))
        sd = params_from_jax(to_numpy(params), tcfg)
        for name, prm in model.named_parameters():
            close(prm.detach(), sd[name], MODEL_TOL)
        moved = max(moved, max(float(np.abs(a - b).max()) for a, b in zip(
            jax.tree.leaves(to_numpy(params)), jax.tree.leaves(p0))))
        if i == 0:
            assert moved == 0.0          # the warm-up's zero rate
    assert moved > 100 * MODEL_TOL["atol"]


def test_train_step_raises_on_non_finite_loss():
    _, tcfg = configs(max_vision_sample_num=2)
    model = MiCo(tcfg, device="cpu", seed=0)
    opt = optim.build_optimizer(model, optim.OptimConfig(num_train_steps=10))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.contra_temp.fill_(0.0)        # similarity / 0
    before["contra_temp"] = model.contra_temp.detach().clone()
    step = make_train_step(tcfg, opt, "ret%tv")
    batch = _torch_batch(_batch(np.random.default_rng(0), 3, 2, 28))
    with pytest.raises(FloatingPointError, match="non-finite"):
        step(model, batch, torch.Generator().manual_seed(0))
    assert opt.count == 0
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    # the step's ZeRO-1 flag must be the optimizer's state layout
    with pytest.raises(ValueError, match="zero1"):
        make_train_step(tcfg, opt, "ret%tv", zero1=True)
    # sequence parallelism over the condition tokens: on a model axis of 1
    # it changes nothing, as JAX's constraint on a 1-wide axis does not
    with torch.no_grad():
        plain = objectives.compute_features(model, tcfg, batch, "v")
        sp = objectives.compute_features(
            model, replace(tcfg, shard_condition_sequence=True), batch, "v")
    assert plain.keys() == sp.keys()
    for k in plain:
        assert torch.equal(plain[k], sp[k]), k


def test_causal_masks_match_jax():
    rng = np.random.default_rng(0)
    qm = (rng.random((3, 6)) > 0.3).astype(np.int32)
    am = (rng.random((3, 4)) > 0.3).astype(np.int32)
    np.testing.assert_array_equal(
        objectives.part_causal_3d_mask(t(qm), t(am)).numpy(),
        np.asarray(jobj.part_causal_3d_mask(jnp.asarray(qm), jnp.asarray(am))))
    np.testing.assert_array_equal(
        objectives.causal_3d_mask(t(qm)).numpy(),
        np.asarray(jobj.causal_3d_mask(jnp.asarray(qm))))


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------


def test_k1_and_k7_refuse_autograd():
    """K7 has no backward and refuses a call that autograd records; K1
    takes its differentiated route there (LayerNorm, then K5's route: the
    projection and K3, K4 in the backward), whose output and gradient are
    autograd's of that plain composition (`ops/layers.layer_norm`, the
    projection, the packed attention's plain twin; not K1's plain twin,
    whose rounding points are the fused kernel's). The weights take the
    1/sqrt(fan-in) scale: with unit-std weights the scores saturate the
    softmax, the input gradient reaches 1e3, and its small elements sit
    below both routes' fp32 error (each ~1e-6 of the largest against fp64)
    at rtol 1e-4."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 5, 16, generator=gen).requires_grad_(True)
    w = torch.randn(16, 48, generator=gen) * 16 ** -0.5
    bias = torch.zeros(48)
    out = no_launch(lambda: tfa.fused_ln_qkv_self_attention(
        x, None, None, w, bias, 2, 0.25, 1e-6, False))
    (gx,) = torch.autograd.grad(out.square().sum(), x)
    xr = x.detach().requires_grad_(True)
    qkv = (tlayers.layer_norm(xr, None, None, 1e-6) @ w + bias)
    ref = tfa.packed_attention_plain(*qkv.chunk(3, dim=-1), 2, 0.25)
    (want,) = torch.autograd.grad(ref.square().sum(), xr)
    torch.testing.assert_close(out.detach(), ref.detach(), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(gx, want, rtol=1e-4, atol=1e-6)
    with torch.no_grad():
        tfa.fused_ln_qkv_self_attention(x, None, None, w, bias, 2, 0.25,
                                        1e-6, False)
    q = torch.randn(1, 2, 128, requires_grad=True)
    k8, ks = ti8.quantize_kv(torch.randn(1, 7, 128), 2)
    with pytest.raises(RuntimeError, match="K7.*no backward"):
        ti8.int8_cross_attention(q, k8, ks, k8, ks, 2)
    with torch.no_grad():
        ti8.int8_cross_attention(q, k8, ks, k8, ks, 2)


@pytest.mark.parametrize("with_bias", [False, True])
def test_k2_gradient_matches_jax(with_bias):
    rng = np.random.default_rng(4)
    b, h, lq, lk, d = 2, 3, 30, 257, 32
    q, k, v, w = (rng.standard_normal(s).astype(np.float32) for s in (
        (b, h, lq, d), (b, h, lk, d), (b, h, lk, d), (b, h, lq, d)))
    bias = None
    if with_bias:
        keep = rng.random((b, 1, lq, lk)) > 0.3
        bias = ((1.0 - keep) * -10000.0 + 0.1 * rng.standard_normal(
            keep.shape)).astype(np.float32)

    def loss(q, k, v, bias):
        out = jfa.flash_attention(q, k, v, bias=bias, interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    jargs = [jnp.asarray(a) for a in (q, k, v)] + [
        None if bias is None else jnp.asarray(bias)]
    want = jax.grad(loss, argnums=(0, 1, 2, 3) if with_bias else (0, 1, 2))(
        *jargs)
    xs = [t(a).requires_grad_(True) for a in (q, k, v)]
    tb = None if bias is None else t(bias).requires_grad_(True)
    out = no_launch(lambda: tfa.flash_attention(*xs, bias=tb))
    (out * t(w)).sum().backward()
    for x, g in zip(xs + ([tb] if with_bias else []), want):
        close(x.grad, g, OP_TOL)


def test_workload_batch_and_flops():
    """The synthetic pretraining batch has the recipe's shapes, and the
    port's copy of `mix_train_flops` gives what scripts/train_bench.py's
    gives for one step at B = 8 (82184089042944, computed there)."""
    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.train.workload import pretrain_step_flops, \
        synthetic_batch

    batch = synthetic_batch(3, size=28, device="cpu")
    assert batch["vision_pixels"].shape == (3, 4, 3, 28, 28)
    assert batch["audio_spectrograms"].shape == (3, 2, 28, 28)
    assert batch["caption_ids"].shape == batch["caption_mask"].shape == (3, 40)
    assert (batch["caption_ids"][:, 0] == 101).all()
    assert batch["caption_mask"].sum(dim=1).tolist() == [30, 40, 40]
    assert pretrain_step_flops(MiCoConfig(), 8) == 82184089042944


def test_long_context_workload():
    """The long-context sample of `train_bench.py --long-context`: 32
    frames, 128-token captions, no audio; the port's FLOPs for one 'cap%tv'
    step at B = 2 equal that script's `mix_train_flops` (104243832029184,
    computed there)."""
    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.train import workload as wl

    batch = wl.long_context_batch(2, size=28, device="cpu")
    assert sorted(batch) == ["caption_ids", "caption_mask", "vision_pixels"]
    assert batch["vision_pixels"].shape == (2, 32, 3, 28, 28)
    assert batch["caption_ids"].shape == (2, 128)
    cfg = MiCoConfig(max_vision_sample_num=32, max_caption_len=128)
    assert wl.pretrain_step_flops(
        cfg, 2, wl.LONG_CONTEXT_FRAMES, 0, wl.LONG_CONTEXT_CAPTION_LEN,
        wl.LONG_CONTEXT_TASK) == 104243832029184


def test_itm_dedup_cross_kv_equivalence():
    """ITM with the cross-K/V projected once per unique condition row and
    gathered per query row is the same math as the 3 x bs duplicated
    projections (tests/test_training.py:507-550): loss and gradients."""
    _, tcfg = configs(bert=NO_DROPOUT)
    model = MiCo(tcfg, device="cpu", seed=0).requires_grad_(True)
    rng = np.random.default_rng(3)
    cond = t(rng.standard_normal((4, 6, 64)).astype(np.float32))
    ids = t(rng.integers(200, 20000, (4, 12))).long()
    mask = torch.ones(4, 12, dtype=torch.long)
    sim = t(rng.standard_normal((4, 4)).astype(np.float32))
    negatives = (torch.tensor([2, 3, 0, 1]), torch.tensor([1, 0, 3, 2]))
    runs = []
    for dedup in (False, True):
        model.zero_grad()
        c = cond.clone().requires_grad_(True)
        loss = objectives.itm_loss(model, tcfg, c, ids, mask, sim, sim.T,
                                   train_rng=torch.Generator().manual_seed(0),
                                   dedup_cross_kv=dedup, negatives=negatives)
        loss.backward()
        runs.append((loss.item(), c.grad.clone(),
                     {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None}))
    assert abs(runs[0][0] - runs[1][0]) <= 1e-6 * abs(runs[0][0])
    torch.testing.assert_close(runs[1][1], runs[0][1], rtol=1e-4, atol=1e-6)
    assert runs[0][2].keys() == runs[1][2].keys()
    for name, g in runs[0][2].items():
        torch.testing.assert_close(runs[1][2][name], g, rtol=1e-4, atol=1e-6)


def test_compute_features_and_slice_scores_match_jax():
    """The fused 'vas' features (vision and audio towers, BERT's subtitle
    pass and the 3-way contra head) and the ITM slice scores, in
    evaluation, against JAX."""
    jcfg, tcfg = configs()
    params = perturbed_params(jcfg, seed=4)
    batch = _batch(np.random.default_rng(6), 2, 2, 28)
    sub = np.random.default_rng(7).integers(200, 20000, (2, 8)).astype(np.int32)
    batch.update(subtitle_ids=sub, subtitle_mask=np.ones((2, 8), np.int32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jobj.compute_features(params, jcfg, jbatch, "vas")
    model = port_model(params, tcfg)
    with torch.no_grad():
        got = objectives.compute_features(model, tcfg, _torch_batch(batch),
                                          "vas")
        assert sorted(got) == sorted(want)
        for k in want:
            close(got[k], want[k], MODEL_TOL)
        scores = objectives.compute_slice_scores(
            model, tcfg, got["condition_feats_vas"], t(batch["caption_ids"]).long(),
            t(batch["caption_mask"]).long())
    close(scores, jobj.compute_slice_scores(
        params, jcfg, want["condition_feats_vas"], jbatch["caption_ids"],
        jbatch["caption_mask"]), MODEL_TOL)
