"""MiCo with VAST's separate audio towers (`audio_encoder_type` "beats" or
"ast", `models/audio.py`) against `mico_tpu.models.mico` on the CPU in fp32:
audio tokens, pooled embeddings (BEATs by its token mean, AST by its CLS),
condition tokens and ITM; `compute_features`' fused 'va' feature; native
`.npz` checkpoints both ways (JAX's pickled list of layers included); the
released `.pt` loader's refusal; the optimizer groups of the tower's
leaves; the default VAST config at full width.

The tiny MiCo of `torch_port_common` with a 2-layer, 64-wide tower; audio
slices of 16 mel bins x 32 frames."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.models import audio as jaudio
from mico_tpu.models import mico as jm
from mico_tpu_torch import config as tconfig
from mico_tpu_torch import convert
from mico_tpu_torch.models import audio as taudio

from test_torch_audio_towers import _tower_params, tower_configs
from torch_port_common import MODEL_TOL, close, configs, perturbed_params, \
    port_model, t, to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MELBINS, TARGET = 16, 32


def mico_configs(kind: str, seed: int = 0):
    """(JAX cfg, port cfg) of the tiny MiCo with a `kind` tower."""
    jcfg, tcfg = configs()
    jt, tt = tower_configs(kind)
    kw = dict(audio_encoder_type=kind, audio_melbins=MELBINS,
              audio_target_length=TARGET)
    return (dataclasses.replace(jcfg, audio_override=jt, **kw),
            dataclasses.replace(tcfg, audio_override=tt, **kw))


@functools.lru_cache(maxsize=None)
def _shared_route_params():
    return perturbed_params(configs()[0], seed=4)


@pytest.fixture(scope="module", params=["beats", "ast"])
def audio_models(request):
    """The tiny MiCo with a `beats` or an `ast` tower: the shared route's
    perturbed params (the towers' width is the ViT's, so every head keeps
    its shape) with the tower's perturbed params as `audio_encoder`."""
    kind = request.param
    jcfg, tcfg = mico_configs(kind)
    params = dict(_shared_route_params(),
                  audio_encoder=_tower_params(kind, 5, ()))
    return params, jcfg, port_model(params, tcfg)


def test_mico_audio_tokens_embeddings_and_itm(rng, audio_models):
    params, jcfg, model = audio_models
    x = rng.standard_normal((2, 3, TARGET, MELBINS)).astype(np.float32)
    want = jax.jit(jm.forward_audio_encoder, static_argnums=1)(
        params, jcfg, jnp.asarray(x))
    got = model.forward_audio_encoder(t(x))
    per_slice = 2 if jcfg.audio_encoder_type == "beats" else 3
    assert got.shape == (2, 3, per_slice, 64)
    close(got, want, MODEL_TOL)
    jf = jm.contra_head(params["contra_head_a"],
                        jm.pool_audio_for_contra(jcfg, want))
    tf = model.contra_head("a", model.pool_audio_for_contra(got))
    close(tf, jf, MODEL_TOL)
    jcond = jm.get_multimodal_forward_input_audio(params, jcfg, want)
    cond = model.get_multimodal_forward_input_audio(got)
    assert cond.shape == (2, 3 * per_slice, 64)
    close(cond, jcond, MODEL_TOL)
    ids = rng.integers(200, 20000, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 7:] = 0
    jitm = jax.jit(lambda p, i, m, c: jm.itm_head(
        p, jm.forward_multimodal_encoder(p, jcfg, i, m, c)
        .sequence_output[:, 0]))(params, jnp.asarray(ids), jnp.asarray(mask),
                                 jcond)
    x_itm = model.forward_multimodal_encoder(t(ids), t(mask), cond)
    close(model.itm_head(x_itm[:, 0]), jitm, MODEL_TOL)


def test_objectives_pool_each_tower_by_its_rule(rng, audio_models):
    """`compute_features` (training and evaluation) pools BEATs by its
    token mean and AST by its CLS, as JAX's does: the fused 'va' feature
    and its condition tokens."""
    from mico_tpu.train import objectives as jobj
    from mico_tpu_torch.train import objectives as tobj

    params, jcfg, model = audio_models
    batch = {"vision_pixels": rng.standard_normal(
                 (2, 2, 3, 28, 28)).astype(np.float32),
             "audio_spectrograms": rng.standard_normal(
                 (2, 3, TARGET, MELBINS)).astype(np.float32)}
    want = jax.jit(jobj.compute_features, static_argnums=(1, 3))(
        params, jcfg, jax.tree.map(jnp.asarray, batch), "va")
    with torch.no_grad():
        got = tobj.compute_features(model, model.cfg,
                                    {k: t(v) for k, v in batch.items()}, "va")
    for key in ("feat_va", "condition_feats_va"):
        close(got[key], want[key], MODEL_TOL)


def test_mico_tower_npz_round_trips(tmp_path, audio_models):
    """A JAX-written native `.npz` (its list of layers pickled as an
    object array) loads into the port; the port's own file loads back into
    the same weights; `params_to_jax` gives JAX's tree, layers as a list."""
    from mico_tpu.train.checkpoints import save_pytree_npz
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.train import checkpoints as tck

    params, jcfg, model = audio_models
    tree = to_numpy(params)
    save_pytree_npz(str(tmp_path / "jax.npz"), tree)
    loaded = tck.load_pytree_npz(str(tmp_path / "jax.npz"))
    assert isinstance(loaded["audio_encoder"]["layers"], list)
    want_sd = model.state_dict()
    for source in (loaded, convert.params_to_jax(want_sd, model.cfg)):
        sd = convert.params_from_jax(source, model.cfg)
        assert set(sd) == set(want_sd)
        assert all(torch.equal(sd[k], want_sd[k]) for k in sd)
    back = convert.params_to_jax(want_sd, model.cfg)
    assert isinstance(back["audio_encoder"]["layers"], list)
    flat_back, flat_tree = convert._flatten(back), convert._flatten(tree)
    assert set(flat_back) == set(flat_tree)
    assert all(np.array_equal(flat_back[k], flat_tree[k]) for k in flat_tree)
    # the port's ModelSaver file, and JAX's, resumed into a fresh model
    tck.ModelSaver(str(tmp_path / "run")).save(3, model)
    for path in (tmp_path / "run" / "ckpt" / "model_step_3.npz",
                 tmp_path / "jax.npz"):
        fresh = MiCo(model.cfg, device="cpu", seed=9)
        tck.load_model_npz(str(path), fresh)
        assert all(torch.equal(fresh.state_dict()[k], want_sd[k])
                   for k in want_sd)


def test_released_checkpoint_refuses_a_separate_tower(tmp_path, audio_models):
    """A reference `.pt` holds no `audio_encoder.*` the converter reads (as
    JAX's `mico_from_torch`): loading it into a separate-tower config
    raises, naming the tower, and never leaves a random tower loaded."""
    from torch_port_common import (reference_state_dict, tiny_model_cfg,
                                   torch_state_dict, write_hps)
    from mico_tpu_torch.train import checkpoints as tck

    params, jcfg, model = audio_models
    shared = dict(params)
    del shared["audio_encoder"]
    sd = torch_state_dict(reference_state_dict(shared))
    root = tmp_path / "pre"
    (root / "ckpt").mkdir(parents=True)
    torch.save(sd, root / "ckpt" / "model_step_5.pt")
    write_hps(root, tiny_model_cfg(audio_encoder_type="shared"))
    tck.load_from_pretrained_dir(str(root), video_resolution=28)  # shared
    write_hps(root, tiny_model_cfg(
        audio_encoder_type=jcfg.audio_encoder_type))
    with pytest.raises(ValueError,
                       match=f"audio tower '{jcfg.audio_encoder_type}'"):
        tck.load_from_pretrained_dir(str(root), video_resolution=28)


def test_optimizer_groups_cover_the_tower(audio_models):
    """The tower's leaves take JAX's groups: basic, with the no-decay twin
    for biases, LNs, the relative table and the conv bias."""
    from mico_tpu.train.optim import param_group_labels as jlabels
    from mico_tpu_torch.train.optim import param_group_labels, jax_path

    params, jcfg, model = audio_models
    want = {"/".join(k for k in path if not k.isdigit()): v
            for path, v in convert._flatten(
                jlabels(params)).items() for path in [path.split("/")]}
    got = {"/".join(jax_path(n)): v for n, v in param_group_labels(
        model).items()}
    assert {k: v for k, v in got.items() if k.startswith("audio_encoder")} \
        == {k: v for k, v in want.items() if k.startswith("audio_encoder")}
    assert {got[k] for k in got if k.startswith("audio_encoder")} == {
        "basic", "basic_nd"}
    frozen = param_group_labels(model, frozen_prefixes=("audio_encoder",))
    assert {v for k, v in frozen.items()
            if k.startswith("audio_encoder")} == {"frozen"}


def test_config_builds_the_default_model():
    """configs/default_model_cfg.json (VAST: ViT-g, BEATs) and an `ast`
    config build, weightless, at full width."""
    from mico_tpu_torch.models.mico import MiCo

    with open(os.path.join(ROOT, "configs", "default_model_cfg.json")) as f:
        cfg = tconfig.mico_config_from_dict(json.load(f))
    assert cfg.audio_encoder_type == "beats" and cfg.audio_dim == 768
    assert cfg.audio_tower_config == taudio.BeatsConfig()
    model = MiCo(cfg, device="cpu", init_weights=False)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()
              if k.startswith("audio_encoder.")}
    want = jax.eval_shape(lambda: jaudio.init_beats(jax.random.PRNGKey(0),
                                                    jaudio.BeatsConfig()))
    assert shapes == {
        "audio_encoder." + ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                    for k in path): tuple(v.shape)
        for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    ast = dataclasses.replace(cfg, audio_encoder_type="ast")
    assert ast.audio_tower_config == taudio.AstConfig(
        audio_melbins=64, audio_target_length=1024)
    model = MiCo(ast, device="cpu", init_weights=False)
    assert model.audio_encoder.pos_embed.shape == (257, 768)


@pytest.mark.parametrize("frozen", [False, True], ids=["trained", "frozen"])
def test_train_step_trains_the_tower(rng, audio_models, frozen):
    """One `ret%ta_cap%ta` step with the towers' regularizers on (BEATs:
    dropout 0.1, gradient decay 0.5; AST: dropout 0.1; a layer LayerDrop
    skips gets no gradient, so it is left at 0 here) from the port's
    generator draws: finite losses, and every leaf of the tower but the
    key bias moved, unless `frozen_audio` (run.py's `frozen_prefixes`)
    holds it still."""
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mico_tpu_torch.train.train_step import make_train_step

    _, _, model = audio_models
    cfg = model.cfg
    if cfg.audio_encoder_type == "beats":
        tower = dataclasses.replace(cfg.audio_override,
                                    layer_wise_gradient_decay_ratio=0.5)
        cfg = dataclasses.replace(cfg, audio_override=tower)
    model = MiCo(cfg, device="cpu", seed=1)
    opt = build_optimizer(model, OptimConfig(
        num_train_steps=2, warmup_ratio=0.0, learning_rate=1e-2,
        frozen_prefixes=("audio_encoder",) if frozen else ()))
    ids = rng.integers(1000, 20000, (4, 12)).astype(np.int64)
    ids[:, 0] = 101
    batch = {"audio_spectrograms": t(rng.standard_normal(
                 (4, 2, TARGET, MELBINS)).astype(np.float32)),
             "caption_ids": t(ids), "caption_mask": torch.ones(4, 12,
                                                              dtype=torch.long)}
    before = {k: v.clone() for k, v in model.state_dict().items()
              if k.startswith("audio_encoder.")}
    out = make_train_step(cfg, opt, "ret%ta_cap%ta")(
        model, batch, torch.Generator().manual_seed(0))
    assert all(np.isfinite(v.item()) for v in out.values())
    # the key bias shifts a query's scores by one constant, which the
    # softmax ignores: its gradient is 0 (or rounding)
    moved = {k: not torch.equal(model.state_dict()[k], v)
             for k, v in before.items() if not k.endswith(".k_b")}
    assert (not any(moved.values())) if frozen else all(moved.values())
