"""The OpenAI-CLIP ViT tower (`mico_tpu_torch/models/clip_vit.py`) and MiCo
on it, against `mico_tpu.models.clip_vit` and `mico_tpu.models.mico` on the
CPU in fp32: the tower's forward (all tokens and the CLS projection, with
and without adaptor blocks) and its audio forward; a 257-token tower with
`PACKED_CLS_SPLIT` on (the K9 twin in the port, the CLS-split Pallas body in
interpret mode in JAX); the converter of OpenAI state dicts in both key
layouts and `load_openai_clip` on files written here; and a tiny MiCo on a
CLIP tower: the converter, embeddings, ITM, the serving pipeline and three
train-step updates with JAX's draws injected."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu import config as jconfig
from mico_tpu.models import clip_vit as jclip
from mico_tpu.models import mico as jm
from mico_tpu.ops import flash_attention as jfa
from mico_tpu.ops.interpolate import interp_bilinear_2d as jax_bilinear
from mico_tpu.serve import EmbeddingPipeline as JaxPipeline
from mico_tpu.train import objectives as jobj
from mico_tpu.train import optim as joptim
from mico_tpu_torch import config as tconfig
from mico_tpu_torch.convert import _flatten, params_from_jax
from mico_tpu_torch.models import clip_vit as tclip
from mico_tpu_torch.models._params import Init
from mico_tpu_torch.ops import flash_attention as tfa
from mico_tpu_torch.serve import EmbeddingPipeline
from mico_tpu_torch.train import objectives, optim
from mico_tpu_torch.train.train_step import make_train_step

from torch_port_common import MODEL_TOL, TINY, close, no_launch, \
    perturbed_params, port_model, t, to_numpy

TOWER = dict(input_resolution=28, patch_size=14, width=64, layers=2, heads=2,
             output_dim=32)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _perturbed(tree, seed, scale=0.05):
    """Every leaf of a JAX tree plus N(0, scale), so the zero-init adaptor
    gates, the biases and the LN affines are not trivial."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + scale * rng.standard_normal(a.shape).astype(
            np.float32)), tree)


def _towers(seed=0, **kw):
    """(JAX params, JAX config, the port's tower with the same weights)."""
    jcfg = jclip.ClipVitConfig(**{**TOWER, **kw})
    params = _perturbed(jclip.init_clip_vit(jax.random.PRNGKey(seed), jcfg),
                        seed + 1)
    tower = tclip.ClipVisionTransformer(tclip.ClipVitConfig(**{**TOWER, **kw}),
                                        Init(None, meta=True))
    sd = {k.replace("/", "."): torch.from_numpy(np.array(v, np.float32))
          for k, v in _flatten(to_numpy(params)).items()}
    tower.load_state_dict(sd, strict=True, assign=True)
    return params, jcfg, tower


@pytest.mark.parametrize("adaptor", [0, 1], ids=["plain", "adaptor"])
@pytest.mark.parametrize("all_features", [True, False],
                         ids=["all-tokens", "cls-proj"])
def test_tower_forward_matches_jax(rng, adaptor, all_features):
    params, jcfg, tower = _towers(adaptor_layers=adaptor)
    assert (tower.blocks[-1].get("ada_gamma") is not None) == bool(adaptor)
    px = rng.standard_normal((3, 3, 28, 28)).astype(np.float32)
    want = jclip.clip_vit_forward(params, jcfg, jnp.asarray(px),
                                  return_all_features=all_features)
    got = no_launch(lambda: tclip.clip_vit_forward(
        tower, t(px), return_all_features=all_features))
    assert got.shape == ((3, 5, 64) if all_features else (3, 32))
    close(got, want, MODEL_TOL)


@pytest.mark.parametrize("all_features", [True, False],
                         ids=["all-tokens", "cls-proj"])
def test_tower_forward_audio_matches_jax(rng, all_features):
    params, jcfg, tower = _towers(seed=2, adaptor_layers=1)
    tokens = rng.standard_normal((2, 7, 64)).astype(np.float32)
    want = jclip.clip_vit_forward_audio(params, jcfg, jnp.asarray(tokens),
                                        return_all_features=all_features)
    got = tclip.clip_vit_forward_audio(tower, t(tokens),
                                       return_all_features=all_features)
    close(got, want, MODEL_TOL)


def test_257_tokens_with_cls_split_match_jax(rng, monkeypatch):
    """ViT-L/14's sequence length (224 px / 14 = 256 patches + CLS) with
    `PACKED_CLS_SPLIT` on in both packages: the port's block takes the K9
    twin; JAX, with `FORCE_KERNEL_INTERPRET`, the CLS-split Pallas body in
    interpret mode. Both flags are restored after."""
    params, jcfg, tower = _towers(seed=3, input_resolution=224, layers=1)
    px = rng.standard_normal((2, 3, 224, 224)).astype(np.float32)
    calls = []
    real = tfa.packed_qkv_cls_attention_plain
    monkeypatch.setattr(tfa, "packed_qkv_cls_attention_plain",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    monkeypatch.setattr(tfa, "PACKED_CLS_SPLIT", True)
    try:
        jax.clear_caches()
        jfa._packed_qkv_fwd.clear_cache()
        jfa.PACKED_CLS_SPLIT = True
        jfa.FORCE_KERNEL_INTERPRET = True
        want = jclip.clip_vit_forward(params, jcfg, jnp.asarray(px))
        want = np.asarray(want)
    finally:
        jfa.PACKED_CLS_SPLIT = False
        jfa.FORCE_KERNEL_INTERPRET = False
        jfa._packed_qkv_fwd.clear_cache()
        jax.clear_caches()
    got = tclip.clip_vit_forward(tower, t(px))
    assert calls == [(2, 257, 192)]
    assert got.shape == (2, 257, 64)
    close(got, want, MODEL_TOL)


def _openai_state_dict(cfg, seed, adaptor=False, prefix=""):
    """A synthetic OpenAI CLIP visual state dict: module keys, torch layouts
    (linears (out, in), the conv kernel (W, 3, p, p)), fp32 numpy."""
    rng = np.random.default_rng(seed)
    w, p = cfg.width, cfg.patch_size
    n_tok = (cfg.input_resolution // p) ** 2 + 1

    def r(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    sd = {"conv1.weight": r(w, 3, p, p), "class_embedding": r(w),
          "positional_embedding": r(n_tok, w), "ln_pre.weight": 1 + r(w),
          "ln_pre.bias": r(w), "ln_post.weight": 1 + r(w),
          "ln_post.bias": r(w), "proj": r(w, cfg.output_dim)}
    for i in range(cfg.layers):
        pfx = f"transformer.resblocks.{i}."
        sd.update({
            pfx + "ln_1.weight": 1 + r(w), pfx + "ln_1.bias": r(w),
            pfx + "attn.in_proj_weight": r(3 * w, w),
            pfx + "attn.in_proj_bias": r(3 * w),
            pfx + "attn.out_proj.weight": r(w, w),
            pfx + "attn.out_proj.bias": r(w),
            pfx + "ln_2.weight": 1 + r(w), pfx + "ln_2.bias": r(w),
            pfx + "mlp.c_fc.weight": r(4 * w, w), pfx + "mlp.c_fc.bias": r(4 * w),
            pfx + "mlp.c_proj.weight": r(w, 4 * w),
            pfx + "mlp.c_proj.bias": r(w),
        })
        if adaptor:
            sd.update({
                pfx + "ada_ln_2.weight": 1 + r(w), pfx + "ada_ln_2.bias": r(w),
                pfx + "ada_mlp.c_fc.weight": r(w // 4, w),
                pfx + "ada_mlp.c_fc.bias": r(w // 4),
                pfx + "ada_mlp.c_proj.weight": r(w, w // 4),
                pfx + "ada_mlp.c_proj.bias": r(w),
                pfx + "ada_gamma": r(w),
            })
    sd = {prefix + k: v for k, v in sd.items()}
    if prefix:      # the jit archive also holds the text tower's keys
        sd["token_embedding.weight"] = r(10, w)
    return sd


def _port_names(jparams) -> dict:
    return {k.replace("/", "."): v for k, v in _flatten(to_numpy(jparams)).items()}


@pytest.mark.parametrize("prefix", ["", "visual."], ids=["module", "archive"])
@pytest.mark.parametrize("adaptor", [False, True], ids=["plain", "adaptor"])
def test_clip_vit_from_torch_matches_jax(prefix, adaptor):
    cfg = jclip.ClipVitConfig(**TOWER, adaptor_layers=2 if adaptor else 0)
    sd = _openai_state_dict(cfg, 4, adaptor, prefix)
    want = _port_names(jclip.clip_vit_from_torch(sd, cfg))
    got = tclip.clip_vit_from_torch({k: t(v) for k, v in sd.items()},
                                    tclip.ClipVitConfig(**dataclasses.asdict(cfg)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v)
    tcfg = tclip.clip_vit_config_from_state_dict(sd)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(
        jclip.clip_vit_config_from_state_dict(sd))
    # the converted dict fills the port's tower exactly
    tower = tclip.ClipVisionTransformer(
        tclip.ClipVitConfig(**dataclasses.asdict(cfg)), Init(None, meta=True))
    tower.load_state_dict(got, strict=True, assign=True)


def test_load_openai_clip_without_resize_matches_jax(tmp_path):
    cfg = jclip.ClipVitConfig(**TOWER)
    sd = _openai_state_dict(cfg, 5)
    path = tmp_path / "clip.pt"
    torch.save({k: t(v) for k, v in sd.items()}, path)
    assert not tclip._is_torchscript(str(path))
    jparams, jcfg = jclip.load_openai_clip(str(path))
    got, tcfg = tclip.load_openai_clip(str(path))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = _port_names(jparams)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


class _Archive(torch.nn.Module):
    """A module whose state dict has the given keys, to be scripted into a
    TorchScript archive like OpenAI's released files."""

    def __init__(self, sd):
        super().__init__()
        for key, value in sd.items():
            *path, leaf = key.split(".")
            mod = self
            for name in path:
                if not hasattr(mod, name):
                    mod.add_module(name, torch.nn.Module())
                mod = getattr(mod, name)
            mod.register_parameter(leaf, torch.nn.Parameter(t(value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def test_load_openai_clip_reads_a_torchscript_archive(tmp_path):
    """The archive branch (`visual.`-prefixed keys beside the text tower's,
    read with `torch.jit.load`), held to JAX's `load_openai_clip`."""
    cfg = jclip.ClipVitConfig(**TOWER)
    sd = _openai_state_dict(cfg, 8, prefix="visual.")
    path = tmp_path / "clip_archive.pt"
    torch.jit.save(torch.jit.script(_Archive(sd)), str(path))
    assert tclip._is_torchscript(str(path))
    jparams, jcfg = jclip.load_openai_clip(str(path))
    got, tcfg = tclip.load_openai_clip(str(path))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = _port_names(jparams)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_load_openai_clip_resizes_the_position_embedding(tmp_path):
    """A 2 x 2 patch grid loaded at resolution 42 (a 3 x 3 grid): the CLS
    row kept, the grid resized bilinearly (align_corners=False). JAX's own
    resize branch raises here: it passes `align_corners=False` to
    `interp_bilinear_2d`, which takes no such argument
    (mico_tpu/models/clip_vit.py:268-272, mico_tpu/ops/interpolate.py:61).
    So the port is held to JAX's `clip_vit_from_torch` of the same dict
    after `interp_bilinear_2d(body, (3, 3))`, the documented intent."""
    cfg = jclip.ClipVitConfig(**TOWER)
    sd = _openai_state_dict(cfg, 6, adaptor=True)
    path = tmp_path / "clip.pt"
    torch.save({k: t(v) for k, v in sd.items()}, path)
    with pytest.raises(TypeError, match="align_corners"):
        jclip.load_openai_clip(str(path), resolution=42)
    pos = sd["positional_embedding"]
    body = pos[1:].reshape(2, 2, -1).transpose(2, 0, 1)
    body = np.asarray(jax_bilinear(jnp.asarray(body)[None], (3, 3)))[0]
    resized = dict(sd, positional_embedding=np.concatenate(
        [pos[:1], body.transpose(1, 2, 0).reshape(9, -1)]))
    jcfg = dataclasses.replace(jclip.clip_vit_config_from_state_dict(sd, 42),
                               adaptor_layers=2)
    want = _port_names(jclip.clip_vit_from_torch(resized, jcfg))
    got, tcfg = tclip.load_openai_clip(str(path), resolution=42,
                                       adaptor_layers=2)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.seq_len == 10
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# MiCo on a CLIP tower (the tower config of tests/test_encoder_zoo.py)
# ---------------------------------------------------------------------------

ZOO = dict(input_resolution=32, patch_size=16, width=64, layers=2, heads=2,
           output_dim=32)


def clip_configs(bert=None, **mico):
    """(JAX MiCoConfig, port MiCoConfig) of a tiny MiCo on a CLIP tower
    (`vision_encoder_type="clip_vit_base_16"` with a `vision_override`)."""
    b = {**TINY["bert"], **(bert or {})}
    m = dict(vision_encoder_type="clip_vit_base_16", contra_dim=32,
             compute_dtype="float32", use_flash_attention=True,
             max_vision_sample_num=2, max_audio_sample_num=2, **mico)
    return (jconfig.MiCoConfig(vision_override=jclip.ClipVitConfig(**ZOO),
                               bert_override=jconfig.BertConfig(**b), **m),
            tconfig.MiCoConfig(vision_override=tclip.ClipVitConfig(**ZOO),
                               bert_override=tconfig.BertConfig(**b), **m))


@pytest.fixture(scope="module")
def clip_models():
    jcfg, tcfg = clip_configs()
    params = perturbed_params(jcfg, seed=1)
    return params, jcfg, port_model(params, tcfg)


def test_clip_config_and_converter(clip_models):
    params, jcfg, model = clip_models
    tcfg = model.cfg
    assert not tcfg.is_eva and tcfg.vision_dim == jcfg.vision_dim == 64
    assert isinstance(model.vision_encoder, tclip.ClipVisionTransformer)
    sd = params_from_jax(to_numpy(params), tcfg)
    assert set(sd) == set(model.state_dict())
    assert "vision_encoder.blocks.1.qkv_w" in sd
    assert isinstance(params["vision_encoder"]["blocks"], list)
    # the canonical model is its own folded copy
    assert model.fold_inference_params() is model
    assert set(model.state_dict()) == set(sd)


@pytest.mark.parametrize("t_name,width,tokens", [
    ("clip_vit_base_16", 768, 197), ("clip_vit_base_32", 768, 197),
    ("clip_vit_large_14_336px", 1024, 257)])
def test_clip_tower_names_follow_jax(t_name, width, tokens):
    """JAX's name map as it is (config.py:327-337): base_32 takes the B/16
    geometry and large_14_336px L/14 at 224 px."""
    jcfg = jconfig.MiCoConfig(vision_encoder_type=t_name)
    tcfg = tconfig.MiCoConfig(vision_encoder_type=t_name)
    assert dataclasses.asdict(tcfg.vision_tower_config) == dataclasses.asdict(
        jcfg.vision_tower_config)
    assert tcfg.vision_dim == jcfg.vision_dim == width
    assert tcfg.vision_tower_config.seq_len == tokens


def _embed(f):
    return f / np.linalg.norm(np.asarray(f), axis=-1, keepdims=True)


def test_clip_mico_embeddings_and_itm(rng, clip_models):
    params, jcfg, model = clip_models
    px = rng.standard_normal((2, 2, 3, 32, 32)).astype(np.float32)
    spec = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
    ids = rng.integers(200, 20000, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[2, 8:] = 0

    jv = jm.forward_vision_encoder(params, jcfg, jnp.asarray(px))
    ja = jm.forward_audio_encoder(params, jcfg, jnp.asarray(spec))
    v = no_launch(lambda: model.forward_vision_encoder(t(px)))
    a = model.forward_audio_encoder(t(spec))
    assert v.shape == (2, 2, 5, 64)
    close(v, jv, MODEL_TOL)
    close(a, ja, MODEL_TOL)
    for tok, jtok, head in ((v, jv, "v"), (a, ja, "a")):
        got = model.contra_head(head, model.pool_vision_for_contra(tok))
        want = jm.contra_head(params[f"contra_head_{head}"],
                              jm.pool_vision_for_contra(jcfg, jtok))
        close(_embed(got.numpy()), _embed(want), MODEL_TOL)
    jseq = jm.forward_multimodal_encoder(params, jcfg, jnp.asarray(ids),
                                         jnp.asarray(mask)).sequence_output
    seq = model.forward_multimodal_encoder(t(ids), t(mask))
    close(seq, jseq, MODEL_TOL)
    got = model.contra_head("t", model.pool_text_for_contra(seq))
    close(_embed(got.numpy()), _embed(jm.contra_head(
        params["contra_head_t"], jm.pool_text_for_contra(jseq))), MODEL_TOL)
    # ITM of the first video against the three captions
    jcond = jm.get_multimodal_forward_input_vision(params, jcfg, jv[:1])
    jx = jm.forward_multimodal_encoder(
        params, jcfg, jnp.asarray(ids), jnp.asarray(mask),
        jnp.broadcast_to(jcond, (3,) + jcond.shape[1:])).sequence_output
    cond = model.get_multimodal_forward_input_vision(v[:1]).expand(3, -1, -1)
    x = model.forward_multimodal_encoder(t(ids), t(mask), cond)
    close(torch.softmax(model.itm_head(x[:, 0]), dim=1)[:, 1],
          jax.nn.softmax(jm.itm_head(params, jx[:, 0]), axis=1)[:, 1],
          MODEL_TOL)


def test_clip_mico_pipeline_matches_jax(rng, clip_models):
    """`EmbeddingPipeline` serves the CLIP MiCo as it is (its folded copy is
    the model itself): texts and `_run` over images with one failure equal
    JAX's pipeline."""
    from mico_tpu.text import BertWordPieceTokenizer as JaxTokenizer
    from mico_tpu_torch.text import BertWordPieceTokenizer

    from test_torch_serve import JAX_VOCAB, TEXTS

    params, jcfg, model = clip_models
    jpipe = JaxPipeline(params, jcfg, JaxTokenizer(JAX_VOCAB), batch_size=2,
                        io_workers=2)
    tpipe = EmbeddingPipeline(model, model.cfg, BertWordPieceTokenizer(),
                              batch_size=2, io_workers=2, device="cpu")
    try:
        assert tpipe.model is model
        close(tpipe.embed_texts(TEXTS), jpipe.embed_texts(TEXTS), MODEL_TOL)
        items = [rng.standard_normal((1, 3, 32, 32)).astype(np.float32)
                 for _ in range(3)]
        items[1] = None
        got = tpipe._run(items, lambda a: a,
                         lambda m, x: tpipe._embed_pixels(m, x, head="v"))
    finally:
        tpipe.close()
    want = jpipe._run(items, lambda a: a,
                      lambda p, x: jpipe._embed_pixels(p, x, head="v"))
    assert tpipe.last_failures == jpipe.last_failures == [1]
    close(got, want, MODEL_TOL)


def _batch(rng, b, frames, size, cap_len=12):
    ids = rng.integers(200, 20000, (b, cap_len)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((b, cap_len), np.int32)
    mask[1, cap_len - 3:] = 0
    ids[1, cap_len - 3:] = 0
    return {
        "vision_pixels": rng.standard_normal(
            (b, frames, 3, size, size)).astype(np.float32),
        "audio_spectrograms": rng.standard_normal(
            (b, 2, size, size)).astype(np.float32),
        "caption_ids": ids, "caption_mask": mask,
    }


def test_clip_train_step_matches_jax(monkeypatch):
    """Three updates of the port's `make_train_step` and of JAX's on the
    CLIP MiCo, as `test_torch_training.py::test_train_step_matches_jax`
    runs them: JAX's draws of each step recorded and injected, Adam's eps
    raised so the clip shows in the update. The tower trains on the K3/K4
    route (their twins here) in the optimizer's `vision` group."""
    task = "ret%tva_cap%tva"
    jcfg, tcfg = clip_configs(bert=NO_DROPOUT)
    params = perturbed_params(jcfg, seed=3)
    batch = _batch(np.random.default_rng(7), 3, 2, 32)
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
    assert {topt.labels[n] for n, _ in model.named_parameters()
            if n.startswith("vision_encoder.")} == {"vision", "vision_nd"}
    step = make_train_step(tcfg, topt, task)
    tbatch = {k: t(v) if v.dtype == np.float32 else t(v).long()
              for k, v in batch.items()}
    state = jopt.init(params)
    for i in range(3):
        key = jax.random.PRNGKey(i)
        _, jmasks, jcats = record(params, key)
        draws = objectives.Draws(
            masks=[tuple(t(np.asarray(x)) for x in pair) for pair in jmasks],
            negatives=[(t(np.asarray(jcats[j])), t(np.asarray(jcats[j + 1])))
                       for j in range(0, len(jcats), 2)])
        params, state, want = jstep(params, state, jbatch, key)
        got = no_launch(lambda: step(model, tbatch,
                                     torch.Generator().manual_seed(i),
                                     draws=draws))
        assert not draws.masks and not draws.negatives
        for name in want:
            close(got[name], want[name], dict(rtol=1e-5, atol=1e-6))
        sd = params_from_jax(to_numpy(params), tcfg)
        for name, prm in model.named_parameters():
            close(prm.detach(), sd[name], MODEL_TOL)
