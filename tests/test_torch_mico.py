"""The slice as a whole: the port's `MiCo` (`mico_tpu_torch/models/mico.py`)
with weights carried from JAX by `params_from_jax`, against
`mico_tpu.models.mico` on the CPU — image (n = 1, the frame-embedding
interp), video (n = 4), shared-route audio and depth embeddings, text
embeddings, similarity and ITM scores; and a tiny post-norm MiCo (the
EVA02-CLIP-bigE block) from canonical and folded trees."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.models import mico as jm
from mico_tpu_torch import config as tconfig
from mico_tpu_torch.convert import mico_from_jax, params_from_jax
from mico_tpu_torch.models.mico import MiCo, frame_embedding
from mico_tpu_torch.ops import flash_attention as tfa

from torch_port_common import MODEL_TOL, OP_TOL, close, configs, \
    no_launch, perturbed_params, port_model, t, to_numpy


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs()
    params = perturbed_params(jcfg)
    return params, jcfg, port_model(params, tcfg)


def _jax_embed(params, cfg, tokens, head):
    f = jm.contra_head(params[f"contra_head_{head}"],
                       jm.pool_frames_for_contra(tokens))
    return f / jnp.linalg.norm(f, axis=-1, keepdims=True)


def _torch_embed(model, tokens, head):
    f = model.contra_head(head, model.pool_vision_for_contra(tokens))
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)


@pytest.mark.parametrize("modality,n,head", [
    ("image", 1, "v"), ("video", 4, "v"), ("audio", 2, "a"), ("depth", 1, "d"),
])
def test_knowledge_embeddings(rng, models, modality, n, head):
    params, jcfg, model = models
    if modality == "audio":
        x = rng.standard_normal((2, n, 28, 28)).astype(np.float32)
        want_tokens = jm.forward_audio_encoder(params, jcfg, jnp.asarray(x))
        got_tokens = model.forward_audio_encoder(t(x))
    else:
        x = rng.standard_normal((2, n, 3, 28, 28)).astype(np.float32)
        want_tokens = jm.forward_vision_encoder(params, jcfg, jnp.asarray(x))
        got_tokens = model.forward_vision_encoder(t(x))
    assert got_tokens.shape == (2, n, 5, 64)
    close(got_tokens, want_tokens, MODEL_TOL)
    close(_torch_embed(model, got_tokens, head),
          _jax_embed(params, jcfg, want_tokens, head), MODEL_TOL)
    # the condition tokens for the interface branch (frame + type embedding;
    # n = 1 and 2 resize the 4-frame table by nearest interp)
    key = {"image": "vision", "video": "vision"}.get(modality, modality)
    want = getattr(jm, f"get_multimodal_forward_input_{key}")(
        params, jcfg, want_tokens)
    got = getattr(model, f"get_multimodal_forward_input_{key}")(got_tokens)
    assert got.shape == (2, 5 * n, 64)
    close(got, want, MODEL_TOL)


def test_text_similarity_and_itm(rng, models):
    params, jcfg, model = models
    ids = rng.integers(200, 20000, (3, 30)).astype(np.int32)
    mask = np.ones((3, 30), np.int32)
    mask[2, 11:] = 0
    px = rng.standard_normal((1, 4, 3, 28, 28)).astype(np.float32)

    jseq = jm.forward_multimodal_encoder(params, jcfg, jnp.asarray(ids),
                                         jnp.asarray(mask)).sequence_output
    jt = jm.contra_head(params["contra_head_t"], jm.pool_text_for_contra(jseq))
    jt = jt / jnp.linalg.norm(jt, axis=-1, keepdims=True)
    jvout = jm.forward_vision_encoder(params, jcfg, jnp.asarray(px))
    jsims = jt @ _jax_embed(params, jcfg, jvout, "v").T
    jcond = jm.get_multimodal_forward_input_vision(params, jcfg, jvout)
    jcond = jnp.broadcast_to(jcond, (3,) + jcond.shape[1:])
    jx = jm.forward_multimodal_encoder(params, jcfg, jnp.asarray(ids),
                                       jnp.asarray(mask), jcond).sequence_output
    jitm = jax.nn.softmax(jm.itm_head(params, jx[:, 0]), axis=1)[:, 1]

    seq = model.forward_multimodal_encoder(t(ids), t(mask))
    close(seq, jseq, MODEL_TOL)
    tt = model.contra_head("t", model.pool_text_for_contra(seq))
    tt = tt / torch.linalg.vector_norm(tt, dim=-1, keepdim=True)
    vout = model.forward_vision_encoder(t(px))
    sims = tt @ _torch_embed(model, vout, "v").T
    close(sims, jsims, MODEL_TOL)
    cond = model.get_multimodal_forward_input_vision(vout).expand(3, -1, -1)
    x = model.forward_multimodal_encoder(t(ids), t(mask), cond)
    logits = model.itm_head(x[:, 0])
    close(logits, jm.itm_head(params, jx[:, 0]), MODEL_TOL)
    close(torch.softmax(logits, dim=1)[:, 1], jitm, MODEL_TOL)


def test_itm_on_k2_route(rng, monkeypatch):
    """At 112 px a 4-frame condition is 4·65 = 260 tokens, so the ITM
    cross-attention takes K2 (30·260 > 4096) as it does at full width."""
    jcfg, tcfg = configs(eva=dict(image_size=112))
    params = perturbed_params(jcfg, seed=3)
    model = port_model(params, tcfg)
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ids = rng.integers(200, 20000, (2, 30)).astype(np.int32)
    mask = np.ones((2, 30), np.int32)
    px = rng.standard_normal((2, 4, 3, 112, 112)).astype(np.float32)
    jcond = jm.get_multimodal_forward_input_vision(
        params, jcfg, jm.forward_vision_encoder(params, jcfg, jnp.asarray(px)))
    jx = jm.forward_multimodal_encoder(params, jcfg, jnp.asarray(ids),
                                       jnp.asarray(mask), jcond).sequence_output
    cond = model.get_multimodal_forward_input_vision(
        model.forward_vision_encoder(t(px)))
    assert cond.shape == (2, 260, 64)
    x = model.forward_multimodal_encoder(t(ids), t(mask), cond)
    assert len(calls) == tcfg.bert_config.num_hidden_layers
    close(model.itm_head(x[:, 0]), jm.itm_head(params, jx[:, 0]), MODEL_TOL)


@pytest.mark.parametrize("folded", [False, True])
def test_params_from_jax_places_every_leaf(models, folded):
    params, jcfg, _ = models
    if folded:
        params = jm.fold_inference_params(params, jcfg)
    flat = jax.tree_util.tree_leaves_with_path(params)
    sd = params_from_jax(to_numpy(params), configs()[1])
    n_stacked = sum(
        leaf.shape[0] for path, leaf in flat
        if jax.tree_util.keystr(path[:2]) in ("['vision_encoder']['blocks']",
                                              "['bert']['layers']"))
    n_flat = sum(1 for path, _ in flat
                 if jax.tree_util.keystr(path[:2]) not in (
                     "['vision_encoder']['blocks']", "['bert']['layers']"))
    assert len(sd) == n_stacked + n_flat
    assert ("vision_encoder.blocks.1.qkv_bias" in sd) == folded
    np.testing.assert_array_equal(
        sd["bert.layers.1.xk_w"].numpy(),
        np.asarray(params["bert"]["layers"]["xk_w"][1]))


def test_params_from_jax_raises_on_strays(models):
    params, _, _ = models
    np_params = to_numpy(params)
    tcfg = configs()[1]
    extra = dict(np_params, stray_head={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray_head"):
        params_from_jax(extra, tcfg)
    missing = {k: v for k, v in np_params.items() if k != "itm_head"}
    with pytest.raises(KeyError, match="itm_head"):
        params_from_jax(missing, tcfg)
    wrong = dict(np_params, contra_temp=np.zeros((2,), np.float32))
    with pytest.raises(ValueError, match="contra_temp"):
        params_from_jax(wrong, tcfg)


# ---------------------------------------------------------------------------
# a post-norm tower (EVA02-CLIP-bigE's block) with LayerScale
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def postnorm_models():
    jcfg, tcfg = configs(eva=dict(postnorm=True, ls_init_value=0.1))
    return perturbed_params(jcfg, seed=5), jcfg, tcfg


@pytest.mark.parametrize("folded", [False, True], ids=["canonical", "folded"])
def test_postnorm_embeddings_and_itm(rng, postnorm_models, folded):
    """A post-norm MiCo built by `mico_from_jax` from the canonical or the
    folded JAX tree: video and audio embeddings and ITM probabilities equal
    JAX's on the same tree."""
    params, jcfg, tcfg = postnorm_models
    if folded:
        params = jm.fold_inference_params(params, jcfg)
    model = mico_from_jax(to_numpy(params), tcfg, device="cpu")
    blk = model.vision_encoder.blocks[0]
    assert (blk.get("gamma_1") is None) == folded
    assert blk.get("norm1_w") is not None and blk.get("qkv_bias") is None
    px = rng.standard_normal((2, 4, 3, 28, 28)).astype(np.float32)
    aud = rng.standard_normal((2, 2, 28, 28)).astype(np.float32)
    jv = jm.forward_vision_encoder(params, jcfg, jnp.asarray(px))
    ja = jm.forward_audio_encoder(params, jcfg, jnp.asarray(aud))
    tv = no_launch(lambda: model.forward_vision_encoder(t(px)))
    ta = model.forward_audio_encoder(t(aud))
    close(tv, jv, MODEL_TOL)
    close(_torch_embed(model, tv, "v"), _jax_embed(params, jcfg, jv, "v"),
          MODEL_TOL)
    close(_torch_embed(model, ta, "a"), _jax_embed(params, jcfg, ja, "a"),
          MODEL_TOL)
    ids = rng.integers(200, 20000, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 7:] = 0
    jcond = jm.get_multimodal_forward_input_vision(params, jcfg, jv[:1])
    jcond = jnp.broadcast_to(jcond, (3,) + jcond.shape[1:])
    jx = jm.forward_multimodal_encoder(params, jcfg, jnp.asarray(ids),
                                       jnp.asarray(mask), jcond).sequence_output
    jitm = jax.nn.softmax(jm.itm_head(params, jx[:, 0]), axis=1)[:, 1]
    cond = model.get_multimodal_forward_input_vision(tv[:1]).expand(3, -1, -1)
    x = model.forward_multimodal_encoder(t(ids), t(mask), cond)
    close(torch.softmax(model.itm_head(x[:, 0]), dim=1)[:, 1], jitm,
          MODEL_TOL)


@pytest.mark.parametrize("folded", [False, True], ids=["canonical", "folded"])
def test_params_from_jax_postnorm_layouts(postnorm_models, folded):
    """A folded post-norm tree keeps its LNs and q/v biases and loses only
    LayerScale, so it has no `qkv_bias`: the layout is read from what the
    tree lacks, and every leaf is placed."""
    params, jcfg, tcfg = postnorm_models
    if folded:
        params = jm.fold_inference_params(params, jcfg)
    sd = params_from_jax(to_numpy(params), tcfg)
    assert "vision_encoder.blocks.1.qkv_bias" not in sd
    assert "vision_encoder.blocks.1.norm1_w" in sd
    assert ("vision_encoder.blocks.1.gamma_1" in sd) != folded
    np.testing.assert_array_equal(
        sd["vision_encoder.blocks.1.proj_w"].numpy(),
        np.asarray(params["vision_encoder"]["blocks"]["proj_w"][1]))


def test_bige_config_builds_at_full_width():
    """`evaclip02_bige` builds (weightless): the post-norm EVA02-CLIP-bigE
    tower, 64 blocks of width 1792, 16 heads of 112, MLP 15360, 4.35 B
    parameters, and vision_dim 1792 in the heads and `hidden_trans_*`."""
    cfg = tconfig.MiCoConfig(vision_encoder_type="evaclip02_bige")
    eva = cfg.eva_config
    assert (eva.layers, eva.width, eva.num_heads, eva.head_dim,
            eva.mlp_hidden, eva.seq_len, eva.postnorm) == (
                64, 1792, 16, 112, 15360, 257, True)
    model = MiCo(cfg, device="cpu", init_weights=False)
    n = sum(p.numel() for p in model.vision_encoder.parameters())
    assert abs(n - 4.3506e9) < 1e6
    assert model.contra_head_v.get("kernel").shape == (1792, cfg.contra_dim)
    assert model.hidden_trans_vision.get("kernel").shape == (1792, 768)
    assert model.vision_encoder.blocks[0].postnorm


def test_frame_embedding_interp(rng):
    emb = t(rng.standard_normal((1, 4, 6)).astype(np.float32))
    assert frame_embedding(emb, 4) is emb
    np.testing.assert_array_equal(frame_embedding(emb, 1).numpy(),
                                  emb[:, :1].numpy())
    want = jm._frame_embedding(jnp.asarray(emb.numpy()), 2)
    close(frame_embedding(emb, 2), want, OP_TOL)


def test_seeded_init_is_reproducible():
    _, tcfg = configs()
    a = MiCo(tcfg, device="cpu", seed=5)
    b = MiCo(tcfg, device="cpu", seed=5)
    c = MiCo(tcfg, device="cpu", seed=6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["vision_encoder.blocks.0.qkv_w"],
                           sc["vision_encoder.blocks.0.qkv_w"])
    w = sa["vision_encoder.blocks.0.qkv_w"]
    assert w.abs().max() <= 0.04 + 1e-6 and abs(w.std().item() - 0.0176) < 3e-3


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        MiCo(tcfg)


@pytest.mark.parametrize("kw,attr", [
    (dict(vision_encoder_type="vit_h14_laion"), "vision_dim"),
    (dict(vision_encoder_type="clip_vit_huge_14"), "vision_tower_config"),
])
def test_unported_towers_raise(kw, attr):
    with pytest.raises(NotImplementedError, match="JAX package either"):
        getattr(tconfig.MiCoConfig(**kw), attr)


@pytest.mark.parametrize("kw,attr", [
    (dict(audio_encoder_type="beats"), "audio_dim"),
    (dict(audio_encoder_type="ast", audio_melbins=128,
          audio_target_length=512), "audio_tower_config"),
])
def test_audio_towers_configure_as_jax(kw, attr):
    """The separate towers (once refused here) take JAX's widths and
    configs: every field of the tower's config, BEATs' AS2M defaults and
    an AST at the config's mel bins and target length."""
    from mico_tpu.config import MiCoConfig as JaxConfig

    ours, theirs = getattr(tconfig.MiCoConfig(**kw), attr), getattr(
        JaxConfig(**kw), attr)
    if attr == "audio_dim":
        assert ours == theirs == 768
    else:
        assert type(ours).__name__ == type(theirs).__name__ == "AstConfig"
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.tokens_per_frame == 256


def test_config_from_dict_matches_jax():
    """The port's config reads a reference-style model_cfg dict as JAX's
    does: unknown keys ignored, overrides lifted into their dataclasses."""
    from mico_tpu.config import mico_config_from_dict as jax_from_dict

    d = dict(vision_encoder_type="evaclip01_giant", contra_dim=256,
             max_vision_sample_num=8, unknown_key=1,
             eva_override=dict(image_size=28, patch_size=14, layers=2,
                               width=64, head_width=32),
             bert_override=dict(hidden_size=64, num_hidden_layers=2,
                                num_attention_heads=2, encoder_width=64))
    ours, theirs = tconfig.mico_config_from_dict(d), jax_from_dict(d)
    for f in ("contra_dim", "max_vision_sample_num", "vision_dim",
              "multimodal_dim", "audio_dim"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert ours.eva_config.num_heads == theirs.eva_config.num_heads == 2
    assert ours.bert_config.head_dim == theirs.bert_config.head_dim == 32
    full = tconfig.MiCoConfig().eva_config
    assert (full.layers, full.width, full.num_heads, full.head_dim,
            full.mlp_hidden, full.seq_len) == (40, 1408, 16, 88, 6144, 257)
