"""MiCo on every vision tower family of the JAX package, in the port and in
`mico_tpu` on the CPU in fp32 (the port's counterpart of
`tests/test_encoder_zoo.py`): Swin (`swin*`), VideoSwin (`videoswin*`) and
an EVA02 override (RoPE, SwiGLU, sub-LN). For each: `compute_features`
('va' and 'd', the pooled features and the condition tokens) and
`task_losses("ret%tva_cap%tva")` with JAX's draws injected, and
`EmbeddingPipeline.embed_images` / `embed_videos` on files against JAX's
pipeline. Also: the repair of vision pooling (Swin and VideoSwin pool by
their patch mean, as JAX does; the CLS token is not JAX's embedding), a
native `.npz` of a Swin MiCo written by JAX's `save_pytree_npz` loaded into
the port and the port's own file reloaded, the released `.pt` loader's
refusal of a non-EVA tower, and `MiCoConfig(vision_encoder_type=t)` for
every type JAX accepts, built weightless with JAX's leaf shapes.

Towers at the tiny sizes of `tests/test_encoder_zoo.py` (Swin and
VideoSwin at 56 px, embed 16, depths (2, 2), window 7 or (4, 7, 7), drop
path 0 so JAX's training draws are none; EVA02 at 28 px, 2 layers, width
64), the tiny BERT of `torch_port_common`. Weights are a seeded port init
with every leaf perturbed by N(0, 0.05); JAX gets the same tree through
`convert.params_to_jax`. Tolerance: MODEL_TOL (1e-4); task losses 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu import config as jconfig
from mico_tpu.models import mico as jm
from mico_tpu.models import swin as jswin
from mico_tpu.serve import EmbeddingPipeline as JaxPipeline
from mico_tpu.train import objectives as jobj
from mico_tpu_torch import config as tconfig
from mico_tpu_torch import convert
from mico_tpu_torch.models import swin as tswin
from mico_tpu_torch.models.mico import MiCo
from mico_tpu_torch.serve import EmbeddingPipeline
from mico_tpu_torch.train import objectives as tobj

from test_torch_swin import warm_jax_masks
from torch_port_common import MODEL_TOL, TINY, close, media_files, t

SWIN = dict(img_size=56, embed_dim=16, depths=(2, 2), num_heads=(2, 2),
            window_size=7, drop_path_rate=0.0)
VIDEO = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2),
             window_size=(4, 7, 7), drop_path_rate=0.0)
EVA02 = dict(TINY["eva"], rope=True, naiveswiglu=True, subln=True,
             intp_freq=True, mlp_ratio=2.6667)
# type, resolution, (JAX override, port override) per tower
TOWERS = {
    "swin": ("swin_base_patch4_window7_224_22k", 56,
             dict(vision_override=(jswin.SwinConfig(**SWIN),
                                   tswin.SwinConfig(**SWIN)))),
    "videoswin": ("videoswin_base", 56,
                  dict(vision_override=(jswin.VideoSwinConfig(**VIDEO),
                                        tswin.VideoSwinConfig(**VIDEO)))),
    "eva02": ("evaclip02_large", 28,
              dict(eva_override=(jconfig.EvaVitConfig(**EVA02),
                                 tconfig.EvaVitConfig(**EVA02)))),
}
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def zoo_configs(kind: str):
    """(JAX MiCoConfig, port MiCoConfig) of the tiny MiCo on `kind`."""
    vtype, res, over = TOWERS[kind]
    bert = {**TINY["bert"], **NO_DROPOUT}
    kw = dict(vision_encoder_type=vtype, vision_resolution=res,
              contra_dim=32, compute_dtype="float32",
              use_flash_attention=True, max_vision_sample_num=2,
              max_audio_sample_num=2, max_depth_sample_num=2)
    (name, (jo, to)), = over.items()
    return (jconfig.MiCoConfig(bert_override=jconfig.BertConfig(**bert),
                               **{name: jo}, **kw),
            tconfig.MiCoConfig(bert_override=tconfig.BertConfig(**bert),
                               **{name: to}, **kw))


@pytest.fixture(scope="module", params=list(TOWERS))
def zoo(request):
    """(kind, JAX cfg, JAX params, port MiCo, resolution)."""
    kind = request.param
    jcfg, tcfg = zoo_configs(kind)
    model = MiCo(tcfg, device="cpu", seed=3)
    rng = np.random.default_rng(103)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(np.array(
                0.05 * rng.standard_normal(p.shape), np.float32)))
    # JAX builds its shift masks eagerly, which a jit trace cannot: the
    # 14 x 14 patch grid, and VideoSwin's 1 (an image) or 2 (2 frames)
    # temporal patches
    if kind == "swin":
        warm_jax_masks(jcfg.vision_override, (14, 14), video=False)
    elif kind == "videoswin":
        for dt in (1, 2):
            warm_jax_masks(jcfg.vision_override, (dt, 14, 14), video=True)
    params = convert.params_to_jax(model.state_dict(), tcfg)
    return kind, jcfg, params, model, TOWERS[kind][1]


def _batch(rng, b: int, res: int) -> dict:
    ids = rng.integers(200, 20000, (b, 10)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((b, 10), np.int32)
    mask[1, 7:] = 0
    ids[1, 7:] = 0
    f = np.float32
    return {"vision_pixels": rng.standard_normal((b, 2, 3, res, res)).astype(f),
            "audio_spectrograms": rng.standard_normal((b, 2, res, res)
                                                      ).astype(f),
            "depth_pixels": rng.standard_normal((b, 2, 3, res, res)).astype(f),
            "caption_ids": ids, "caption_mask": mask}


def _torch(batch: dict) -> dict:
    return {k: t(v) if v.dtype == np.float32 else t(v).long()
            for k, v in batch.items()}


def test_features_and_task_losses_match_jax(zoo, monkeypatch):
    """`compute_features` for 'va' and 'd' (each tower pooled by its rule:
    Swin and VideoSwin by the patch mean, EVA by CLS; shared audio by CLS,
    as JAX's `pool_audio_for_contra`) and every loss of
    `task_losses("ret%tva_cap%tva")` with JAX's mask and negative draws,
    in one jitted JAX call."""
    kind, jcfg, params, model, res = zoo
    batch = _batch(np.random.default_rng(5), 3, res)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    task, key = "ret%tva_cap%tva", jax.random.PRNGKey(4)
    masks, cats = [], []
    with monkeypatch.context() as m:
        real_mask, real_cat = jobj.mask_tokens, jax.random.categorical

        def record_mask(*a, **kw):
            masks.append(real_mask(*a, **kw))
            return masks[-1]

        def record_cat(*a, **kw):
            cats.append(real_cat(*a, **kw))
            return cats[-1]

        m.setattr(jobj, "mask_tokens", record_mask)
        m.setattr(jax.random, "categorical", record_cat)
        feats, losses, masks, cats = jax.jit(lambda p: (
            {m: jobj.compute_features(p, jcfg, jbatch, m) for m in ("va", "d")},
            jobj.task_losses(key, p, jcfg, jbatch, task), masks, cats))(params)
    tb = _torch(batch)
    with torch.no_grad():
        for m in ("va", "d"):
            got = tobj.compute_features(model, model.cfg, tb, m)
            for k in (f"feat_{m}", f"condition_feats_{m}"):
                close(got[k], feats[m][k], MODEL_TOL)
        draws = tobj.Draws(
            masks=[tuple(t(np.asarray(x)) for x in pair) for pair in masks],
            negatives=[(t(np.asarray(cats[i])), t(np.asarray(cats[i + 1])))
                       for i in range(0, len(cats), 2)])
        got = tobj.task_losses(model, model.cfg, tb, task,
                               torch.Generator().manual_seed(0), draws=draws)
    assert sorted(got) == sorted(losses)
    for name in losses:
        close(got[name], losses[name], dict(rtol=1e-5, atol=1e-5))


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """Three images and three 5-frame videos; item 1 of each undecodable."""
    root = tmp_path_factory.mktemp("zoo_media")
    out = {"image": [], "video": []}
    for i in range(3):
        (root / str(i)).mkdir()
        files = media_files(str(root / str(i)), seed=30 + i, size=(40, 52),
                            frames=5)
        for kind in out:
            out[kind].append(files[kind])
    (root / "bad.bin").write_bytes(b"\x00 garbage")
    out["image"][1] = str(root / "bad.bin")
    out["video"][1] = str(root / "missing_frames")
    return out


@pytest.mark.parametrize("method,item", [("embed_images", "image"),
                                         ("embed_videos", "video")])
def test_pipeline_matches_jax(zoo, media, method, item):
    """`embed_images` and `embed_videos` give JAX's pipeline's embeddings on
    the same files (JAX's folded copy for EVA02, its sub-LN folded too).
    For Swin and VideoSwin the embedding is the patch mean's: the CLS
    token's, which the port's pipeline took before, is another vector."""
    kind, jcfg, params, model, _ = zoo
    jpipe = JaxPipeline(params, jcfg, batch_size=2, io_workers=2)
    jpipe.video_proc.data_format = "frame"
    tpipe = EmbeddingPipeline(model, model.cfg, batch_size=2, io_workers=2,
                              device="cpu")
    try:
        got = getattr(tpipe, method)(media[item])
        cls = tpipe._run(
            media[item],
            tpipe.image_proc if item == "image" else tpipe.video_procs["frame"],
            lambda m, x: m.contra_head("v", m.forward_vision_encoder(x)[
                :, :, 0].mean(dim=1)))
    finally:
        tpipe.close()
    want = getattr(jpipe, method)(media[item])
    assert tpipe.last_failures == jpipe.last_failures == [1]
    assert got.shape == (3, 32) and not got[1].any()
    close(got, want, MODEL_TOL)
    cls = cls / np.maximum(np.linalg.norm(cls, axis=-1, keepdims=True), 1e-30)
    gap = np.abs(np.delete(cls - want, 1, axis=0)).max()
    assert (gap > 1e-2) == (kind != "eva02")


def test_pooling_follows_the_tower():
    """`pool_vision_for_contra` and `pool_depth_for_contra`: the CLS token
    of each frame for EVA and CLIP, the mean of each frame's tokens for
    Swin and VideoSwin (mico.py:284-299), then the mean over frames."""
    from mico_tpu_torch.models import mico as tmico

    x = torch.randn(2, 3, 5, 4)
    for kind in TOWERS:
        cfg = zoo_configs(kind)[1]
        want = (x[:, :, 0] if kind == "eva02" else x.mean(dim=2)).mean(dim=1)
        assert torch.equal(tmico.pool_vision_for_contra(cfg, x), want)
        model = MiCo(cfg, device="cpu", init_weights=False)
        assert torch.equal(model.pool_vision_for_contra(x), want)
        assert torch.equal(model.pool_depth_for_contra(x), want)


@pytest.mark.parametrize("kind", ["swin", "videoswin"])
def test_native_npz_round_trips(tmp_path, kind):
    """A JAX-written native `.npz` of a Swin MiCo (its stages pickled as an
    object array of dicts holding lists of blocks) loads into the port;
    the port's own `ModelSaver` file loads back; `params_to_jax` gives
    JAX's nested lists."""
    from mico_tpu.train.checkpoints import save_pytree_npz
    from mico_tpu_torch.train import checkpoints as tck

    _, tcfg = zoo_configs(kind)
    model = MiCo(tcfg, device="cpu", seed=5)
    want = model.state_dict()
    tree = convert.params_to_jax(want, tcfg)
    layers = tree["vision_encoder"]["layers"]
    assert isinstance(layers, list) and isinstance(layers[0]["blocks"], list)
    save_pytree_npz(str(tmp_path / "jax.npz"), tree)
    loaded = tck.load_pytree_npz(str(tmp_path / "jax.npz"))
    assert isinstance(loaded["vision_encoder"]["layers"][1]["blocks"], list)
    sd = convert.params_from_jax(loaded, tcfg)
    assert all(torch.equal(sd[k], want[k]) for k in want)
    tck.ModelSaver(str(tmp_path / "run")).save(2, model)
    for path in (tmp_path / "run" / "ckpt" / "model_step_2.npz",
                 tmp_path / "jax.npz"):
        fresh = MiCo(tcfg, device="cpu", seed=9)
        tck.load_model_npz(str(path), fresh)
        assert all(torch.equal(fresh.state_dict()[k], want[k]) for k in want)


def test_released_checkpoint_refuses_a_swin_tower():
    """JAX's `mico_from_torch` reads the EVA layout alone: a `.pt` for a
    Swin MiCo raises, naming the tower."""
    from mico_tpu_torch.models.mico import mico_from_torch

    with pytest.raises(ValueError, match="vision tower 'videoswin_base'"):
        mico_from_torch({}, zoo_configs("videoswin")[1])


def _jax_vision_shapes(cfg) -> dict:
    shapes = jax.eval_shape(lambda: jm._init_vision_tower(
        jax.random.PRNGKey(0), cfg))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("vtype", sorted(
    set(jconfig.VISION_ENCODER_TYPES) | set(jconfig.ALT_VISION_DIMS)))
def test_every_vision_encoder_type_builds(vtype):
    """`MiCoConfig(vision_encoder_type=t)` builds weightless for every type
    of JAX's `VISION_ENCODER_TYPES` and `ALT_VISION_DIMS`, with JAX's
    vision_dim and, for the towers this slice adds, JAX's tower leaves."""
    tcfg = tconfig.MiCoConfig(vision_encoder_type=vtype)
    jcfg = jconfig.MiCoConfig(vision_encoder_type=vtype)
    assert tcfg.vision_dim == jcfg.vision_dim
    model = MiCo(tcfg, device="cpu", init_weights=False)
    got = {}
    for k, p in model.vision_encoder.state_dict().items():
        parts = k.split(".")
        if tcfg.is_eva and parts[0] == "blocks":
            got["blocks/" + parts[2]] = (int(parts[1]) + 1,) + tuple(p.shape)
        else:
            got["/".join(parts)] = tuple(p.shape)
    if vtype.startswith(("swin", "videoswin", "evaclip02_base",
                         "evaclip02_large")):
        assert got == _jax_vision_shapes(jcfg)
    assert model.contra_head_v.kernel.shape == (jcfg.vision_dim, 512)


def test_unknown_tower_override_raises():
    """An override of a tower MiCo does not build raises, as in the JAX
    package, naming the stand-alone encoders."""
    @dataclasses.dataclass(frozen=True)
    class ResNetConfig:
        width: int = 64

    cfg = tconfig.MiCoConfig(vision_encoder_type="resnet50",
                             vision_override=ResNetConfig())
    with pytest.raises(NotImplementedError, match="JAX package either"):
        cfg.vision_tower_config
