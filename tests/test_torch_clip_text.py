"""The port's CLIP text tower and two-tower CLIP
(`mico_tpu_torch/models/clip_text.py`) against `mico_tpu.models.clip_text`
on the CPU in fp32, on one tree of weights in JAX's layout (every leaf
perturbed) carried over by `convert.clip_from_jax`: the text tower pooled
and with all features, GELU and QuickGELU, at JAX's tiny `TXT_CFG`; the EOT-argmax pooling where a row
holds the EOT id twice; `clip_forward` on a tiny EVA01-style and a tiny
post-norm tower; the zero-shot classifier on a stub tokenizer;
`create_model`'s configs for all eight names; `clip_text_from_torch` and
`clip_from_torch` on a synthetic released state dict, the positional
embedding resized. Tolerance: `MODEL_TOL` (rtol = atol = 1e-4) for model
outputs, `OP_TOL` for converted leaves. On CPU tensors the image route
launches no kernel, and a CUDA request without a card raises."""

import dataclasses
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu import config as jconfig
from mico_tpu.models import clip_text as jct
from mico_tpu_torch import config as tconfig
from mico_tpu_torch.convert import clip_from_jax
from mico_tpu_torch.models import clip_text as tct

from torch_port_common import (MODEL_TOL, OP_TOL, _EVA, _EVA_LINEARS, close,
                               no_launch, t)

TXT = dict(context_length=24, vocab_size=130, width=32, heads=2, layers=2,
           output_dim=16)
EVA = dict(image_size=28, patch_size=14, layers=2, width=32, head_width=16,
           mlp_ratio=4.0, embed_dim=16)
SOT, EOT = TXT["vocab_size"] - 2, TXT["vocab_size"] - 1


def cfgs(quick_gelu=False, **eva):
    """((JAX vision, text), (port vision, text)) configs."""
    e = {**EVA, **eva}
    return ((jconfig.EvaVitConfig(**e),
             jct.ClipTextConfig(quick_gelu=quick_gelu, **TXT)),
            (tconfig.EvaVitConfig(**e),
             tct.ClipTextConfig(quick_gelu=quick_gelu, **TXT)))


def perturbed(tree, seed=0, scale=0.05):
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + scale * rng.standard_normal(
            np.shape(a)).astype(np.float32), tree)


# JAX's forwards jitted: one compile each beats op-by-op dispatch here
text_forward = jax.jit(jct.clip_text_forward, static_argnums=(1, 3))
clip_forward = jax.jit(jct.clip_forward, static_argnums=(1, 2))
# the tiny models: an EVA01-style tower with LayerScale, its post-norm
# twin, and the first with a QuickGELU text tower
KINDS = {"eva01": (False, {}), "postnorm": (False, dict(postnorm=True)),
         "quick_gelu": (True, {})}


def jax_tree(model):
    """The port's CLIP as JAX's `init_clip` tree: numpy leaves, the EVA
    blocks stacked, the text layers a list."""
    tree = {}
    for key, v in model.state_dict().items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy()
    blocks = tree["visual"]["blocks"]
    tree["visual"]["blocks"] = {
        name: np.stack([blocks[str(i)][name] for i in range(len(blocks))])
        for name in blocks["0"]}
    layers = tree["text"]["layers"]
    tree["text"]["layers"] = [layers[str(i)] for i in range(len(layers))]
    return tree


@functools.lru_cache(maxsize=None)
def build(kind):
    """(JAX CLIP params, JAX configs, the port's CLIP on the CPU): weights
    drawn by the port's init with every leaf perturbed, in JAX's tree (its
    structure and shapes checked against `init_clip`'s), carried back by
    `clip_from_jax`. The kinds share one tree (their configs change no
    leaf)."""
    quick_gelu, eva = KINDS[kind]
    (jv, jt), (tv, tt) = cfgs(quick_gelu, ls_init_value=0.1, **eva)
    if kind != "eva01":
        params = build("eva01")[0]
        return params, (jv, jt), clip_from_jax(params, tv, tt, device="cpu")
    params = perturbed(jax_tree(tct.CLIP(tv, tt, device="cpu", seed=0)))
    shapes = jax.eval_shape(lambda k: jct.init_clip(k, jv, jt),
                            jax.random.PRNGKey(0))
    assert jax.tree.structure(params) == jax.tree.structure(shapes)
    assert jax.tree.leaves(jax.tree.map(np.shape, params)) == \
        jax.tree.leaves(jax.tree.map(lambda s: s.shape, shapes))
    return params, (jv, jt), clip_from_jax(params, tv, tt, device="cpu")


def token_batch(rng, b, lengths):
    """(b, ctx) ids [SOT] words [EOT] 0-padded, words below EOT."""
    ids = np.zeros((b, TXT["context_length"]), np.int64)
    for i in range(b):
        n = lengths[i % len(lengths)]
        ids[i, 0] = SOT
        ids[i, 1:n - 1] = rng.integers(4, 100, n - 2)
        ids[i, n - 1] = EOT
    return ids


@pytest.fixture(params=["eva01", "quick_gelu"])
def text_models(request):
    return build(request.param)


@pytest.mark.parametrize("all_features", [False, True],
                         ids=["pooled", "all_features"])
def test_text_tower_matches_jax(text_models, all_features):
    params, (_, jt), model = text_models
    ids = token_batch(np.random.default_rng(0), 3, (11, 24, 5))
    want = text_forward(params["text"], jt, jnp.asarray(ids), all_features)
    got = tct.clip_text_forward(model.text, t(ids),
                                return_all_features=all_features)
    assert got.shape == ((3, 24, 32) if all_features else (3, 16))
    close(got, want, MODEL_TOL)


def test_eot_tie_pools_the_first(text_models):
    """A row holding the EOT id twice pools at the first, as jnp.argmax."""
    params, (_, jt), model = text_models
    ids = token_batch(np.random.default_rng(1), 2, (12,))
    ids[0, 4] = EOT                  # EOT at 4 and at 11
    want = text_forward(params["text"], jt, jnp.asarray(ids), False)
    got = tct.clip_text_forward(model.text, t(ids))
    close(got, want, MODEL_TOL)
    feats = tct.clip_text_forward(model.text, t(ids), return_all_features=True)
    close(got[0], feats[0, 4] @ model.text.text_projection, OP_TOL)


@pytest.fixture(params=["eva01", "postnorm"])
def clip_models(request):
    return build(request.param)


def test_clip_forward_matches_jax(clip_models):
    params, (jv, jt), model = clip_models
    rng = np.random.default_rng(2)
    px = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    ids = token_batch(rng, 2, (7, 13))
    img, txt, scale = clip_forward(params, jv, jt, jnp.asarray(px),
                                   jnp.asarray(ids))
    got = no_launch(lambda: tct.clip_forward(model, t(px), t(ids)))
    for g, w in zip(got, (img, txt, scale)):
        close(g, w, MODEL_TOL)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(got[0], dim=-1).numpy(), 1.0, rtol=1e-5)
    # the unfused plain route, unnormalized, is the same direction
    unnormed = tct.clip_encode_image(model, t(px), normalize=False,
                                     attn_impl="plain")
    close(unnormed / torch.linalg.vector_norm(unnormed, dim=-1,
                                              keepdim=True), got[0], OP_TOL)


class StubTokenizer:
    """Ids [SOT] 4 words [EOT] drawn from the prompts' crc32."""

    def __call__(self, texts, ctx):
        rng = np.random.default_rng(zlib.crc32("|".join(texts).encode()))
        ids = np.zeros((len(texts), ctx), np.int32)
        ids[:, 0] = SOT
        ids[:, 1:5] = rng.integers(4, 100, (len(texts), 4))
        ids[:, 5] = EOT
        return ids


def test_zero_shot_classifier_matches_jax(clip_models, monkeypatch):
    params, (_, jt), model = clip_models
    # JAX's text tower jitted inside JAX's classifier (compiled once)
    monkeypatch.setattr(jct, "clip_text_forward",
                        lambda p, c, ids, compute_dtype: text_forward(
                            p, c, ids, False))
    names = ["cat", "dog", "tpu"]
    templates = ("a photo of a {}.", "an image of a {}.")
    want = jct.build_zero_shot_classifier(params, jt, names, templates,
                                          tokenizer=StubTokenizer())
    got = tct.build_zero_shot_classifier(model, names, templates,
                                         tokenizer=StubTokenizer())
    assert got.shape == (3, 16) and got.dtype == torch.float32
    close(got, want, MODEL_TOL)


@pytest.mark.parametrize("name", sorted(jconfig.EVA_VIT_CONFIGS))
def test_create_model_configs_match_jax(name):
    jv, jt, jp = jct.create_model(name)
    tv, tt, model = tct.create_model(name)
    assert model is None and jp is None
    assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    assert tct.EVA_TEXT_CONFIGS[name] == tt


def test_create_model_sizes_and_refusals(monkeypatch):
    v336, _, _ = tct.create_model("EVA02-CLIP-L-14", image_size=336)
    assert v336.image_size == 336 and v336.grid_size == 24
    with pytest.raises(KeyError):
        tct.create_model("nope")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, _), (tv, tt) = cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        tct.CLIP(tv, tt)
    with pytest.raises(RuntimeError, match="CUDA"):
        tct.create_model("EVA01-CLIP-g-14", seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        clip_from_jax({}, tv, tt)
    model = tct.CLIP(tv, tt, device="cpu", seed=3)
    assert model.logit_scale.item() == pytest.approx(np.log(1 / 0.07))
    assert all(p.device.type == "cpu" for p in model.parameters())


def released_state_dict(params, grid):
    """A CustomCLIP state dict (torch layouts, fp32 numpy) of JAX's CLIP
    params, its positional embedding drawn for a `grid` × `grid` patch
    grid."""
    v, x = params["visual"], params["text"]
    sd = {}
    k = v["patch_embed"]["kernel"]
    p = int(round((k.shape[0] / 3) ** 0.5))
    sd["visual.patch_embed.proj.weight"] = k.T.reshape(-1, 3, p, p)
    sd["visual.patch_embed.proj.bias"] = v["patch_embed"]["bias"]
    sd["visual.cls_token"] = v["cls_token"]
    w = v["pos_embed"].shape[-1]
    sd["visual.pos_embed"] = np.random.default_rng(5).standard_normal(
        (1, grid * grid + 1, w)).astype(np.float32)
    sd["visual.norm.weight"], sd["visual.norm.bias"] = v["norm_w"], v["norm_b"]
    sd["visual.head.weight"] = v["head"]["kernel"].T
    sd["visual.head.bias"] = v["head"]["bias"]
    for i in range(v["blocks"]["qkv_w"].shape[0]):
        for leaf, name in _EVA.items():
            sd[f"visual.blocks.{i}.{name}"] = v["blocks"][leaf][i]
        for leaf, name in _EVA_LINEARS.items():
            sd[f"visual.blocks.{i}.{name}"] = v["blocks"][leaf][i].T
        for g in ("gamma_1", "gamma_2"):
            sd[f"visual.blocks.{i}.{g}"] = v["blocks"][g][i]
    for name in ("token_embedding", "positional_embedding"):
        sd[f"text.{name}" + (".weight" if name[0] == "t" else "")] = x[name]
    sd["text.ln_final.weight"] = x["ln_final_w"]
    sd["text.ln_final.bias"] = x["ln_final_b"]
    sd["text.text_projection"] = x["text_projection"]
    for i, lp in enumerate(x["layers"]):
        r = f"text.transformer.resblocks.{i}."
        sd[r + "attn.in_proj_weight"] = lp["qkv_w"].T
        sd[r + "attn.in_proj_bias"] = lp["qkv_b"]
        sd[r + "attn.out_proj.weight"] = lp["proj_w"].T
        sd[r + "attn.out_proj.bias"] = lp["proj_b"]
        for n in (1, 2):
            sd[r + f"ln_{n}.weight"] = lp[f"ln{n}_w"]
            sd[r + f"ln_{n}.bias"] = lp[f"ln{n}_b"]
        sd[r + "mlp.c_fc.weight"], sd[r + "mlp.c_fc.bias"] = (lp["fc_w"].T,
                                                              lp["fc_b"])
        sd[r + "mlp.c_proj.weight"] = lp["out_w"].T
        sd[r + "mlp.c_proj.bias"] = lp["out_b"]
    sd["logit_scale"] = np.float32(4.2)
    return {k: np.array(a, np.float32, order="C") for k, a in sd.items()}


def same_leaves(port_tree, jax_tree):
    """The port's tree (torch leaves) holds JAX's leaves, within OP_TOL."""
    def leaves(tree):
        return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
                for p, a in jax.tree_util.tree_leaves_with_path(tree)}

    got = leaves(jax.tree.map(lambda a: a.numpy(), port_tree))
    want = leaves(jax_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **OP_TOL)


def test_from_torch_matches_jax(clip_models):
    """clip_from_torch (pos-embed resized from a 3 × 3 grid) and the bare
    tower's clip_text_from_torch give JAX's trees; the loaded CLIP gives
    JAX's features on its converted params."""
    params, (jv, jt), _ = clip_models
    (_, _), (tv, tt) = cfgs(postnorm=jv.postnorm, ls_init_value=0.1)
    sd = released_state_dict(params, grid=3)
    tsd = {k: torch.from_numpy(a) for k, a in sd.items()}
    jtree = jct.clip_from_torch(sd, jv, jt)
    ttree = tct.clip_from_torch(tsd, tv, tt)
    same_leaves(ttree, jtree)
    bare = {k[len("text."):]: a for k, a in sd.items()
            if k.startswith("text.")}
    same_leaves(tct.clip_text_from_torch(
        {k: torch.from_numpy(a) for k, a in bare.items()}, tt),
        jct.clip_text_from_torch(bare, jt))
    model = clip_from_jax(ttree, tv, tt, device="cpu")
    rng = np.random.default_rng(4)
    px = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    ids = token_batch(rng, 2, (9, 6))
    img, txt, scale = clip_forward(jtree, jv, jt, jnp.asarray(px),
                                   jnp.asarray(ids))
    for g, w in zip(tct.clip_forward(model, t(px), t(ids)), (img, txt, scale)):
        close(g, w, MODEL_TOL)
