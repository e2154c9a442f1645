"""VAST's separate audio towers in the port (`mico_tpu_torch/models/audio.py`)
against `mico_tpu.models.audio` on the CPU in fp32: BEATs and AST forwards,
BEATs' bucket index, gated relative bias and positional conv, the released
state-dict converters, and the tower's gradients at rates 0 with the
layer-wise decay against `jax.grad`. MiCo with a tower is
`tests/test_torch_audio_mico.py`'s.

The tiny towers are 2 layers, 64 wide. JAX's params are perturbed (every
leaf plus N(0, 0.05)) so that LN affines, biases and the gates are not
trivial."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.models import audio as jaudio
from mico_tpu_torch import convert
from mico_tpu_torch.models import audio as taudio
from mico_tpu_torch.models._params import Init

from torch_port_common import MODEL_TOL, OP_TOL, close, t, to_numpy

BEATS = dict(embed_dim=32, encoder_layers=2, encoder_embed_dim=64,
             encoder_ffn_embed_dim=128, encoder_attention_heads=2,
             conv_pos=16, conv_pos_groups=4)
AST = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
           intermediate_size=128, audio_melbins=16, audio_target_length=32)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0,
                  activation_dropout=0.0, encoder_layerdrop=0.0)


def tower_configs(kind: str, **over):
    """(JAX tower config, the port's) of the tiny tower."""
    kw = {**(BEATS if kind == "beats" else AST), **over}
    name = "BeatsConfig" if kind == "beats" else "AstConfig"
    return getattr(jaudio, name)(**kw), getattr(taudio, name)(**kw)


def perturb(tree, seed: int, scale: float = 0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + scale * rng.standard_normal(
            a.shape).astype(np.float32)), tree)


def port_tower(tcfg, params):
    """The port's tower holding a JAX tower tree."""
    cls = (taudio.BeatsEncoder if isinstance(tcfg, taudio.BeatsConfig)
           else taudio.AstEncoder)
    model = cls(tcfg, Init(None, meta=True))
    sd = {k.replace("/", "."): torch.from_numpy(np.array(v, np.float32))
          for k, v in convert._flatten(to_numpy(params)).items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model


# JAX's forwards, jitted: one compile per shape instead of one per op
JAX_FORWARD = {"beats": jax.jit(jaudio.beats_forward, static_argnums=1),
               "ast": jax.jit(jaudio.ast_forward, static_argnums=1)}
TORCH_FORWARD = {"beats": taudio.beats_forward, "ast": taudio.ast_forward}


@functools.lru_cache(maxsize=None)
def _tower_params(kind: str, seed: int, over: tuple):
    jcfg, _ = tower_configs(kind, **dict(over))
    init = jaudio.init_beats if kind == "beats" else jaudio.init_ast
    return perturb(jax.jit(init, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg), seed + 7)


def towers(kind: str, seed: int = 0, **over):
    """(JAX params, JAX config, the port's tower holding them) of the tiny
    tower; the params are drawn once per (kind, seed, overrides)."""
    jcfg, tcfg = tower_configs(kind, **over)
    params = _tower_params(kind, seed, tuple(sorted(over.items())))
    return params, jcfg, port_tower(tcfg, params)


# ---------------------------------------------------------------------------
# BEATs and AST alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 32, 16), (3, 64, 48), (2, 70, 37)])
@pytest.mark.parametrize("gru", [True, False])
def test_beats_forward_matches_jax(rng, shape, gru):
    """Tokens of 2 to 12 patches, a ragged trailing edge (70 x 37), with
    and without the gated bias."""
    params, jcfg, model = towers("beats", gru_rel_pos=gru)
    x = rng.standard_normal(shape).astype(np.float32)
    want = JAX_FORWARD["beats"](params, jcfg, jnp.asarray(x))
    got = taudio.beats_forward(model, t(x))
    assert got.shape == (shape[0], (shape[1] // 16) * (shape[2] // 16), 64)
    close(got, want, MODEL_TOL)


@pytest.mark.parametrize("shape", [(2, 16, 32), (3, 20, 35)])
def test_ast_forward_matches_jax(rng, shape):
    params, jcfg, model = towers("ast")
    x = rng.standard_normal(shape).astype(np.float32)
    want = JAX_FORWARD["ast"](params, jcfg, jnp.asarray(x))
    got = taudio.ast_forward(model, t(x))
    assert got.shape == (shape[0], 3, 64)
    close(got, want, MODEL_TOL)


@pytest.mark.parametrize("n,buckets,distance", [
    (1, 320, 800), (7, 320, 800), (300, 320, 800), (1200, 320, 800),
    (90, 32, 64)])
def test_bucket_index_matches_jax(n, buckets, distance):
    got = taudio.rel_bucket_index(n, buckets, distance)
    np.testing.assert_array_equal(
        got, jaudio._rel_bucket_index(n, buckets, distance))
    assert got.min() >= 0 and got.max() < buckets


@pytest.mark.parametrize("gru", [True, False])
def test_gated_bias_attention_matches_jax(rng, gru):
    """One layer's attention over a given (H, N, N) bias, with and without
    the `gru_rel_pos` gate (`grep_a` perturbed off 1)."""
    params, jcfg, model = towers("beats", gru_rel_pos=gru)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    bias = rng.standard_normal((2, 9, 9)).astype(np.float32)
    want, _ = jaudio._beats_attention(params["layers"][1], jnp.asarray(x),
                                      jcfg, jnp.asarray(bias))
    got = taudio.beats_attention(model.layers[1], t(x), model.cfg, t(bias))
    close(got, want, OP_TOL)
    # and the bias the tower gathers for 9 tokens
    idx = jaudio._rel_bucket_index(9, jcfg.num_buckets, jcfg.max_distance)
    want_bias = np.asarray(params["rel_bias_table"])[idx.reshape(-1)]
    close(taudio.beats_position_bias(model, 9),
          want_bias.reshape(9, 9, 2).transpose(2, 0, 1), dict(rtol=0, atol=0))


@pytest.mark.parametrize("k,groups", [(16, 4), (15, 4), (128, 16)])
def test_pos_conv_matches_jax(rng, k, groups):
    """The grouped conv with the SamePad trim (even kernel) and without
    (odd), and at the AS2M geometry (k 128, 16 groups)."""
    params, jcfg, model = towers("beats", conv_pos=k, conv_pos_groups=groups)
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    want = jaudio._pos_conv(params, jnp.asarray(x), jcfg)
    got = taudio.beats_pos_conv(model, t(x))
    assert got.shape == (2, 11, 64)
    close(got, want, OP_TOL)


def _beats_release(rng, cfg, k_bias: bool) -> dict:
    """A state dict in BEATs' released layout at the tiny geometry (the
    patch bias with `conv_bias`, the projection when the widths differ)."""
    e, c, f, h = (cfg.encoder_embed_dim, cfg.embed_dim,
                  cfg.encoder_ffn_embed_dim, cfg.encoder_attention_heads)
    w = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    sd = {"patch_embedding.weight": w(c, 1, 16, 16),
          "layer_norm.weight": w(c), "layer_norm.bias": w(c),
          "encoder.pos_conv.0.weight_v": w(e, e // cfg.conv_pos_groups,
                                           cfg.conv_pos),
          "encoder.pos_conv.0.weight_g": w(1, 1, cfg.conv_pos),
          "encoder.pos_conv.0.bias": w(e),
          "encoder.layer_norm.weight": w(e), "encoder.layer_norm.bias": w(e),
          "encoder.layers.0.self_attn.relative_attention_bias.weight":
              w(cfg.num_buckets, h)}
    if cfg.conv_bias:
        sd["patch_embedding.bias"] = w(c)
    if c != e:
        sd.update({"post_extract_proj.weight": w(e, c),
                   "post_extract_proj.bias": w(e)})
    for i in range(cfg.encoder_layers):
        p = f"encoder.layers.{i}."
        for name, (o, n) in {"self_attn.q_proj": (e, e),
                             "self_attn.k_proj": (e, e),
                             "self_attn.v_proj": (e, e),
                             "self_attn.out_proj": (e, e),
                             "fc1": (f, e), "fc2": (e, f)}.items():
            sd[f"{p}{name}.weight"] = w(o, n)
            if name != "self_attn.k_proj" or k_bias:
                sd[f"{p}{name}.bias"] = w(o)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{p}{ln}.weight"], sd[f"{p}{ln}.bias"] = w(e), w(e)
        sd[f"{p}self_attn.grep_linear.weight"] = w(8, cfg.head_dim)
        sd[f"{p}self_attn.grep_linear.bias"] = w(8)
        sd[f"{p}self_attn.grep_a"] = w(1, h, 1, 1)
    return sd


def _ast_release(rng, cfg) -> dict:
    h, i = cfg.hidden_size, cfg.intermediate_size
    w = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    sd = {"audio_embeddings.first_conv.weight": w(h, 1, 16, 16),
          "audio_embeddings.first_conv.bias": w(h),
          "audio_embeddings.cls_token": w(1, 1, h),
          "audio_embeddings.position_embeddings.weight":
              w(cfg.tokens_per_frame + 1, h),
          "audio_encoder.last_layernorm.weight": w(h),
          "audio_encoder.last_layernorm.bias": w(h)}
    for n in range(cfg.num_hidden_layers):
        p = f"audio_encoder.layer.{n}."
        for j in range(4):
            sd[f"{p}attention.linears.{j}.weight"] = w(h, h)
            sd[f"{p}attention.linears.{j}.bias"] = w(h)
        sd[f"{p}ff_layer.linear1.weight"] = w(i, h)
        sd[f"{p}ff_layer.linear1.bias"] = w(i)
        sd[f"{p}ff_layer.linear2.weight"] = w(h, i)
        sd[f"{p}ff_layer.linear2.bias"] = w(h)
        for ln in ("layernorm1", "layernorm2"):
            sd[f"{p}{ln}.weight"], sd[f"{p}{ln}.bias"] = w(h), w(h)
    return sd


@pytest.mark.parametrize("kind,k_bias,over", [
    ("beats", True, dict(conv_bias=True)),
    ("beats", False, dict(embed_dim=64)), ("ast", True, {})])
def test_released_state_dicts_convert_as_jax(rng, kind, k_bias, over):
    """`beats_from_torch` / `ast_from_torch` on a state dict written here
    (torch tensors; BEATs with a patch bias and the projection, then
    without them and without k_proj's bias): every leaf as JAX's converter
    gives it, and the tower built on it computes JAX's tokens."""
    jcfg, tcfg = tower_configs(kind, **over)
    if kind == "beats":
        sd = _beats_release(rng, jcfg, k_bias)
        want = jaudio.beats_from_torch(sd, jcfg)
        got = taudio.beats_from_torch(
            {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    else:
        sd = _ast_release(rng, jcfg)
        want = jaudio.ast_from_torch(sd, jcfg)
        got = taudio.ast_from_torch(
            {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    flat_got, flat_want = convert._flatten(got), convert._flatten(want)
    assert set(flat_got) == set(flat_want)
    for key, leaf in flat_want.items():
        close(flat_got[key], leaf, OP_TOL)
    model = port_tower(tcfg, got)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    close(TORCH_FORWARD[kind](model, t(x)),
          JAX_FORWARD[kind](want, jcfg, jnp.asarray(x)),
          dict(rtol=1e-4, atol=1e-3))


@pytest.mark.parametrize("kind", ["beats", "ast"])
def test_tower_gradients_match_jax(rng, kind):
    """Every parameter's gradient of a fixed projection of the tokens, on
    the training route with every rate 0 (BEATs with the layer-wise
    gradient decay at 0.5), against `jax.grad`."""
    over = (dict(NO_DROPOUT, layer_wise_gradient_decay_ratio=0.5)
            if kind == "beats" else dict(hidden_dropout=0.0,
                                         attention_dropout=0.0))
    params, jcfg, model = towers(kind, seed=2, **over)
    x = rng.standard_normal((2, 48, 32) if kind == "beats"
                            else (2, 16, 32)).astype(np.float32)
    n_tok = 6 if kind == "beats" else 3
    proj = rng.standard_normal((2, n_tok, 64)).astype(np.float32)

    def jloss(p):
        out = JAX_FORWARD[kind](p, jcfg, jnp.asarray(x),
                                train_rng=jax.random.PRNGKey(1))
        return jnp.sum(out * proj)

    want = convert._flatten(to_numpy(jax.jit(jax.grad(jloss))(params)))
    for p in model.parameters():
        p.requires_grad_(True)
    out = TORCH_FORWARD[kind](model, t(x),
                              train_rng=torch.Generator().manual_seed(1))
    (out * t(proj)).sum().backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == {k.replace("/", ".") for k in want}
    for key, g in want.items():
        close(got[key.replace("/", ".")], g, MODEL_TOL)
    if kind == "beats":      # the decay scales the patch embed's gradient
        assert np.abs(want["patch_w"]).max() > 0


def test_layer_decay_is_the_identity_forward(rng):
    """The gradient decay changes no forward value, and LayerDrop at rate
    1 skips every layer (the tokens after the input LN)."""
    params, jcfg, model = towers(
        "beats", seed=2, **dict(NO_DROPOUT, layer_wise_gradient_decay_ratio=0.5))
    x = t(rng.standard_normal((2, 32, 32)).astype(np.float32))
    evald = taudio.beats_forward(model, x)
    trained = taudio.beats_forward(model, x,
                                   train_rng=torch.Generator().manual_seed(0))
    torch.testing.assert_close(trained, evald, rtol=0, atol=0)
    skip = taudio.BeatsEncoder(dataclasses.replace(model.cfg,
                                                   encoder_layerdrop=1.0),
                               Init(None, meta=True))
    skip.load_state_dict(model.state_dict(), assign=True)
    out = taudio.beats_forward(skip, x,
                               train_rng=torch.Generator().manual_seed(0))
    want = JAX_FORWARD["beats"](
        dict(params, layers=[]), dataclasses.replace(jcfg, encoder_layers=0),
        jnp.asarray(x.numpy()))
    close(out, want, MODEL_TOL)


@pytest.mark.parametrize("kind", ["beats", "ast"])
def test_init_draws_jax_shapes_from_a_seed(kind):
    """`init_beats` / `init_ast` draw JAX's tree (every leaf's shape) from
    a seed: the same seed gives the same weights, another seed others; LN
    weights and `grep_a` 1, biases 0, weights at std 0.02."""
    jcfg, tcfg = tower_configs(kind)
    init = {"beats": (jaudio.init_beats, taudio.init_beats),
            "ast": (jaudio.init_ast, taudio.init_ast)}[kind]
    want = jax.eval_shape(lambda: init[0](jax.random.PRNGKey(0), jcfg))
    a, b, c = (init[1](tcfg, seed=s).state_dict() for s in (3, 3, 4))
    shapes = {k: tuple(v.shape) for k, v in a.items()}
    assert shapes == {
        ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                 for p in path): tuple(v.shape)
        for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.q_w"], c["layers.0.q_w"])
    assert torch.equal(a["layers.1.ln2_scale"], torch.ones(64))
    assert not a["layers.0.fc1_b"].any()
    assert abs(a["layers.0.fc1_w"].std().item() - 0.02) < 2e-3
