"""The port's Swin and VideoSwin towers (`mico_tpu_torch/models/swin.py`)
against `mico_tpu.models.swin` on the CPU in fp32: the host-built relative
index and shifted-window mask, the 2D forward and `swin_encode_audio` at
56 px (embed 16, depths (2, 2): each stage runs a shifted block, and stage
2's 7 x 7 grid is no larger than the window, so its shift is 0), VideoSwin
over 4 frames with window (4, 7, 7) at 56 px and at a non-divisible 60 px
(the pad to window multiples), the training regularizers' contract, and
the released-layout converters against JAX's.

Weights are a seeded port init with every leaf perturbed by N(0, 0.05);
JAX gets the same tree through `convert.params_to_jax`. Each JAX forward
is jitted (its mask cache filled first: JAX builds the mask with jnp,
which a trace cannot), once per module. Tolerances: MODEL_TOL (1e-4), exact
for the index, the mask and the converted trees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.models import swin as jswin
from mico_tpu_torch import config as tconfig
from mico_tpu_torch import convert
from mico_tpu_torch.models import swin as tswin

from torch_port_common import MODEL_TOL, close, t

SWIN = dict(img_size=56, embed_dim=16, depths=(2, 2), num_heads=(2, 2),
            window_size=7)
VIDEO = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2),
             window_size=(4, 7, 7))


def perturb(tower: torch.nn.Module, seed: int) -> torch.nn.Module:
    rng = np.random.default_rng(seed + 100)
    with torch.no_grad():
        for p in tower.parameters():
            p.add_(t(0.05 * rng.standard_normal(p.shape).astype(np.float32)))
    return tower


def jax_tree(tower: torch.nn.Module) -> dict:
    """JAX's nested tree (stages and blocks as lists) of a port tower."""
    cfg = tconfig.MiCoConfig(vision_encoder_type="swin",
                             vision_override=tower.cfg)
    sd = {f"vision_encoder.{k}": v for k, v in tower.state_dict().items()}
    return convert.params_to_jax(sd, cfg)["vision_encoder"]


def warm_jax_masks(cfg, dims, video: bool) -> None:
    """Fill JAX's `shift_attn_mask` cache for every stage of a forward on
    a grid of `dims` patches (JAX builds it eagerly with jnp, which a jit
    trace cannot)."""
    ws = tuple(cfg.window_size) if video else (cfg.window_size,) * 2
    dims = list(dims)
    for _ in range(cfg.num_layers):
        window = tuple(min(w, d) for w, d in zip(ws, dims))
        shift = tuple(0 if d <= w else w0 // 2
                      for w0, w, d in zip(ws, window, dims))
        padded = tuple(-(-d // w) * w for d, w in zip(dims, window))
        jswin.shift_attn_mask(padded, window, shift)
        half = [-(-d // 2) for d in dims]
        dims = [dims[0], *half[1:]] if video else half


@pytest.fixture(scope="module")
def swin2d():
    """(port tower, JAX cfg, JAX tree) of the tiny 2D Swin."""
    tower = perturb(tswin.init_swin(tswin.SwinConfig(**SWIN), seed=0), 0)
    jcfg = jswin.SwinConfig(**SWIN)
    warm_jax_masks(jcfg, jcfg.patches_resolution, video=False)
    return tower, jcfg, jax_tree(tower)


@pytest.fixture(scope="module")
def video():
    tower = perturb(tswin.init_videoswin(tswin.VideoSwinConfig(**VIDEO),
                                         seed=1), 1)
    jcfg = jswin.VideoSwinConfig(**VIDEO)
    return tower, jcfg, jax_tree(tower)


# ---------------------------------------------------------------------------
# host-built index and mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [(7, 7), (4, 7, 7), (2, 3)])
def test_relative_position_index_matches_jax(window):
    got = tswin.relative_position_index(window)
    assert np.array_equal(got, jswin.relative_position_index(window))
    assert got.max() == np.prod([2 * w - 1 for w in window]) - 1


@pytest.mark.parametrize("dims,window,shift", [
    ((14, 14), (7, 7), (3, 3)), ((7, 7), (7, 7), (0, 0)),
    ((4, 14, 14), (4, 7, 7), (2, 3, 3)), ((4, 14, 14), (4, 7, 7), (0, 3, 3)),
    ((8, 21, 14), (4, 7, 7), (2, 3, 3))])
def test_shift_attn_mask_matches_jax(dims, window, shift):
    """The 9-region (2D) and 27-region (3D) masks, -100 across regions;
    None without a shift."""
    got = tswin.shift_attn_mask(dims, window, shift)
    want = jswin.shift_attn_mask(dims, window, shift)
    if want is None:
        assert got is None
        return
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert set(np.unique(got)) <= {0.0, -100.0}


def test_window_partition_round_trip():
    x = torch.randn(2, 8, 14, 21, 3)
    wins = tswin.window_partition(x, (4, 7, 7))
    assert wins.shape == (2 * 2 * 2 * 3, 4, 7, 7, 3)
    assert torch.equal(wins[0], x[0, :4, :7, :7])
    assert torch.equal(tswin.window_reverse(wins, (4, 7, 7), 2, (8, 14, 21)),
                       x)


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------


def test_swin_forward_and_audio_match_jax(rng, swin2d):
    """Images (2, 3, 56, 56) → (2, 49, 32) tokens, and a (2, 1, 56, 56)
    spectrogram through `swin_encode_audio`, in one jitted JAX call."""
    tower, jcfg, tree = swin2d
    px = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    spec = rng.standard_normal((2, 1, 56, 56)).astype(np.float32)
    want = jax.jit(lambda p, x, s: (
        jswin.swin_forward_features(p, jcfg, x),
        jswin.swin_encode_audio(p, jcfg, s)))(tree, jnp.asarray(px),
                                              jnp.asarray(spec))
    got = tswin.swin_forward_features(tower, t(px))
    assert got.shape == (2, 49, 32)
    close(got, want[0], MODEL_TOL)
    close(tswin.swin_encode_audio(tower, t(spec)), want[1], MODEL_TOL)


@pytest.mark.parametrize("res", [56, 60])
def test_videoswin_forward_matches_jax(rng, video, res):
    """4 frames → (2, 32, 4, H', W'): time padded by one frame and patched
    by slabs of 2, H and W padded to the patch and then the window (60 px:
    15 x 15 patches over windows of 7), merged over H and W only."""
    tower, jcfg, tree = video
    x = rng.standard_normal((2, 3, 4, res, res)).astype(np.float32)
    grid = -(-res // 4)
    warm_jax_masks(jcfg, (4, grid, grid), video=True)
    want = jax.jit(lambda p, v: jswin.videoswin_forward(p, jcfg, v))(
        tree, jnp.asarray(x))
    got = tswin.videoswin_forward(tower, t(x))
    assert got.shape == (2, 32, 4, -(-grid // 2), -(-grid // 2))
    close(got, want, MODEL_TOL)


@pytest.mark.parametrize("kind", ["swin", "videoswin"])
def test_regularizers_contract(kind):
    """No generator gives the evaluation graph; a generator with every
    rate 0 draws nothing and changes nothing; positive rates (drop path
    0.5, dropout 0.2, attention dropout 0.2) change the output, the same
    way for the same seed, and gradients flow."""
    import dataclasses

    if kind == "swin":
        cfg = tswin.SwinConfig(**SWIN)
        fwd, x = tswin.swin_forward_features, torch.randn(1, 3, 56, 56)
        tower = tswin.init_swin(dataclasses.replace(cfg, drop_path_rate=0.0))
    else:
        cfg = tswin.VideoSwinConfig(**VIDEO)
        fwd, x = tswin.videoswin_forward, torch.randn(1, 3, 2, 28, 28)
        tower = tswin.init_videoswin(dataclasses.replace(cfg,
                                                         drop_path_rate=0.0))
    evaluated = fwd(tower, x)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(fwd(tower, x, train_rng=gen), evaluated)
    tower.cfg = dataclasses.replace(cfg, drop_path_rate=0.5, drop_rate=0.2,
                                    attn_drop_rate=0.2)
    assert torch.equal(fwd(tower, x), evaluated)
    tower.requires_grad_(True)
    a = fwd(tower, x, train_rng=torch.Generator().manual_seed(1))
    b = fwd(tower, x, train_rng=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.allclose(a, evaluated)
    a.square().sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in tower.parameters())


def test_drop_path_schedule_and_scaling():
    """Per-sample keep over the leading axis, kept samples scaled by
    1 / keep, the linear 0 → rate schedule over all blocks of every
    stage."""
    y = torch.ones(400, 3, 2)
    out = tswin.drop_path(y, 0.25, torch.Generator().manual_seed(0))
    per = out[:, 0, 0]
    kept = per[per != 0]
    assert torch.equal(kept, torch.full_like(kept, 1 / 0.75))
    assert torch.equal(out, per[:, None, None].expand_as(out))
    assert 0.6 < (per > 0).float().mean().item() < 0.9
    assert torch.equal(tswin.drop_path(y, 0.0, torch.Generator()), y)
    assert torch.equal(tswin.drop_path(y, 0.5, None), y)


# ---------------------------------------------------------------------------
# the released-layout converters and the yaml config
# ---------------------------------------------------------------------------


def released_swin(rng, cfg, video: bool) -> dict:
    """A synthetic reference state dict of a Swin (2D conv patch embed) or
    VideoSwin (3D) tower, with its relative tables and downsamples."""
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    e, c = cfg.embed_dim, cfg.in_chans
    ws = tuple(cfg.window_size) if video else (cfg.window_size,) * 2
    patch = tuple(cfg.patch_size) if video else (cfg.patch_size,) * 2
    sd = {"patch_embed.proj.weight": r(e, c, *patch),
          "patch_embed.proj.bias": r(e), "patch_embed.norm.weight": r(e),
          "patch_embed.norm.bias": r(e),
          "norm.weight": r(cfg.num_features), "norm.bias": r(cfg.num_features)}
    nrel = int(np.prod([2 * w - 1 for w in ws]))
    for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        dim = e * 2 ** i
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}."
            for n in ("norm1", "norm2"):
                sd[b + n + ".weight"], sd[b + n + ".bias"] = r(dim), r(dim)
            sd[b + "attn.qkv.weight"] = r(3 * dim, dim)
            sd[b + "attn.qkv.bias"] = r(3 * dim)
            sd[b + "attn.proj.weight"], sd[b + "attn.proj.bias"] = (
                r(dim, dim), r(dim))
            sd[b + "attn.relative_position_bias_table"] = r(nrel, heads)
            sd[b + "mlp.fc1.weight"], sd[b + "mlp.fc1.bias"] = (
                r(4 * dim, dim), r(4 * dim))
            sd[b + "mlp.fc2.weight"], sd[b + "mlp.fc2.bias"] = (
                r(dim, 4 * dim), r(dim))
        if i < cfg.num_layers - 1:
            d = f"layers.{i}.downsample."
            sd[d + "norm.weight"], sd[d + "norm.bias"] = r(4 * dim), r(4 * dim)
            sd[d + "reduction.weight"] = r(2 * dim, 4 * dim)
    return sd


@pytest.mark.parametrize("kind", ["swin", "videoswin"])
def test_converters_match_jax(kind):
    """`swin_from_torch` / `videoswin_from_torch` give JAX's tree leaf for
    leaf (the conv kernels as matmul kernels in the forwards' orders), and
    the tree fills every parameter of the port's tower."""
    video = kind == "videoswin"
    if video:
        tcfg, jcfg = tswin.VideoSwinConfig(**VIDEO), jswin.VideoSwinConfig(
            **VIDEO)
    else:
        tcfg, jcfg = tswin.SwinConfig(**SWIN), jswin.SwinConfig(**SWIN)
    sd = released_swin(np.random.default_rng(7), tcfg, video)
    convert_j = jswin.videoswin_from_torch if video else jswin.swin_from_torch
    convert_t = tswin.videoswin_from_torch if video else tswin.swin_from_torch
    want = convert._flatten(jax.tree.map(np.asarray, convert_j(sd, jcfg)))
    got = convert._flatten(convert_t({k: t(v) for k, v in sd.items()}, tcfg))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    tower = (tswin.VideoSwinTransformer if video else tswin.SwinTransformer)(
        tcfg, tswin.Init(None, meta=True))
    tower.load_state_dict({k.replace("/", "."): v.contiguous()
                           for k, v in got.items()}, strict=True, assign=True)


def test_config_from_yaml_matches_jax(tmp_path):
    path = tmp_path / "swin.yaml"
    path.write_text("DATA:\n  IMG_SIZE: 224\nMODEL:\n  SWIN:\n"
                    "    EMBED_DIM: 128\n    DEPTHS: [2, 2, 18, 2]\n"
                    "    NUM_HEADS: [4, 8, 16, 32]\n    WINDOW_SIZE: 7\n")
    got = tswin.swin_config_from_yaml(str(path))
    assert got == tswin.SWIN_CONFIGS["swin_base_patch4_window7_224_22k"]
    assert vars(got) == vars(jswin.swin_config_from_yaml(str(path)))
