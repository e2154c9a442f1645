"""EVA02's tower features in the port's EVA ViT (`mico_tpu_torch/models/
eva_vit.py`: RoPE, SwiGLU, sub-LN, per-block and shared relative-position
bias) against `mico_tpu.models.eva_vit` on the CPU in fp32: the RoPE and
relative-position helpers, the forward on the flash and plain routes,
canonical and folded, with each route's wrapper as JAX's routing dictates
(K2 for RoPE or a bias, K5 for sub-LN alone, K1 for SwiGLU alone), the
training route's gradients against `jax.grad`, and the released-layout
converter against JAX's `eva_vit_from_torch`.

The tower is the tiny one (28 px, patch 14: 5 tokens; 2 layers, width 64,
2 heads of 32). Its 25 scores sit below the 64·64 under which both
packages' `multi_head_attention` takes plain math, so the port's side of
the flash-route tests lowers that bound to 0: its blocks call K2's wrapper
(the plain twin on the CPU, which `test_torch_flash_attention.py` holds to
the Pallas `_flash` in interpret mode), held here to JAX's flash route,
which at this size is its plain math. Weights are a seeded port init with
every leaf perturbed by N(0, 0.05); JAX gets the same tree through
`convert.params_to_jax`. Each configuration's JAX references (both routes,
canonical and folded, and the training route's gradients) are one jitted
call (a module fixture). Tolerances: MODEL_TOL (1e-4 relative and
absolute), exact for the host-built tables and the converted trees."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu import config as jconfig
from mico_tpu import convert as jconvert
from mico_tpu.models import eva_vit as jvit
from mico_tpu_torch import config as tconfig
from mico_tpu_torch import convert
from mico_tpu_torch.models import eva_vit as tvit
from mico_tpu_torch.ops import attention as tattn
from mico_tpu_torch.ops import flash_attention as tfa

from torch_port_common import MODEL_TOL, TINY, close, t

EVA = dict(TINY["eva"])
# the flag grid: the registry's EVA02 (RoPE + SwiGLU + sub-LN), per-block and
# shared relative bias, sub-LN alone, SwiGLU alone
FLAGS = {
    "eva02": dict(rope=True, naiveswiglu=True, subln=True, intp_freq=True,
                  mlp_ratio=2.6667),
    "rel-bias": dict(use_rel_pos_bias=True),
    "shared-bias": dict(use_shared_rel_pos_bias=True),
    "subln": dict(subln=True),
    "swiglu": dict(naiveswiglu=True, mlp_ratio=2.6667),
}
# the wrapper each block's flash attention calls, as JAX's `_block` routes
# (eva_vit.py:298-369, 438-449): inference, and training
ROUTE = {"eva02": ("flash_attention", "flash_attention"),
         "rel-bias": ("flash_attention", "flash_attention"),
         "shared-bias": ("flash_attention", "flash_attention"),
         "subln": ("fused_qkv_self_attention", "packed_qkv_self_attention"),
         "swiglu": ("fused_ln_qkv_self_attention",
                    "packed_qkv_self_attention")}
SPIED = ("flash_attention", "fused_qkv_self_attention", "fused_qkv_attn_proj",
         "fused_ln_qkv_self_attention", "packed_qkv_self_attention")


def tower_configs(flags: dict):
    """(JAX EvaVitConfig, port EvaVitConfig) of the tiny tower."""
    kw = {**EVA, **flags}
    return jconfig.EvaVitConfig(**kw), tconfig.EvaVitConfig(**kw)


def jax_tree(vit: tvit.EvaVisionTransformer) -> dict:
    """JAX's parameter tree (the blocks stacked) of a port tower."""
    cfg = tconfig.MiCoConfig(eva_override=vit.cfg)
    sd = {f"vision_encoder.{k}": v for k, v in vit.state_dict().items()}
    return convert.params_to_jax(sd, cfg)["vision_encoder"]


def perturbed_tower(cfg, seed: int = 0) -> tvit.EvaVisionTransformer:
    vit = tvit.EvaVisionTransformer(
        cfg, tvit.Init(torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed + 100)
    with torch.no_grad():
        for p in vit.parameters():
            p.add_(t(0.05 * rng.standard_normal(p.shape).astype(np.float32)))
    return vit


@pytest.fixture
def kernels_past_64(monkeypatch):
    """The port's plain-math bound of 'flash' lowered to 0, so the tiny
    tower's 5 x 5 scores reach K2's wrapper."""
    monkeypatch.setattr(tattn, "SMALL_ATTN_PLAIN_MAX", 0)


def spy(monkeypatch) -> list:
    calls = []
    for name in SPIED:
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or _f(*a, **k))
    return calls


LOSS_W = np.random.default_rng(2).standard_normal((3, 5, 64)).astype(
    np.float32)


@pytest.fixture(scope="module", params=list(FLAGS))
def tower(request):
    """(flag name, JAX cfg, port tower, pixels, JAX references) in one
    jitted call: the forwards of the flash and the plain route on the
    canonical and the folded tree, keyed (impl, folded), and under "train"
    the training route's output and `jax.grad` of sum(out * LOSS_W) at
    rates 0, flattened to JAX paths. With RoPE or a bias JAX's flash route
    is its plain one at these 25 scores (`multi_head_attention`'s bound),
    so that one forward serves both keys."""
    name = request.param
    jcfg, tcfg = tower_configs(FLAGS[name])
    vit = perturbed_tower(tcfg)
    tree = jax_tree(vit)
    folded = jvit.fold_inference_params(tree, jcfg)
    px = np.random.default_rng(1).standard_normal((3, 3, 28, 28)).astype(
        np.float32)

    def train(p, x):
        out = jvit.eva_vit_forward(p, jcfg, x, attn_impl="flash",
                                   train_rng=jax.random.PRNGKey(0))
        return jnp.sum(out * jnp.asarray(LOSS_W)), out

    impls = ("xla",) if ROUTE[name][0] == "flash_attention" else (
        "flash", "xla")

    def refs(p, pf, x):
        outs = {(impl, f): jvit.eva_vit_forward(q, jcfg, x, attn_impl=impl)
                for f, q in ((False, p), (True, pf)) for impl in impls}
        (_, out), grads = jax.value_and_grad(train, has_aux=True)(p, x)
        return outs, out, grads

    outs, out, grads = jax.jit(refs)(tree, folded, jnp.asarray(px))
    want = {k: np.asarray(v) for k, v in outs.items()}
    for f in (False, True):
        want.setdefault(("flash", f), want[("xla", f)])
    want["train"] = (np.asarray(out),
                     convert._flatten(jax.tree.map(np.asarray, grads)))
    return name, jcfg, vit, px, want


# ---------------------------------------------------------------------------
# helpers: RoPE and the relative-position index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd,pt,ft", [(32, 16, 16), (64, 16, 24), (64, 16, 2),
                                      (32, 8, 5)])
def test_rope_tables_match_jax(hd, pt, ft):
    """The tables exactly, pt ≠ ft included: interpolated positions, as
    EVA02-L-336's grid 24 against 16."""
    got, want = tvit.rope_tables(hd, pt, ft), jvit.rope_tables(hd, pt, ft)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w)


def test_rope_rotation_matches_jax():
    """The interleaved rotation on (B, H, n, D) with the shared tables and
    with per-sample tables gathered for kept patches, (B, 1, n_keep, D) as
    PatchDropout gives them (EVA02-L-336's 24 x 24 grid, D 64)."""
    hd, pt, ft = 64, 16, 24
    rng = np.random.default_rng(ft)
    x = rng.standard_normal((2, 3, ft * ft, hd)).astype(np.float32)
    cos, sin = jvit.rope_tables(hd, pt, ft)
    keep = np.stack([rng.permutation(ft * ft)[: ft * ft // 2]
                     for _ in range(2)])
    xk = x[:, :, : keep.shape[1]]
    want = jax.jit(lambda x, xk, keep, c, s: (
        jvit.apply_rope(x, cos, sin),
        jvit.apply_rope(xk, c[keep][:, None], s[keep][:, None])))(
        jnp.asarray(x), jnp.asarray(xk), jnp.asarray(keep), jnp.asarray(cos),
        jnp.asarray(sin))
    tol = dict(rtol=0, atol=1e-6)
    close(tvit.apply_rope(t(x), t(cos), t(sin)), want[0], tol)
    close(tvit.apply_rope(t(xk), t(cos)[t(keep)][:, None],
                          t(sin)[t(keep)][:, None]), want[1], tol)


@pytest.mark.parametrize("grid", [2, 16])
def test_relative_position_index_matches_jax(grid):
    """The bucket index with its three CLS buckets, and the bias gathered
    from a table, (1, H, L, L)."""
    assert tvit.num_relative_distance(grid) == jvit.num_relative_distance(grid)
    assert np.array_equal(tvit.rel_pos_index(grid), jvit.rel_pos_index(grid))
    table = np.random.default_rng(grid).standard_normal(
        (tvit.num_relative_distance(grid), 3)).astype(np.float32)
    got = tvit.rel_pos_bias_from_table(t(table), grid)
    assert got.shape == (1, 3, grid * grid + 1, grid * grid + 1)
    want = jax.jit(lambda tb: jvit.rel_pos_bias_from_table(tb, grid))(
        jnp.asarray(table))
    close(got, want, dict(rtol=0, atol=0))


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("folded", [False, True], ids=["canonical", "folded"])
@pytest.mark.parametrize("impl", ["flash", "plain"])
def test_forward_matches_jax(tower, monkeypatch, kernels_past_64, impl,
                             folded):
    """Each flag combination's forward equals JAX's on its route, canonical
    and folded (SwiGLU's norm2 folded into w1 and w2, inner_attn_ln into
    proj, ffn_ln into the MLP's last linear), and the blocks call the
    wrappers JAX's routing names: K2 with RoPE or a bias, K5 then
    inner_attn_ln for sub-LN alone (never K1 or K8), K1 for SwiGLU alone;
    none on the plain route. No kernel launches on the CPU."""
    name, jcfg, vit, px, want = tower
    if folded:
        vit = copy.deepcopy(vit)
        vit.fold_inference_params()
        blk = vit.blocks[0]
        gone = {"norm1_w", "norm2_w", "q_bias", "inner_attn_ln_w", "ffn_ln_w"}
        assert not any(blk.get(n) is not None for n in gone)
    calls = spy(monkeypatch)
    before = tfa.launch_counts()
    got = tvit.eva_vit_forward(vit, t(px), attn_impl=impl)
    assert tfa.launch_counts() == before
    assert calls == ([ROUTE[name][0]] * jcfg.layers if impl == "flash"
                     else [])
    assert got.shape == (3, 5, 64)
    close(got, want[("flash" if impl == "flash" else "xla", folded)],
          MODEL_TOL)


@pytest.mark.parametrize("name,route", [
    ("subln", "fused_qkv_self_attention"), ("swiglu", "fused_qkv_attn_proj")])
def test_fused_attn_proj_is_refused_under_subln(monkeypatch, name, route):
    """With `FUSED_ATTN_PROJ` on (and K1 off), a block without sub-LN goes
    to K8; under sub-LN it keeps K5 (eva_vit.py:322), whose output then
    passes inner_attn_ln. Either way the output is the K5 route's, which
    `test_forward_matches_jax` holds to JAX."""
    _, tcfg = tower_configs(FLAGS[name])
    vit = perturbed_tower(tcfg)
    px = t(np.random.default_rng(1).standard_normal((3, 3, 28, 28)).astype(
        np.float32))
    monkeypatch.setattr(tfa, "FUSED_LN_QKV", False)
    want = tvit.eva_vit_forward(vit, px, attn_impl="flash")
    monkeypatch.setattr(tfa, "FUSED_ATTN_PROJ", True)
    calls = spy(monkeypatch)
    got = tvit.eva_vit_forward(vit, px, attn_impl="flash")
    assert calls == [route] * tcfg.layers
    close(got, want.numpy(), dict(rtol=1e-5, atol=1e-5))


def test_training_route_gradients_match_jax(tower, monkeypatch,
                                            kernels_past_64):
    """With a train generator and the regularizers' rates at 0, the output
    and the gradients of a weighted sum equal `jax.grad` of JAX's training
    route. RoPE and bias blocks stay on K2 (its forward, then the plain
    recompute backward), never K3/K4; the others take the packed route."""
    name, jcfg, vit, px, refs = tower
    want, flat = refs["train"]
    vit = copy.deepcopy(vit).requires_grad_(True)
    calls = spy(monkeypatch)
    got = tvit.eva_vit_forward(vit, t(px), attn_impl="flash",
                               train_rng=torch.Generator().manual_seed(0))
    assert calls == [ROUTE[name][1]] * jcfg.layers
    close(got, want, MODEL_TOL)
    (got * t(LOSS_W)).sum().backward()
    for pname, p in vit.named_parameters():
        parts = pname.split(".")
        if parts[0] == "blocks":
            ref = flat["/".join(["blocks", *parts[2:]])][int(parts[1])]
        else:
            ref = flat["/".join(parts)]
        # the CLIP head is not on this path: JAX's gradient is zero there
        close(torch.zeros_like(p) if p.grad is None else p.grad, ref,
              MODEL_TOL)


def test_patch_dropout_gathers_rope_tables():
    """PatchDropout with RoPE (eva_vit.py:527-538): each sample's kept
    patches rotate by their own positions' tables, (B, 1, n_keep, D). The
    port's training forward against JAX's blocks (`_block`, training
    route) run on the port's kept tokens with JAX's gathered tables (the
    two packages' draws differ, so the kept indices are handed over)."""
    jcfg, tcfg = tower_configs(dict(FLAGS["eva02"], patch_dropout=0.5))
    vit = perturbed_tower(tcfg)
    px = t(np.random.default_rng(3).standard_normal((2, 3, 28, 28)).astype(
        np.float32))
    out = tvit.eva_vit_forward(vit, px, attn_impl="plain",
                               train_rng=torch.Generator().manual_seed(5))
    assert out.shape == (2, 1 + 2, 64)
    # the forward's draws again: one seed forked from the generator
    x = tvit.patch_embed(vit.patch_embed, tcfg, px)
    x = torch.cat([vit.cls_token.expand(2, 1, 64), x], 1) + vit.pos_embed
    x, kept = tvit.patch_dropout(
        x, 0.5, tvit.fork_generator(torch.Generator().manual_seed(5), "cpu"),
        return_index=True)
    cos, sin = jvit.rope_tables(32, jcfg.pt_hw_seq_len, jcfg.grid_size)
    keep = kept.numpy()
    def blocks(tree, x):
        for i in range(jcfg.layers):
            bp = jax.tree.map(lambda a: a[i], tree["blocks"])
            x = jvit._block(x, bp, jcfg, cos[keep][:, None],
                            sin[keep][:, None], "xla", is_train=True)
        return jvit.layer_norm(x, tree["norm_w"], tree["norm_b"], jcfg.ln_eps)

    want = jax.jit(blocks)(jax_tree(vit), jnp.asarray(x.detach().numpy()))
    close(out, want, MODEL_TOL)


# ---------------------------------------------------------------------------
# the released-layout converter
# ---------------------------------------------------------------------------


def released_eva02(rng, cfg, shared: bool) -> dict:
    """A synthetic EVA02 state dict in the reference layout: separate
    q/k/v projections with q/v biases, SwiGLU w1..w3 with ffn_ln,
    inner_attn_ln, per-block or one shared relative table, a head."""
    w, h = cfg.width, cfg.mlp_hidden
    nrel = tvit.num_relative_distance(cfg.grid_size)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"patch_embed.proj.weight": r(w, 3, cfg.patch_size, cfg.patch_size),
          "patch_embed.proj.bias": r(w), "cls_token": r(1, 1, w),
          "pos_embed": r(1, cfg.seq_len, w), "norm.weight": r(w),
          "norm.bias": r(w), "head.weight": r(cfg.embed_dim, w),
          "head.bias": r(cfg.embed_dim)}
    for i in range(cfg.layers):
        b = f"blocks.{i}."
        for n in ("norm1", "norm2", "attn.inner_attn_ln"):
            sd[b + n + ".weight"], sd[b + n + ".bias"] = r(w), r(w)
        for n in "qkv":
            sd[b + f"attn.{n}_proj.weight"] = r(w, w)
        sd[b + "attn.q_bias"], sd[b + "attn.v_bias"] = r(w), r(w)
        sd[b + "attn.proj.weight"], sd[b + "attn.proj.bias"] = r(w, w), r(w)
        for n in ("w1", "w2"):
            sd[b + f"mlp.{n}.weight"], sd[b + f"mlp.{n}.bias"] = r(h, w), r(h)
        sd[b + "mlp.w3.weight"], sd[b + "mlp.w3.bias"] = r(w, h), r(w)
        sd[b + "mlp.ffn_ln.weight"], sd[b + "mlp.ffn_ln.bias"] = r(h), r(h)
        if not shared:
            sd[b + "attn.relative_position_bias_table"] = r(nrel, cfg.num_heads)
    if shared:
        sd["rel_pos_bias.relative_position_bias_table"] = r(nrel,
                                                            cfg.num_heads)
    return {f"visual.{k}": v for k, v in sd.items()}


@pytest.mark.parametrize("shared", [False, True], ids=["per-block", "shared"])
def test_converter_matches_jax(shared):
    """The port's `eva_vit_from_torch` gives JAX's tree leaf for leaf
    (q/k/v packed into qkv_w, SwiGLU, both LNs of sub-LN, the relative
    tables), every key read, and the tree fills every parameter of the
    port's tower (whose forward `test_forward_matches_jax` holds to JAX's
    for these flags), which then runs to finite tokens."""
    flags = dict(FLAGS["eva02"], **{("use_shared_rel_pos_bias" if shared
                                     else "use_rel_pos_bias"): True})
    jcfg, tcfg = tower_configs(flags)
    sd = released_eva02(np.random.default_rng(4), tcfg, shared)
    want = jconvert.eva_vit_from_torch(sd, jcfg, prefix="visual.")
    consumed = set()
    got = convert.eva_vit_from_torch({k: t(v) for k, v in sd.items()}, tcfg,
                                     prefix="visual.", consumed=consumed)
    assert consumed == set(sd)
    fw, fg = (convert._flatten(jax.tree.map(np.asarray, want)),
              convert._flatten(got))
    assert set(fw) == set(fg)
    for k in fw:
        np.testing.assert_array_equal(np.asarray(fg[k]), fw[k], err_msg=k)
    sd_port = {}
    for path, leaf in fg.items():
        group, _, leaf_name = path.rpartition("/")
        if group == "blocks":
            for i in range(tcfg.layers):
                sd_port[f"blocks.{i}.{leaf_name}"] = leaf[i].contiguous()
        else:
            sd_port[path.replace("/", ".")] = leaf.contiguous()
    vit = tvit.EvaVisionTransformer(tcfg, tvit.Init(None, meta=True))
    vit.load_state_dict(sd_port, strict=True, assign=True)
    px = np.random.default_rng(6).standard_normal((2, 3, 28, 28)).astype(
        np.float32)
    out = tvit.eva_vit_forward(vit, t(px), attn_impl="plain")
    assert out.shape == (2, 5, 64) and torch.isfinite(out).all()


def test_registry_towers_build_at_full_width():
    """EVA02-CLIP-B-16, -L-14 and -L-14-336 build (weightless) with JAX's
    leaf shapes: SwiGLU at int(1024 x 2.6667) = 2730 for L, ffn_ln over it."""
    for name in ("EVA02-CLIP-B-16", "EVA02-CLIP-L-14", "EVA02-CLIP-L-14-336"):
        tcfg = tconfig.EVA_VIT_CONFIGS[name]
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(
            jconfig.EVA_VIT_CONFIGS[name])
        vit = tvit.EvaVisionTransformer(tcfg, tvit.Init(None, meta=True))
        shapes = jax.eval_shape(lambda: jvit.init_eva_vit(
            jax.random.PRNGKey(0), jconfig.EVA_VIT_CONFIGS[name]))
        want = {"/".join(str(getattr(k, "key", k)) for k in path): v.shape
                for path, v in jax.tree_util.tree_flatten_with_path(
                    shapes)[0]}
        got = {}
        for k, p in vit.state_dict().items():
            parts = k.split(".")
            if parts[0] == "blocks":
                got.setdefault("blocks/" + parts[2], (tcfg.layers,) + tuple(
                    p.shape))
            else:
                got["/".join(parts)] = tuple(p.shape)
        assert got == want
    assert tconfig.EVA_VIT_CONFIGS["EVA02-CLIP-L-14"].mlp_hidden == 2730
