"""The port's checkpoint loading (`mico_tpu_torch/convert.py`,
`models/mico.py` `mico_from_torch`, `train/checkpoints.py`) against the JAX
package's: the released MiCo-ViT-g-14 layout's 897 names and shapes
(`tests/fixtures/mico_vit_g_manifest.json`) on meta tensors, and a
reference-layout state_dict at the tiny config converted by both packages
(leaf for leaf) and loaded from a pretrained directory in each layout (the
models' outputs, fp32 on the CPU)."""

import json
import logging
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.models.mico import MiCoModel
from mico_tpu.models.mico import mico_from_torch as jax_mico_from_torch
from mico_tpu.train import checkpoints as jax_ckpt
from mico_tpu_torch import convert
from mico_tpu_torch.config import MiCoConfig
from mico_tpu_torch.models.mico import MiCo, mico_from_torch, remap_legacy_keys
from mico_tpu_torch.train import checkpoints

from torch_port_common import (NON_WEIGHTS, configs, perturbed_params,
                               reference_state_dict, replace, tiny_model_cfg,
                               torch_state_dict, write_hps)

MANIFEST = Path(__file__).resolve().parent / "fixtures" / \
    "mico_vit_g_manifest.json"
RESIZED = ("vision_encoder/pos_embed", "vision_frame_embedding",
           "audio_frame_embedding", "depth_frame_embedding")
RES = 28


def leaves(tree) -> dict:
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v,
                          np.float32)
            for k, v in convert._flatten(tree).items()}


def assert_same_tree(got, want, resized=RESIZED):
    got, want = leaves(got), leaves(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k in resized:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the released layout at ViT-g shapes
# ---------------------------------------------------------------------------


def test_released_manifest_on_meta():
    """Every manifest key is read except the three non-weights, and the
    tree fills every parameter of the port's ViT-g MiCo (meta tensors: no
    4.75 GB of values)."""
    manifest = json.loads(MANIFEST.read_text())
    assert len(manifest) == 897
    sd = {k: torch.empty(shape, device="meta") for k, shape in manifest.items()}
    cfg = MiCoConfig(vision_encoder_type="evaclip01_giant", contra_dim=512,
                     max_vision_sample_num=4, max_audio_sample_num=2,
                     max_depth_sample_num=2)
    consumed = set()
    tree = mico_from_torch(sd, cfg, consumed=consumed)
    assert set(manifest) - consumed == NON_WEIGHTS
    placed = convert.params_from_jax(tree, cfg, device="meta")
    want = MiCo(cfg, device="cpu", init_weights=False).state_dict()
    assert set(placed) == set(want)
    assert all(placed[k].shape == want[k].shape for k in want)
    assert placed["vision_encoder.blocks.39.qkv_w"].shape == (1408, 4224)
    assert placed["bert.embeddings.word"].shape == (30522, 768)


# ---------------------------------------------------------------------------
# the converter at the tiny config
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = configs()
    return jcfg, tcfg, perturbed_params(jcfg, seed=3)


@pytest.mark.parametrize("case", ["released", "legacy", "grid", "frames",
                                  "fp16"])
def test_tree_matches_jax(tiny, case):
    """The port's `mico_from_torch` tree equals JAX's on the same
    state_dict: copies and transposes exact, the bilinear positional and
    nearest frame resizes within 1e-6; both read the same keys. `grid`:
    a 2 x 2 checkpoint grid into a 3 x 3 tower; `frames`: frame counts
    other than the checkpoint's; `fp16`: half-precision tensors (JAX reads
    them as fp32)."""
    jcfg, tcfg, params = tiny
    sd = reference_state_dict(params, legacy=case == "legacy")
    if case == "grid":
        eva = replace(jcfg.eva_config, image_size=42)
        jcfg = replace(jcfg, eva_override=eva, vision_resolution=42)
        tcfg = replace(tcfg, eva_override=replace(tcfg.eva_config,
                                                  image_size=42),
                       vision_resolution=42)
    if case == "frames":
        jcfg = replace(jcfg, max_vision_sample_num=7, max_audio_sample_num=2,
                       max_depth_sample_num=3)
        tcfg = replace(tcfg, max_vision_sample_num=7, max_audio_sample_num=2,
                       max_depth_sample_num=3)
    tsd = torch_state_dict(sd, torch.float16 if case == "fp16"
                           else torch.float32)
    jc, tc = set(), set()
    want = jax_mico_from_torch(tsd if case == "fp16" else sd, jcfg,
                               consumed=jc)
    got = mico_from_torch(tsd, tcfg, consumed=tc)
    assert tc == jc and set(remap_legacy_keys(sd)) - tc == NON_WEIGHTS
    assert_same_tree(got, want)
    if case == "grid":
        assert got["vision_encoder"]["pos_embed"].shape == (1, 10, 64)
    if case == "fp16":    # leaves keep the checkpoint's dtype until placed
        assert got["vision_encoder"]["blocks"]["qkv_w"].dtype == torch.float16
    model = convert.mico_from_jax(got, tcfg, device="cpu")
    assert all(p.dtype == torch.float32 and p.is_contiguous()
               for p in model.parameters())


def test_tree_leaves_share_the_checkpoint(tiny):
    """Transposed linears are views of the state_dict's tensors; the one
    copy is made at placement."""
    _, tcfg, params = tiny
    sd = torch_state_dict(reference_state_dict(params))
    tree = mico_from_torch(sd, tcfg)
    w = sd["contra_head_v.linear.weight"]
    k = tree["contra_head_v"]["kernel"]
    assert k.data_ptr() == w.data_ptr() and not k.is_contiguous()
    placed = convert.params_from_jax(tree, tcfg)
    assert placed["contra_head_v.kernel"].data_ptr() != w.data_ptr()
    torch.testing.assert_close(placed["contra_head_v.kernel"], w.t(),
                               rtol=0, atol=0)


def test_place_to_dtype(tiny):
    """Placement casts each leaf once into the asked dtype."""
    _, tcfg, params = tiny
    tree = mico_from_torch(torch_state_dict(reference_state_dict(params)),
                           tcfg)
    model = convert.mico_from_jax(tree, tcfg, device="cpu",
                                  dtype=torch.bfloat16)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}


# ---------------------------------------------------------------------------
# load_from_pretrained_dir in each layout
# ---------------------------------------------------------------------------


def write_layout(root: Path, params, layout: str) -> str:
    """A pretrained dir holding the tiny params in `layout`, with decoys
    the loaders must pass over."""
    pre = root / layout
    write_hps(pre, tiny_model_cfg())
    sd = reference_state_dict(params)
    if layout == "pt":
        ckpt = pre / "ckpt"
        os.makedirs(ckpt)
        torch.save({"state_dict": torch_state_dict(sd)},
                   ckpt / "model_step_12.pt")
        torch.save({"contra_temp": torch.zeros(())}, ckpt / "model_step_3.pt")
        os.makedirs(ckpt / "model_step_40-tmp")       # an unfinished save
    elif layout in ("hf", "hf_sharded"):
        old = pre / "checkpoint-5"
        os.makedirs(old)
        torch.save({"contra_temp": torch.zeros(())}, old / "pytorch_model.bin")
        new = pre / "checkpoint-50"
        os.makedirs(new)
        tsd = torch_state_dict(sd)
        if layout == "hf":
            torch.save(tsd, new / "pytorch_model.bin")
        else:
            keys = sorted(tsd)
            for i, part in enumerate((keys[::2], keys[1::2])):
                torch.save({k: tsd[k] for k in part},
                           new / f"pytorch_model-0000{i + 1}-of-00002.bin")
    else:                                      # the native .npz tree
        jcfg, _ = configs(**{k: v for k, v in tiny_model_cfg().items()
                             if k.startswith("max_")})
        os.makedirs(pre / "ckpt")
        jax_ckpt.save_pytree_npz(str(pre / "ckpt" / "model_step_8.npz"),
                                 jax_mico_from_torch(sd, jcfg))
    return str(pre)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory, tiny):
    root = tmp_path_factory.mktemp("pretrained")
    return {name: write_layout(root, tiny[2], name)
            for name in ("pt", "hf", "hf_sharded", "npz")}


def model_outputs(model, pixels, ids, mask):
    """Vision and text embeddings and ITM probabilities of either package's
    model (the port's on torch tensors)."""
    if isinstance(model, MiCoModel):
        x, i, m = jnp.asarray(pixels), jnp.asarray(ids), jnp.asarray(mask)
        softmax = jax.nn.softmax
    else:
        x, i, m = (torch.from_numpy(a) for a in (pixels, ids, mask))
        softmax = torch.softmax
    vis = model.forward_vision_encoder(x)
    fv = model.contra_head("v", model.pool_vision_for_contra(vis))
    seq = model.forward_multimodal_encoder(i, m)
    ft = model.contra_head("t", model.pool_text_for_contra(seq))
    cond = model.get_multimodal_forward_input_vision(vis)
    xseq = model.forward_multimodal_encoder(i, m, cond)
    itm = softmax(model.itm_head(xseq[:, 0]), 1)
    return [np.asarray(a) for a in (vis, fv, ft, itm)]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    pixels = rng.standard_normal((2, 3, 3, RES, RES)).astype(np.float32)
    ids = rng.integers(1000, 20000, (2, 9)).astype(np.int64)
    mask = np.ones((2, 9), np.int64)
    mask[1, 6:] = 0
    return pixels, ids, mask


@pytest.fixture(scope="module")
def jax_outputs(layouts, inputs):
    params, cfg = jax_ckpt.load_from_pretrained_dir(layouts["pt"],
                                                    video_resolution=RES)
    return model_outputs(MiCoModel(params, cfg), *inputs)


@pytest.mark.parametrize("layout", ["pt", "hf", "hf_sharded", "npz"])
def test_pretrained_dir_matches_jax(layouts, inputs, jax_outputs, layout):
    """The newest checkpoint of each layout is picked (`-tmp` skipped), the
    tree equals JAX's loader's, and the placed model's vision, text and
    ITM outputs equal JAX's `MiCoModel` within 1e-5."""
    pre = layouts[layout]
    want, jcfg = jax_ckpt.load_from_pretrained_dir(pre, video_resolution=RES)
    got, cfg = checkpoints.load_from_pretrained_dir(pre, video_resolution=RES)
    assert (cfg.contra_dim, cfg.max_audio_sample_num) == (
        jcfg.contra_dim, jcfg.max_audio_sample_num) == (32, 2)
    assert_same_tree(got, want)
    model = convert.mico_from_jax(got, cfg, device="cpu")
    for a, b in zip(model_outputs(model, *inputs), jax_outputs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("modal", ["uni", "text"])
@pytest.mark.parametrize("layout", ["pt", "npz"])
def test_return_modal_matches_jax(layouts, layout, modal):
    kw = dict(video_resolution=RES, return_modal=modal)
    want, _ = jax_ckpt.load_from_pretrained_dir(layouts[layout], **kw)
    got, _ = checkpoints.load_from_pretrained_dir(layouts[layout], **kw)
    assert ("blocks" in got) == (modal == "uni")
    assert ("layers" in got) == (modal == "text")
    assert_same_tree(got, want, resized=("pos_embed",))


def test_overrides_and_leftover_warning(tmp_path, tiny, caplog):
    """config_overrides win over hps.json; a key the converter never reads
    is logged, and `consumed` collects what it read."""
    pre = tmp_path / "dir"
    write_hps(pre, tiny_model_cfg())
    sd = torch_state_dict(reference_state_dict(tiny[2]))
    sd["stray.weight"] = torch.zeros(3)
    os.makedirs(pre / "ckpt")
    torch.save(sd, pre / "ckpt" / "model_step_1.pt")
    consumed = set()
    with caplog.at_level(logging.WARNING):
        _, cfg = checkpoints.load_from_pretrained_dir(
            str(pre), video_resolution=RES,
            config_overrides={"compute_dtype": "bfloat16"}, consumed=consumed)
    assert cfg.compute_dtype == "bfloat16"
    assert set(sd) - consumed == NON_WEIGHTS | {"stray.weight"}
    assert "NOT consumed" in caplog.text and "stray.weight" in caplog.text


def test_latest_step_skips_tmp(tmp_path):
    for name in ("model_step_2.npz", "model_step_10.npz", "model_step_30-tmp",
                 "optimizer_step_50.npz"):
        (tmp_path / name).write_bytes(b"")
    # orbax's uncommitted save (atomicity.TMP_DIR_SUFFIX), which the port's
    # `.orbax` writer also builds before its rename
    os.makedirs(tmp_path / "model_step_40.orbax.orbax-checkpoint-tmp")
    assert checkpoints._latest_step(str(tmp_path), "model") == \
        jax_ckpt._latest_step(str(tmp_path), "model") == \
        (10, str(tmp_path / "model_step_10.npz"))
    assert checkpoints._latest_step(str(tmp_path / "none"), "model") == \
        (None, None)


def test_orbax_and_missing_checkpoints_raise(tmp_path):
    """A pretrained directory without a checkpoint raises; one whose newest
    checkpoint is the port's `.orbax` (saved over an npz step, which it
    removes) loads its tree bit for bit (it was refused before `.orbax` was
    ported)."""
    write_hps(tmp_path, tiny_model_cfg())
    with pytest.raises(FileNotFoundError, match="model_step"):
        checkpoints.load_from_pretrained_dir(str(tmp_path))
    _, tcfg = configs(max_vision_sample_num=4, max_audio_sample_num=2,
                      max_depth_sample_num=2)
    model = MiCo(tcfg, device="cpu", seed=3)
    checkpoints.ModelSaver(str(tmp_path)).save(2, model)
    checkpoints.ModelSaver(str(tmp_path), backend="orbax").save(4, model)
    # the `.orbax` save removed the npz step before it
    assert os.listdir(tmp_path / "ckpt") == ["model_step_4.orbax"]
    params, cfg = checkpoints.load_from_pretrained_dir(str(tmp_path))
    assert cfg.max_vision_sample_num == 4
    got = convert._flatten(params)
    want = convert._flatten(convert.params_to_jax(model.state_dict(), tcfg))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    back = convert.mico_from_jax(params, cfg, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_hps_reader_matches_jax(tmp_path):
    from mico_tpu.utils.config_io import load_hps as jax_load_hps
    from mico_tpu_torch.utils.config_io import load_hps

    write_hps(tmp_path, {"contra_dim": 8, "nested": {"a": [1, {"b": 2}]}})
    got, want = load_hps(str(tmp_path)), jax_load_hps(str(tmp_path))
    assert got == want
    assert got.model_cfg.nested.a[1].b == 2
    with pytest.raises(AttributeError):
        got.missing


def test_to_numpy_matches_jax():
    from mico_tpu.convert import to_numpy as jax_to_numpy

    sd = {"a": torch.arange(6, dtype=torch.float16).reshape(2, 3),
          "b": np.ones((2,), np.float64), "c": torch.tensor(3.5)}
    got, want = convert.to_numpy(sd), jax_to_numpy(sd)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# resuming the JAX package's optimizer file
# ---------------------------------------------------------------------------

# Adam's eps raised so that the update is not scale-free (a gradient that
# is zero up to rounding moves nothing); a new group, a frozen prefix and
# the three updates' clip
OPT = dict(learning_rate=1e-2, clip_lr=5e-3, new_lr=2e-2,
           new_params_name=("contra_head",), frozen_prefixes=("itm_head",),
           weight_decay=0.1, eps=1e-3, grad_norm=1.0, num_train_steps=10,
           warmup_ratio=0.2)


def _jax_run(params, accum, calls, seed=0):
    """`calls` micro-steps of the JAX optimizer (`optax.MultiSteps` over it
    when accum > 1) with seeded gradients → (params, state, the next
    call's gradients)."""
    import optax

    from mico_tpu.train import optim as joptim

    opt = joptim.build_optimizer(params, joptim.OptimConfig(**OPT))
    if accum > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=accum)
    rng = np.random.default_rng(seed)

    def grads():
        return jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), params)

    @jax.jit
    def update(state, p, g):
        import optax

        u, state = opt.update(g, state, p)
        return state, optax.apply_updates(p, u)

    state, p = opt.init(params), params
    for _ in range(calls):
        state, p = update(state, p, grads())
    return p, state, grads(), update


@pytest.mark.parametrize("accum,calls", [(1, 3), (2, 3), (2, 4)],
                         ids=["plain", "multisteps_open", "multisteps_closed"])
def test_jax_optimizer_file_resumes(tmp_path, accum, calls):
    """JAX's `ModelSaver` writes the model and its optax state (leaves by
    position) after `calls` micro-steps; the port loads both
    (`resume_latest`, `load_latest_opt_state`), and one more micro-step on
    the same gradients gives JAX's parameters, update count and, mid-window,
    its accumulation."""
    from mico_tpu_torch.train import optim as toptim

    jcfg, tcfg = configs()
    params = perturbed_params(jcfg, seed=5)
    p, state, g_next, update = _jax_run(params, accum, calls)
    jax_ckpt.ModelSaver(str(tmp_path)).save(calls, p, state)
    model = MiCo(tcfg, device="cpu", init_weights=True)
    assert checkpoints.resume_latest(str(tmp_path), model) == calls
    topt = toptim.build_optimizer(model, toptim.OptimConfig(**OPT),
                                  accum_steps=accum)
    assert checkpoints.load_latest_opt_state(str(tmp_path), topt, step=calls)
    want_count = calls // accum
    assert topt.count == want_count and topt.mini_step == calls % accum
    state, p = update(state, p, g_next)
    tg = convert.params_from_jax(jax.tree.map(np.asarray, g_next), tcfg)
    named = dict(model.named_parameters())
    if topt.mini_step == 0:
        topt.zero_grad()
    for name in topt.names:
        prm = named[name]
        prm.grad = tg[name].clone() if prm.grad is None else prm.grad + tg[name]
    topt.accumulate()
    assert topt.count == (calls + 1) // accum
    want = convert.params_from_jax(jax.tree.map(np.asarray, p), tcfg)
    for name, prm in named.items():
        np.testing.assert_allclose(prm.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_jax_optimizer_leaf_count_must_match(tmp_path):
    """A JAX optimizer file of another chain (MultiSteps against a port
    optimizer without accumulation) raises, naming both counts."""
    from mico_tpu_torch.train import optim as toptim

    jcfg, tcfg = configs()
    params = perturbed_params(jcfg, seed=5)
    p, state, _, _ = _jax_run(params, 2, 1)
    jax_ckpt.ModelSaver(str(tmp_path)).save(1, p, state)
    model = MiCo(tcfg, device="cpu")
    topt = toptim.build_optimizer(model, toptim.OptimConfig(**OPT))
    n = len(jax.tree.leaves(state))
    with pytest.raises(ValueError, match=f"holds {n} leaves.*accum_steps 1"):
        checkpoints.load_latest_opt_state(str(tmp_path), topt, step=1)
