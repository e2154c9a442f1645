"""The port's tensor-parallel layout and collectives
(`mico_tpu_torch/parallel/tensor_parallel.py`, `parallel/partition.py`) on
the CPU, at the tiny config of `tests/torch_port_common.py` in fp32:

  - `mico_param_specs` gives JAX's spec (`mico_tpu.parallel.partition.
    mico_param_specs`) leaf by leaf on the same MiCo tree: the pre-norm
    EVA tower, EVA02 (RoPE, SwiGLU, sub-LN, per-block relative tables) and
    the CLIP tower JAX keeps as a list of per-block dicts (replicated);
  - K1's, K5's and K8's plain versions at a rank's heads (w (W, 3·H·D),
    H·D = W / 2, packed [q_h | k_h | v_h]) give those heads' columns of
    the JAX Pallas kernel's whole output in interpret mode; K8's fp32
    partials summed over the ranks, + bp, give its whole output;
  - the fused qkv's split by heads and its rebuild as [q | k | v] (a
    concatenation in rank order is not the leaf), also gathered over two
    gloo ranks;
  - the LayerNorm whose statistics are summed over the model group, at an
    uneven split, against `ops.layers.layer_norm`, values and gradients;
  - ceil-sized blocks for an uneven hidden or token count, and the token
    scatter / gather with their gradients;
  - the refusal of a head count the model axis does not divide.
The gloo ranks are spawned once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.models import mico as jmico
from mico_tpu.ops import flash_attention as jfa
from mico_tpu.parallel import partition as jpartition
from mico_tpu_torch import config as tconfig
from mico_tpu_torch.convert import mico_from_jax
from mico_tpu_torch.models import clip_vit as tclip
from mico_tpu_torch.ops import flash_attention as tfa
from mico_tpu_torch.parallel import mico_param_specs
from mico_tpu_torch.parallel import tensor_parallel as tp

from torch_dist_common import run_ranks
from torch_port_common import TINY, configs, no_launch, t

ATOL = 1e-5
EVA02 = dict(rope=True, naiveswiglu=True, subln=True, intp_freq=True,
             mlp_ratio=2.672, use_rel_pos_bias=True)


def _clip_configs():
    from mico_tpu import config as jconfig
    from mico_tpu.models import clip_vit as jclip

    zoo = dict(input_resolution=32, patch_size=16, width=64, layers=2,
               heads=2, output_dim=32)
    m = dict(vision_encoder_type="clip_vit_base_16", contra_dim=32,
             compute_dtype="float32", max_vision_sample_num=2,
             max_audio_sample_num=2)
    return (jconfig.MiCoConfig(vision_override=jclip.ClipVitConfig(**zoo),
                               bert_override=jconfig.BertConfig(
                                   **TINY["bert"]), **m),
            tconfig.MiCoConfig(vision_override=tclip.ClipVitConfig(**zoo),
                               bert_override=tconfig.BertConfig(
                                   **TINY["bert"]), **m))


def _jax_path_spec(specs, name: str, stacked: bool):
    """JAX's spec of the leaf a port parameter name comes from."""
    node = specs
    for part in name.split("."):
        if part.isdigit():
            if stacked:
                continue             # the stacked depth axis
            part = int(part)
        node = node[part]
    return tuple(node)


@pytest.mark.parametrize("tower", ["pre-norm", "eva02", "clip"])
def test_param_specs_match_jax(tower):
    if tower == "clip":
        jcfg, tcfg = _clip_configs()
    else:
        jcfg, tcfg = configs(eva=EVA02 if tower == "eva02" else None)
    params = jax.tree.map(np.asarray, jmico.init_mico(
        jax.random.PRNGKey(0), jcfg))
    want = jpartition.mico_param_specs(params, "model")
    model = mico_from_jax(params, tcfg, device="cpu")
    got = mico_param_specs(model.named_parameters(), "model",
                           is_eva=tcfg.is_eva)
    assert len(got) == len(list(model.parameters()))
    sharded = 0
    for name, spec in got.items():
        stacked = tp.is_stacked(name, tcfg.is_eva)
        w = _jax_path_spec(want, name, stacked)
        while w and w[-1] is None:
            w = w[:-1]
        assert spec == w, name
        sharded += "model" in spec
    # BERT's 2 layers each shard q/k/v, xq/xk/xv, inter (weights and
    # biases) and attn_out/x_out/out's weights: 17 leaves a layer; an EVA
    # block qkv_w, q/v_bias, proj_w and fc1 (w, b) / fc2_w, or SwiGLU's
    # w1, w2 (w, b), w3_w and ffn_ln (w, b)
    n_bert = 2 * 17
    n_eva = {"pre-norm": 2 * 7, "eva02": 2 * 11, "clip": 0}[tower]
    assert sharded == n_bert + n_eva
    assert tp.is_stacked("vision_encoder.blocks.0.qkv_w", True)
    assert not tp.is_stacked("vision_encoder.blocks.0.qkv_w", False)


def _rank_inputs(rng, b, l, nh, d):
    w = nh * d
    x = rng.standard_normal((b, l, w)).astype(np.float32)
    wq = (rng.standard_normal((w, 3 * w)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(3 * w) * 0.05).astype(np.float32)
    wp = (rng.standard_normal((w, w)) * 0.05).astype(np.float32)
    bp = (rng.standard_normal(w) * 0.05).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(w)).astype(np.float32)
    b0 = (0.1 * rng.standard_normal(w)).astype(np.float32)
    return x, wq, bias, wp, bp, g, b0


@pytest.mark.parametrize("kernel", ["K1", "K5", "K8"])
@pytest.mark.parametrize("model", [2, 4])
def test_rank_heads_match_jax_kernel_columns(kernel, model):
    """(2, 50, 4 heads of 16): each rank's H·D = 64 / model columns."""
    b, l, nh, d = 2, 50, 4, 16
    rng = np.random.default_rng(3)
    x, wq, bias, wp, bp, g, b0 = _rank_inputs(rng, b, l, nh, d)
    scale, eps = d ** -0.5, 1e-6
    j = [jnp.asarray(a) for a in (x, wq, bias, wp, bp, g, b0)]
    whole = np.asarray({
        "K1": lambda: jfa._fused_ln_qkv_attn_fwd(
            j[0], j[5], j[6], j[1], j[2], nh, scale, eps, True, True),
        "K5": lambda: jfa._fused_qkv_attn_fwd(j[0], j[1], j[2], nh, scale,
                                              True),
        "K8": lambda: jfa._fused_qkv_attn_proj_fwd(*j[:5], nh, scale, True),
    }[kernel]())
    hd = nh * d // model
    partials = []
    for r in range(model):
        axis = tp.ModelAxis(None, model, r)
        w_r = tp.shard(t(wq), ("qkv", 1), axis)
        bias_r = tp.shard(t(bias), ("qkv", 0), axis)
        assert w_r.shape == (nh * d, 3 * hd)
        args = (t(x), w_r, bias_r)
        if kernel == "K1":
            got = no_launch(lambda: tfa.fused_ln_qkv_self_attention(
                t(x), t(g), t(b0), w_r, bias_r, nh // model, scale, eps,
                True))
        elif kernel == "K5":
            got = no_launch(lambda: tfa.fused_qkv_self_attention(
                *args, nh // model, scale))
        else:
            wp_r = tp.shard(t(wp), ("block", 0), axis)
            got = no_launch(lambda: tfa.fused_qkv_attn_proj(
                *args, wp_r, t(bp), nh // model, scale, partial=True))
            assert got.dtype == torch.float32 and got.shape == x.shape
            partials.append(got)
            continue
        assert got.shape == (b, l, hd)
        np.testing.assert_allclose(got.numpy(),
                                   whole[..., r * hd:(r + 1) * hd],
                                   rtol=0, atol=ATOL)
    if kernel == "K8":
        got = tp.finish_partial(sum(partials), t(bp), None, torch.float32)
        np.testing.assert_allclose(got.numpy(), whole, rtol=0, atol=ATOL)


def test_qkv_split_and_rebuild():
    w = torch.arange(4 * 24, dtype=torch.float32).reshape(4, 24)
    for model in (1, 2, 4):
        parts = [tp.shard(w, ("qkv", 1), tp.ModelAxis(None, model, r))
                 for r in range(model)]
        # each part is its heads' q, k and v, in that order
        q, k, v = w.chunk(3, 1)
        c = 8 // model
        for r, p in enumerate(parts):
            assert torch.equal(p, torch.cat([q[:, r * c:(r + 1) * c],
                                             k[:, r * c:(r + 1) * c],
                                             v[:, r * c:(r + 1) * c]], 1))
        assert torch.equal(tp.unshard(parts, ("qkv", 1)), w)
        if model > 1:
            assert not torch.equal(torch.cat(parts, 1), w)


def test_uneven_blocks():
    """Ceil-sized blocks, as GSPMD pads: EVA02-L's SwiGLU hidden over 4,
    257·2 condition tokens over 4 and a count shorter than the axis."""
    sizes = lambda n, m: [b - a for a, b in (tp.block_range(n, m, r)
                                             for r in range(m))]
    assert sizes(2730, 4) == [683, 683, 683, 681]
    assert sizes(514, 4) == [129, 129, 129, 127]
    assert sizes(10, 4) == [3, 3, 3, 1]
    assert sizes(2, 4) == [1, 1, 0, 0]
    x = torch.arange(10.0)
    parts = [tp.shard(x, ("block", 0), tp.ModelAxis(None, 4, r))
             for r in range(4)]
    assert torch.equal(tp.unshard(parts, ("block", 0)), x)


@pytest.mark.parametrize("heads,model,tower", [
    (12, 8, "bert"), (5, 2, "bert"), (5, 2, "vision_encoder")])
def test_head_count_refusal(heads, model, tower):
    bert = dict(hidden_size=heads * 8, num_attention_heads=heads,
                intermediate_size=64, encoder_width=heads * 8)
    eva = (dict(width=heads * 8, head_width=8, embed_dim=heads * 8)
           if tower == "vision_encoder" else None)
    _, tcfg = configs(eva=eva, bert=bert if tower == "bert" else None)
    with pytest.raises(ValueError,
                       match=rf"{tower}.*{heads} heads.*model={model}"):
        tp.check_heads(tcfg, model)
    tp.check_heads(tcfg, 1)


# ---------------------------------------------------------------------------
# the collectives over two gloo ranks
# ---------------------------------------------------------------------------


def _rank_checks(rank: int, world: int, x, w, gw, seq) -> dict:
    import torch

    from mico_tpu_torch.ops.layers import layer_norm
    from mico_tpu_torch.parallel.mesh import create_mesh
    from mico_tpu_torch.parallel import tensor_parallel as tp

    mesh = create_mesh(data=1, model=world)
    axis = mesh.model_axis
    out = {"axis": (axis.size, axis.index)}
    # the sharded LayerNorm over an uneven split of n = x.shape[-1]
    n = x.shape[-1]
    xr = tp.shard(torch.from_numpy(x), ("block", 1), axis).clone()
    wr = tp.shard(torch.from_numpy(w[0]), ("block", 0), axis).clone()
    br = tp.shard(torch.from_numpy(w[1]), ("block", 0), axis).clone()
    for p in (xr, wr, br):
        p.requires_grad_(True)
    y = tp.sharded_layer_norm(xr, wr, br, 1e-6, n, axis)
    (y * tp.shard(torch.from_numpy(gw), ("block", 1), axis)).sum().backward()
    out["ln"] = (y.detach().numpy(), xr.grad.numpy(), wr.grad.numpy(),
                 br.grad.numpy())
    # the fused qkv gathered whole over the group, and a block leaf
    qkv = torch.arange(4 * 24, dtype=torch.float32).reshape(4, 24)
    part = tp.shard(qkv, ("qkv", 1), axis)
    out["qkv"] = tp.gather_leaf(part, ("qkv", 1), 24, axis).numpy()
    v = torch.arange(7, dtype=torch.float32)
    out["block"] = tp.gather_leaf(tp.shard(v, ("block", 0), axis),
                                  ("block", 0), 7, axis).numpy()
    # tokens scattered and gathered, with their gradients
    s = torch.from_numpy(seq).requires_grad_(True)
    shard = tp.scatter_sequence(s, 1, axis)
    back = shard.gather()
    (back * torch.from_numpy(gw[:, :seq.shape[1], None]) * (rank + 1)
     ).sum().backward()
    out["seq"] = (shard.local.detach().numpy(), back.detach().numpy(),
                  s.grad.numpy())
    with torch.no_grad():
        ref = layer_norm(torch.from_numpy(x), torch.from_numpy(w[0]),
                         torch.from_numpy(w[1]), 1e-6)
    out["ref"] = ref.numpy()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 171)).astype(np.float32) * 2 + 0.5
    w = np.stack([1 + 0.1 * rng.standard_normal(171),
                  0.1 * rng.standard_normal(171)]).astype(np.float32)
    gw = rng.standard_normal((3, 171)).astype(np.float32)
    seq = rng.standard_normal((3, 25, 4)).astype(np.float32)
    out = run_ranks(_rank_checks, 2, tmp_path_factory.mktemp("tp"), x, w,
                    gw, seq)
    return x, w, gw, seq, out


def test_sharded_layer_norm_matches_layer_norm(ranks):
    x, w, gw, _, out = ranks
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w[0]).requires_grad_(True)
    bt = torch.from_numpy(w[1]).requires_grad_(True)
    from mico_tpu_torch.ops.layers import layer_norm

    y = layer_norm(xt, wt, bt, 1e-6)
    (y * torch.from_numpy(gw)).sum().backward()
    a, b = tp.block_range(171, 2, 0)[1], 171
    got_y = np.concatenate([o["ln"][0] for o in out], 1)
    got_dx = np.concatenate([o["ln"][1] for o in out], 1)
    got_dw = np.concatenate([o["ln"][2] for o in out])
    got_db = np.concatenate([o["ln"][3] for o in out])
    assert out[0]["ln"][0].shape == (3, a) and out[1]["ln"][0].shape == (
        3, b - a)
    np.testing.assert_allclose(got_y, y.detach().numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_y, out[0]["ref"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_dx, xt.grad.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_dw, wt.grad.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_db, bt.grad.numpy(), rtol=0, atol=ATOL)


def test_qkv_gathered_over_ranks(ranks):
    *_, out = ranks
    want = np.arange(4 * 24, dtype=np.float32).reshape(4, 24)
    for r, o in enumerate(out):
        assert o["axis"] == (2, r)
        np.testing.assert_array_equal(o["qkv"], want)
        np.testing.assert_array_equal(o["block"], np.arange(7))


def test_token_scatter_gather_uneven(ranks):
    """25 tokens over 2 ranks: blocks of 13 (the second padded with a
    zero token), gathered back to 25; the gradient of the gather is
    reduce-scattered (both ranks' cotangents summed, rank r's scaled by
    r + 1) and the scatter's all-gathered, so each rank gets the whole."""
    _, _, gw, seq, out = ranks
    np.testing.assert_array_equal(out[0]["seq"][0], seq[:, :13])
    np.testing.assert_array_equal(out[1]["seq"][0][:, :12], seq[:, 13:])
    np.testing.assert_array_equal(out[1]["seq"][0][:, 12], 0)
    want_grad = 3 * gw[:, :25, None].repeat(4, 2)
    for o in out:
        np.testing.assert_array_equal(o["seq"][1], seq)
        np.testing.assert_allclose(o["seq"][2], want_grad, rtol=1e-6)
