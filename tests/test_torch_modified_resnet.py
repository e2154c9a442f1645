"""The port's ModifiedResNet (`mico_tpu_torch/models/modified_resnet.py`)
against `mico_tpu.models.modified_resnet` on the CPU in fp32: the forward
on one JAX tree of weights (drawn here: He-normal convs, BNs near identity
with positive variances) carried over by
`convert.modified_resnet_from_jax`, at layers (1, 1, 1, 1), width 8, 4
heads, 64 px, and at (2, 1, 1, 1); `modified_resnet_from_torch` against
JAX's on a synthetic released state dict with every block downsampling,
and with a block that has no downsample keys. Tolerance: `MODEL_TOL`
(rtol = atol = 1e-4) for outputs, `OP_TOL` for converted leaves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.models import modified_resnet as jrn
from mico_tpu_torch.convert import modified_resnet_from_jax
from mico_tpu_torch.models import modified_resnet as trn

from torch_port_common import MODEL_TOL, OP_TOL, close, no_launch, t

GEOMETRY = dict(output_dim=24, heads=4, image_size=64, width=8)
forward = jax.jit(jrn.modified_resnet_forward, static_argnums=1)


def cfgs(layers):
    return (jrn.ModifiedResNetConfig(layers=layers, **GEOMETRY),
            trn.ModifiedResNetConfig(layers=layers, **GEOMETRY))


def drawn_params(jcfg, seed=0):
    """`init_modified_resnet`'s tree (its structure by `jax.eval_shape`),
    drawn here: convs He-normal, BN affines and statistics near their
    identity (variances positive), the pool normal · embed_dim^-0.5."""
    shapes = jax.eval_shape(lambda k: jrn.init_modified_resnet(k, jcfg),
                            jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(s.shape).astype(np.float32)
        if len(s.shape) == 4:
            return z * np.float32((2.0 / np.prod(s.shape[1:])) ** 0.5)
        if name.endswith(("['w']", "['var']")):
            return 1.0 + 0.1 * np.abs(z) if "var" in name else 1.0 + 0.1 * z
        if name.endswith(("['b']", "['mean']")):
            return 0.1 * z
        return z * np.float32(jcfg.embed_dim ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module", params=[(1, 1, 1, 1), (2, 1, 1, 1)],
                ids=["all-downsample", "one-plain-block"])
def nets(request):
    jcfg, tcfg = cfgs(request.param)
    params = drawn_params(jcfg)
    return params, jcfg, tcfg


def test_forward_matches_jax(nets):
    params, jcfg, tcfg = nets
    model = modified_resnet_from_jax(params, tcfg, device="cpu")
    x = np.random.default_rng(0).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    want = forward(params, jcfg, jnp.asarray(x))
    got = no_launch(lambda: trn.modified_resnet_forward(model, t(x)))
    assert got.shape == (2, 24)
    close(got, want, MODEL_TOL)


def released_state_dict(params, cfg):
    """The reference module's state dict (numpy fp32) of JAX's params."""
    sd = {}

    def bn(name, p):
        for leaf, key in (("w", "weight"), ("b", "bias"),
                          ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{name}.{key}"] = p[leaf]

    for i in (1, 2, 3):
        sd[f"conv{i}.weight"] = params[f"stem_conv{i}"]
        bn(f"bn{i}", params[f"stem_bn{i}"])
    for si, stage in enumerate(params["stages"]):
        for bi, p in enumerate(stage):
            base = f"layer{si + 1}.{bi}"
            for n in (1, 2, 3):
                sd[f"{base}.conv{n}.weight"] = p[f"conv{n}"]
                bn(f"{base}.bn{n}", p[f"bn{n}"])
            if "down_conv" in p:
                sd[f"{base}.downsample.0.weight"] = p["down_conv"]
                bn(f"{base}.downsample.1", p["down_bn"])
    ap = params["attnpool"]
    sd["attnpool.positional_embedding"] = ap["pos"]
    for short, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                        ("c", "c_proj")):
        sd[f"attnpool.{name}.weight"] = ap[f"{short}_w"].T
        sd[f"attnpool.{name}.bias"] = ap[f"{short}_b"]
    return {f"visual.{k}": np.array(a, np.float32, order="C")
            for k, a in sd.items()}


def test_from_torch_matches_jax(nets):
    params, jcfg, tcfg = nets
    sd = released_state_dict(params, jcfg)
    # every first block downsamples; layer1's second block, where there is
    # one, does not
    assert all(f"visual.layer{i}.0.downsample.0.weight" in sd
               for i in (1, 2, 3, 4))
    assert ("visual.layer1.1.conv1.weight" in sd) == (jcfg.layers[0] == 2)
    assert "visual.layer1.1.downsample.0.weight" not in sd
    jtree = jrn.modified_resnet_from_torch(sd, jcfg, prefix="visual.")
    ttree = trn.modified_resnet_from_torch(
        {k: torch.from_numpy(a) for k, a in sd.items()}, tcfg,
        prefix="visual.")

    def leaves(tree):
        return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
                for p, a in jax.tree_util.tree_leaves_with_path(tree)}

    want = leaves(jtree)
    got = leaves(jax.tree.map(lambda a: a.numpy(), ttree))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **OP_TOL)
    model = modified_resnet_from_jax(ttree, tcfg, device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    close(trn.modified_resnet_forward(model, t(x)),
          forward(jtree, jcfg, jnp.asarray(x)), MODEL_TOL)


def test_fresh_model_and_refusals(monkeypatch):
    """A drawn RN has JAX's tree of names and shapes; the card is the
    default device, and its absence raises."""
    jcfg, tcfg = cfgs((1, 1, 1, 1))
    model = trn.ModifiedResNet(tcfg, device="cpu", seed=1)
    shapes = jax.eval_shape(lambda k: jrn.init_modified_resnet(k, jcfg),
                            jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p).replace("']['", ".").strip("[']")
            .replace("][", ".").replace("'", ""): tuple(s.shape)
            for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    out = trn.modified_resnet_forward(model, torch.zeros(1, 3, 64, 64))
    assert out.shape == (1, 24) and torch.isfinite(out).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trn.ModifiedResNet(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        modified_resnet_from_jax({}, tcfg)
