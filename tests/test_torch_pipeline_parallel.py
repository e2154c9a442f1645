"""The port's GPipe schedule (`mico_tpu_torch.parallel.pipeline_parallel`)
on gloo ranks on the CPU against JAX's `pipelined`
(`mico_tpu/parallel/pipeline_parallel.py`) on the 8-device CPU mesh, as
JAX's own tests/test_pipeline_parallel.py holds it:

  - JAX's toy layer stack (tanh(h @ w + b), L 8, D 16, B 8) at (S, M) =
    (2, 4) and (4, 2): the forward against JAX's `pipelined` and the
    sequential scan (rtol 1e-5), every gradient against JAX's (rtol 1e-4);
  - `auto_n_micro` against JAX's `_auto_n_micro` over B 1–16 and S 2–4,
    and the ValueErrors of an explicit M that does not divide B and of
    blocks that do not divide over the stages; a stage's blocks under
    their global names, and JAX's replicated spec under stages;
  - `eva_vit_forward` at `pipeline_stages=2` on data 2 × stages 2 (4
    ranks) for a pre-norm tower and an EVA02-like one (RoPE, SwiGLU,
    sub-LN, the shared relative-position table) against JAX's
    `eva_vit_forward` unpipelined and under the dp4 × pp2 mesh
    (tests/test_pipeline_parallel.py:135-158; rtol 2e-5), and the
    tower's gradients after the optimizer's `sync_grads` against JAX's
    (rtol 1e-4, atol 1e-5 of the leaf's scale): the patch embedding, `cls_token`, `pos_embed` and the
    shared table (summed over the stages) equal on both stages.
The four ranks are spawned once and run every case while JAX computes its
references.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.models.eva_vit import eva_vit_forward as jax_eva_vit_forward
from mico_tpu.parallel.mesh import create_mesh as jax_mesh
from mico_tpu.parallel.pipeline_parallel import _auto_n_micro, pipelined
from mico_tpu_torch.models.mico import MiCo
from mico_tpu_torch.parallel import pipeline_parallel as tpp
from mico_tpu_torch.parallel.pipeline_parallel import StageAxis

from torch_dist_common import pp_schedule_checks, run_ranks
from torch_port_common import configs, perturbed_params, to_numpy

L, D, B = 8, 16, 8
MESHES = [(2, 4), (4, 2)]            # (stages, microbatches)
TOWERS = {
    "pre-norm": dict(layers=4),
    "eva02": dict(layers=4, rope=True, naiveswiglu=True, subln=True,
                  intp_freq=True, mlp_ratio=2.672,
                  use_shared_rel_pos_bias=True),
}
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TOWER_TOL = dict(rtol=2e-5, atol=2e-5)

def _close_grad(got, want, name):
    """JAX's gradient tolerance (rtol 1e-4, atol 1e-5) with atol taken
    relative to the leaf's largest magnitude: a leaf summed over every
    token of the batch (`cls_token`, `pos_embed`) reaches ~40, where the
    two frameworks' fp32 sums differ in the fifth digit."""
    np.testing.assert_allclose(
        got, want, rtol=GRAD_TOL["rtol"],
        atol=GRAD_TOL["atol"] * max(1.0, float(np.abs(want).max())),
        err_msg=name)


def _toy():
    rng = np.random.default_rng(0)
    return dict(w=(rng.standard_normal((L, D, D)) * 0.3).astype(np.float32),
                b=(rng.standard_normal((L, D)) * 0.1).astype(np.float32),
                x=rng.standard_normal((B, D)).astype(np.float32))


def _layer_fn(lp, x):
    out, _ = jax.lax.scan(lambda h, p: (jnp.tanh(h @ p[0] + p[1]), None), x,
                          (lp["w"], lp["b"]))
    return out


def _jax_toy(toy, stages, n_micro):
    """JAX's `pipelined` on the first `stages` CPU devices and the
    sequential scan: (pipelined out, sequential out, pipelined grads of
    sum(out²) as {w, b, x})."""
    from jax.sharding import Mesh

    params = {"w": jnp.asarray(toy["w"]), "b": jnp.asarray(toy["b"])}
    x = jnp.asarray(toy["x"])
    mesh = Mesh(np.array(jax.devices()[:stages]), ("model",))
    f = pipelined(_layer_fn, mesh, axis="model", n_micro=n_micro)
    out, grads = jax.jit(jax.value_and_grad(
        lambda p, x: (jnp.sum(f(p, x) ** 2), f(p, x)), argnums=(0, 1),
        has_aux=True))(params, x)
    return (np.asarray(out[1]), np.asarray(jax.jit(_layer_fn)(params, x)),
            dict(w=np.asarray(grads[0]["w"]), b=np.asarray(grads[0]["b"]),
                 x=np.asarray(grads[1])))


def _jax_tower(jcfg, params, pixels, w):
    """JAX's tower unpipelined and under the dp4 × pp2 mesh, and the
    unpipelined gradient of sum(tokens · w) / 2 (the port's optimizer
    averages the two data indices' gradients)."""
    vp, ecfg = params["vision_encoder"], jcfg.eva_config
    x = jnp.asarray(pixels)

    def fwd(p, stages=1):
        return jax_eva_vit_forward(p, ecfg, x, attn_impl="xla",
                                   pipeline_stages=stages,
                                   pipeline_microbatches=(
                                       2 if stages > 1 else None))

    want = np.asarray(jax.jit(fwd)(vp))
    with jax.sharding.set_mesh(jax_mesh(data=4, model=2)):
        meshed = np.asarray(jax.jit(lambda p: fwd(p, 2))(vp))
    grads = jax.jit(jax.grad(lambda p: jnp.sum(fwd(p) * w) / 2))(vp)
    return want, meshed, to_numpy(grads)


def _perturbed_tower(jcfg, seed: int = 3, scale: float = 0.05) -> dict:
    """`init_eva_vit` params of `jcfg`'s tower with N(0, scale) added to
    every leaf, as `perturbed_params` draws a whole MiCo's."""
    from mico_tpu.models.eva_vit import init_eva_vit

    tree = jax.jit(init_eva_vit, static_argnums=1)(jax.random.PRNGKey(seed),
                                                   jcfg.eva_config)
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + scale * (
        rng.standard_normal(a.shape).astype(np.float32))), tree)


@pytest.fixture(scope="module")
def checked(tmp_path_factory):
    toy = _toy()
    rng = np.random.default_rng(21)
    towers, refs = [], {}
    pixels = rng.standard_normal((8, 3, 28, 28)).astype(np.float32)
    base = None
    for name, eva in TOWERS.items():
        jcfg, tcfg = configs(eva=eva, pipeline_stages=2)
        if base is None:
            params = base = perturbed_params(jcfg, seed=2)
        else:       # the same MiCo with this tower (one init compile less)
            params = dict(base, vision_encoder=_perturbed_tower(jcfg))
        w = rng.standard_normal((8, 5, 64)).astype(np.float32)
        towers.append(dict(params=to_numpy(params), tcfg=tcfg,
                           pixels=pixels, w=w))
        refs[name] = (jcfg, params, w)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, pp_schedule_checks, 4,
                            tmp_path_factory.mktemp("pp"), toy, MESHES,
                            towers)
        jax_toy = [_jax_toy(toy, s, m) for s, m in MESHES]
        jax_towers = {name: _jax_tower(jcfg, params, pixels, w)
                      for name, (jcfg, params, w) in refs.items()}
        ranks = ranks.result()
    return dict(toy=toy, ranks=ranks, jax_toy=jax_toy,
                jax_towers=jax_towers)


@pytest.mark.parametrize("case", range(len(MESHES)),
                         ids=[f"S{s}-M{m}" for s, m in MESHES])
def test_schedule_matches_jax_pipelined(checked, case):
    stages, _ = MESHES[case]
    jax_out, seq_out, jax_grads = checked["jax_toy"][case]
    np.testing.assert_allclose(jax_out, seq_out, **FWD_TOL)
    got_w = np.zeros_like(jax_grads["w"])
    got_b = np.zeros_like(jax_grads["b"])
    outs = [r["toy"][case] for r in checked["ranks"]]
    for rank, o in enumerate(outs):
        np.testing.assert_allclose(o["out"], jax_out, **FWD_TOL)
        np.testing.assert_allclose(o["out"], seq_out, **FWD_TOL)
        if rank < stages:                   # the first model group
            a, b = o["layers"]
            assert (a, b) == (rank * L // stages, (rank + 1) * L // stages)
            got_w[a:b], got_b[a:b] = o["w"], o["b"]
            # x's gradient on stage 0 alone (zeros on the others)
            if rank == 0:
                np.testing.assert_allclose(o["x"], jax_grads["x"],
                                           **GRAD_TOL)
            else:
                assert not o["x"].any()
    np.testing.assert_allclose(got_w, jax_grads["w"], **GRAD_TOL)
    np.testing.assert_allclose(got_b, jax_grads["b"], **GRAD_TOL)


def test_auto_n_micro_matches_jax():
    for stages in (2, 3, 4):
        for batch in range(1, 17):
            assert tpp.auto_n_micro(batch, stages) == _auto_n_micro(
                batch, stages), (batch, stages)


def test_explicit_microbatches_must_divide_the_batch():
    """JAX's ValueError, before any hop (a stage axis with no group)."""
    axis = StageAxis(None, 2, 0, (0, 1))
    x = torch.zeros(B, D)
    for bad in (3, B + 1):
        with pytest.raises(ValueError, match="pipeline_microbatches"):
            tpp.pipelined(lambda blocks, h: h, axis, bad)([], x)
    assert tpp.n_micro_for(None, 6, 2) == 3
    assert tpp.bubble(2, 4) == pytest.approx(0.2)


def test_blocks_must_divide_over_the_stages():
    _, tcfg = configs(eva=dict(layers=3), pipeline_stages=2)
    model = MiCo(tcfg, device="cpu")
    with pytest.raises(ValueError, match="vision_encoder.*3 blocks"):
        tpp.stage_module(model, StageAxis(None, 2, 0, (0, 1)))
    # a tower run whole at pipeline_stages=2 names the mesh it needs
    from mico_tpu_torch.models.eva_vit import eva_vit_forward

    with pytest.raises(ValueError, match="model=2"):
        eva_vit_forward(model.vision_encoder, torch.zeros(1, 3, 28, 28),
                        pipeline_stages=2)


def test_stage_layout_and_replicated_specs():
    """A stage holds its blocks under their global names and nothing of
    the others'; JAX's spec under pipeline stages (`model_axis=None`) is
    the replicated one on every leaf, which ZeRO-1 splits over `data`."""
    from mico_tpu.models.mico import init_mico
    from mico_tpu.parallel.partition import mico_param_specs as jax_specs
    from mico_tpu_torch.parallel.partition import (block_stage,
                                                   mico_param_specs,
                                                   zero1_split_spec)

    jcfg, tcfg = configs(eva=dict(layers=4), pipeline_stages=2)
    model = tpp.stage_module(MiCo(tcfg, device="cpu"),
                             StageAxis(None, 2, 1, (0, 1)))
    names = [n for n, _ in model.named_parameters()]
    blocks = {int(n.split(".")[2]) for n in names
              if n.startswith("vision_encoder.blocks.")}
    assert blocks == {2, 3} == {i for i in range(4)
                                if block_stage(i, 4, 2) == 1}
    assert set(tpp.remote_names(model)) == {
        n.replace(".blocks.2.", f".blocks.{i}.") for n in names
        if ".blocks.2." in n for i in (0, 1)}
    specs = mico_param_specs(model.named_parameters(), model_axis=None)
    assert set(specs.values()) == {()}
    shapes = jax.eval_shape(lambda: init_mico(jax.random.PRNGKey(0), jcfg))
    assert {tuple(p) for p in jax.tree.leaves(
        jax_specs(shapes, model_axis=None),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))} == {()}
    assert zero1_split_spec((4, 64, 192), (), 2) == ("data",)


@pytest.mark.parametrize("tower", list(TOWERS))
def test_eva_vit_forward_pipeline_stages_2(checked, tower):
    want, meshed, jgrads = checked["jax_towers"][tower]
    np.testing.assert_allclose(meshed, want, **TOWER_TOL)
    i = list(TOWERS).index(tower)
    outs = [r["towers"][i] for r in checked["ranks"]]
    for rank, o in enumerate(outs):
        d = rank // 2
        np.testing.assert_allclose(o["tokens"], want[4 * d:4 * (d + 1)],
                                   **TOWER_TOL)
        np.testing.assert_allclose(o["tokens"], meshed[4 * d:4 * (d + 1)],
                                   **TOWER_TOL)
    layers = TOWERS[tower]["layers"]
    summed = ["patch_embed.kernel", "patch_embed.bias", "cls_token",
              "pos_embed"] + (["rel_pos_bias_table"] if tower == "eva02"
                              else [])
    for rank, o in enumerate(outs):
        g = o["grads"]
        stage = rank % 2
        for name in summed:
            leaf = jgrads
            for part in name.split("."):
                leaf = leaf[part]
            _close_grad(g[f"vision_encoder.{name}"], leaf, name)
        # this stage's blocks hold JAX's rows; the others none
        for i in range(layers):
            key = f"vision_encoder.blocks.{i}.qkv_w"
            if i // (layers // 2) == stage:
                _close_grad(g[key], jgrads["blocks"]["qkv_w"][i], key)
            else:
                assert key not in g
    for name in summed:
        key = f"vision_encoder.{name}"
        np.testing.assert_array_equal(outs[0]["grads"][key],
                                      outs[1]["grads"][key])
