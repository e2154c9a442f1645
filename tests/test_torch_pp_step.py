"""The port's pipeline-parallel (GPipe) training step on gloo ranks on the
CPU against JAX's single-device `make_train_step` on the global batch
(JAX's pipeline is a layout of that one program, and its own
tests/test_pipeline_parallel.py:161-210 holds its pipelined step to the
unpipelined one), at the tiny fp32 config with four ViT blocks, dropout
off and JAX's draws recorded and injected:

  - one `ret%tva_cap%tva` update at stages 2 (2 ranks, ZeRO-1 off) and at
    data 2 × stages 2 (4 ranks, ZeRO-1 on) against JAX's single-device
    step (losses rtol 1e-4; parameters rtol 2e-4, atol 2e-5), the ZeRO-1
    case also against JAX's dp4 × pp2 mesh step (ZeRO-1, `model_axis=None`
    as JAX's run.py passes it under pipeline stages); every replicated
    leaf (the patch embedding, `cls_token`, `pos_embed`, the final norm,
    BERT, the heads) identical on every stage after the step;
  - the draws: with every rate above 0 (and RoPE, whose tables
    PatchDropout gathers per sample) and the ranks' own generators, both
    stages give the losses and parameters of one process at that data
    index;
  - the checkpoint saved at stages 2 is JAX's full layout: JAX's
    `resume_latest` and `load_latest_opt_state` read it, and the port
    resumes it at stages 1 (one process), at stages 2 and at
    `model_parallel` 2 with JAX's moments;
  - the evaluation at stages 2, on the tower gathered whole, equals one
    process's;
  - `python -m mico_tpu_torch.run` with `run_cfg.pipeline_stages=2` on two
    CPU processes trains, evaluates and saves `model_step_2`.
The ranks of each mesh are spawned once and run every case while JAX
takes its steps.
"""

import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.parallel.mesh import create_mesh as jax_mesh
from mico_tpu.train import checkpoints as jckpt
from mico_tpu.train import optim as joptim
from mico_tpu.train import train_step as jtrain_step
from mico_tpu_torch.convert import mico_from_jax, params_from_jax
from mico_tpu_torch.parallel.pipeline_parallel import (StageAxis,
                                                       stage_module,
                                                       summed_names)
from mico_tpu_torch.train import checkpoints as tckpt
from mico_tpu_torch.train.objectives import compute_features
from mico_tpu_torch.train.optim import OptimConfig, build_optimizer

from test_torch_data_parallel import NO_DROPOUT, OC, _record
from test_torch_run import ROOT, corpus  # noqa: F401
from test_torch_tp_step import LOSS_TOL, PARAM_TOL, TASK, _batch
from torch_dist_common import pp_steps, run_ranks
from torch_port_common import configs, perturbed_params, to_numpy

LAYERS = 4
EVA = dict(layers=LAYERS)
RATES = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


def _jax_step(jcfg, params, batch):
    """JAX's single-device update. → (losses, params, optimizer state)."""
    jopt = joptim.build_optimizer(params, joptim.OptimConfig(**OC))
    step = jtrain_step.make_train_step(jcfg, jopt, TASK, donate=False)
    p, state, losses = step(params, jopt.init(params), {
        k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    return {k: float(v) for k, v in losses.items()}, to_numpy(p), state


def _jax_pp_mesh_step(jcfg, params, batch):
    """JAX's pipelined step (`pipeline_stages=2`) on the dp4 × pp2 mesh
    with ZeRO-1, the parameters replicated over `model` (JAX's run.py:
    222-225). → (losses, params)."""
    jcfg = dataclasses.replace(jcfg, pipeline_stages=2)
    jopt = joptim.build_optimizer(params, joptim.OptimConfig(**OC))
    mesh = jax_mesh(data=4, model=2)
    step = jtrain_step.make_train_step(jcfg, jopt, TASK, donate=False,
                                       mesh=mesh, zero1=True,
                                       model_axis=None)
    with jax.sharding.set_mesh(mesh):
        p, s = jtrain_step.shard_train_state(
            mesh, params, jopt.init(params), model_axis=None, zero1=True)
        p, _, losses = step(p, s, jtrain_step.shard_batch(mesh, {
            k: jnp.asarray(v) for k, v in batch.items()}),
            jax.random.PRNGKey(0))
    return {k: float(v) for k, v in losses.items()}, to_numpy(p)


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    rng = np.random.default_rng(20)
    batch = _batch(rng)
    ev = {k: v for k, v in _batch(rng).items()
          if k in ("vision_pixels", "audio_spectrograms")}
    jcfg, tcfg = configs(eva=EVA, bert=NO_DROPOUT)
    params = perturbed_params(jcfg, seed=5)
    pool = ThreadPoolExecutor(4)
    # JAX compiles its two steps and its recording of the draws side by side
    want = pool.submit(_jax_step, jcfg, params, batch)
    mesh_want = pool.submit(_jax_pp_mesh_step, jcfg, params, batch)
    call = _record(jcfg, params, TASK, [batch], [0])[0]
    start = to_numpy(params)
    pcfg = dataclasses.replace(tcfg, pipeline_stages=2)
    # RoPE too: its tables are gathered per sample for the kept patches
    # and split with the microbatches
    rates_cfg = configs(eva=dict(EVA, drop_path_rate=0.1, patch_dropout=0.5,
                                 rope=True), bert=RATES)[1]
    rates_cfg = dataclasses.replace(rates_cfg, itm_ratio=1.0)
    base = dict(task=TASK, params=start, oc=OC, call=call)
    s2 = [dict(base, zero1=False, tcfg=pcfg, eval=ev, save=True),
          dict(base, zero1=False, tcfg=dataclasses.replace(
              rates_cfg, pipeline_stages=2), call=(batch, [], []), seed=7),
          dict(base, resume="pp", tcfg=pcfg),
          dict(base, resume="tp", tcfg=tcfg),
          dict(base, accum=True, tcfg=pcfg, batches=[batch, _batch(rng)])]
    d2s2 = [dict(base, zero1=True, tcfg=pcfg)]
    save_dir = tmp_path_factory.mktemp("pp_ckpt")
    with pool:
        got_s2 = pool.submit(run_ranks, pp_steps, 2, tmp_path_factory.mktemp(
            "s2"), 2, s2, save_dir)
        got_d2s2 = pool.submit(run_ranks, pp_steps, 4,
                               tmp_path_factory.mktemp("d2s2"), 2, d2s2)
        want, mesh_want = want.result(), mesh_want.result()
        got_s2, got_d2s2 = got_s2.result(), got_d2s2.result()
    # the draws' one process at data index 0, and the evaluation's
    one = pp_steps(0, 1, 1, [dict(s2[1], tcfg=rates_cfg)])[0]
    whole = mico_from_jax(start, tcfg, device="cpu")
    with torch.no_grad():
        one_eval = compute_features(whole, tcfg, {
            k: torch.from_numpy(v) for k, v in ev.items()}, "va")
    return dict(want=want, mesh_want=mesh_want, tcfg=tcfg, start=start,
                s2=got_s2, d2s2=got_d2s2, one=one, save_dir=str(save_dir),
                one_eval={k: v.numpy() for k, v in one_eval.items()},
                summed=summed_names(stage_module(
                    mico_from_jax(start, pcfg, device="cpu"),
                    StageAxis(None, 2, 0, (0, 1)))))


def _check_losses(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **LOSS_TOL,
                                   err_msg=f"{what} {k}")


def _check_params(got, want_tree, tcfg, what, start=None):
    want = {k: v.numpy() for k, v in params_from_jax(want_tree,
                                                     tcfg).items()}
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        np.testing.assert_allclose(p, want[name], **PARAM_TOL,
                                   err_msg=f"{what} {name}")
    if start is not None:
        start = {k: v.numpy() for k, v in params_from_jax(start,
                                                          tcfg).items()}
        moved = max(float(np.abs(want[k] - start[k]).max()) for k in want)
        assert moved > 100 * PARAM_TOL["atol"]


@pytest.mark.parametrize("mesh", ["s2", "d2s2"])
def test_pp_step_matches_jax_single_device(stepped, mesh):
    s = stepped
    want_losses, want_params, _ = s["want"]
    outs = [o[0] for o in s[mesh]]
    world = len(outs)
    for o in outs:
        assert o["mesh"] == {"data": world // 2, "model": 2}
        _check_losses(o["losses"], want_losses, mesh)
        _check_params(o["params"], want_params, s["tcfg"], mesh, s["start"])
        # a stage holds half of the blocks
        assert o["local_numel"] < sum(p.size for p in o["params"].values())
    assert sorted(o["index"] for o in outs) == sorted(
        (r // 2, r % 2) for r in range(world))
    zero1 = mesh == "d2s2"
    for o in outs:
        assert (o["moment_numel"] < 0.75 * o["local_numel"] if zero1
                else o["moment_numel"] == o["local_numel"])


def test_pp_step_matches_jax_dp_pp_mesh(stepped):
    s = stepped
    losses, params = s["mesh_want"]
    for o in s["d2s2"]:
        _check_losses(o[0]["losses"], losses, "dp4xpp2")
        _check_params(o[0]["params"], params, s["tcfg"], "dp4xpp2")


@pytest.mark.parametrize("mesh", ["s2", "d2s2"])
def test_replicated_leaves_identical_on_every_stage(stepped, mesh):
    """Item 3's trap: the leaves upstream of the pipeline (summed over the
    model group), the shared ones and those downstream (not summed) end
    the step identical on both stages, bit for bit."""
    s = stepped
    assert s["summed"] == {
        "vision_encoder.patch_embed.kernel", "vision_encoder.patch_embed.bias",
        "vision_encoder.cls_token", "vision_encoder.pos_embed"}
    outs = [o[0]["params"] for o in s[mesh]]
    names = ("vision_encoder.patch_embed.kernel", "vision_encoder.cls_token",
             "vision_encoder.pos_embed", "vision_encoder.norm_w",
             "bert.layers.0.q_w", "itm_head.fc1_w")
    for a, b in zip(outs[::2], outs[1::2]):
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    for name in names:
        assert name in outs[0]


def test_draws_equal_one_process_at_the_data_index(stepped):
    """Every rate above 0 and the ranks' own generators (seeded by the data
    index): both stages draw what one process draws, so their losses and
    parameters are one process's; the rates bite."""
    s = stepped
    a, b = (o[1] for o in s["s2"])
    for k in a["losses"]:
        assert a["losses"][k] == b["losses"][k], k
        np.testing.assert_allclose(a["losses"][k], s["one"]["losses"][k],
                                   **LOSS_TOL, err_msg=k)
    for name in a["params"]:
        np.testing.assert_allclose(a["params"][name],
                                   s["one"]["params"][name], **PARAM_TOL,
                                   err_msg=name)
    plain = s["want"][0]
    assert abs(a["losses"]["loss_cap"] - plain["loss_cap"]) > 1e-3


def _check_moments(leaves, want_state, what):
    jleaves = jax.tree.leaves(want_state)
    assert len(leaves) == len(jleaves)
    for got, want in zip(leaves, jleaves):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=2e-4,
                                   atol=1e-9, err_msg=what)


def test_checkpoint_at_stages_2_is_jax_layout_and_resumes(stepped):
    s = stepped
    out = s["save_dir"]
    _, want_params, want_state = s["want"]
    # JAX's loaders read both files: the model, and the optax state into
    # its own optimizer's tree
    params, _, step = jckpt.resume_latest(out)
    assert step == 1
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        b = want_params
        for k in path:
            b = b[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_allclose(np.asarray(a), b, **PARAM_TOL,
                                   err_msg=str(path))
    jopt = joptim.build_optimizer(params, joptim.OptimConfig(**OC))
    state = jckpt.load_latest_opt_state(out, jopt.init(params))
    _check_moments(jax.tree.leaves(state), want_state, "JAX's reader")
    # the port at stages 1: the model, then the moments in its optimizer
    tcfg = s["tcfg"]
    model = mico_from_jax(s["start"], tcfg, device="cpu")
    assert tckpt.resume_latest(out, model) == 1
    saved = s["s2"][0][0]["params"]
    for name, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), saved[name], err_msg=name)
    opt = build_optimizer(model, OptimConfig(**OC))
    assert tckpt.load_latest_opt_state(out, opt, step=1)
    assert opt.count == 1
    _check_moments([np.stack([r.numpy() for r in rows]) if st
                    else rows[0].numpy()
                    for _, rows, st in tckpt.optimizer_leaves(opt)],
                   want_state, "stages 1")
    # at stages 2 and at model_parallel 2, on the two ranks
    for o, what in ((o[2], "stages 2") for o in s["s2"]):
        assert o["step"] == 1 and o["count"] == 1
        for name, p in o["params"].items():
            np.testing.assert_array_equal(p, saved[name], err_msg=name)
        _check_moments(o["leaves"], want_state, what)
    for o in (o[3] for o in s["s2"]):
        for name, p in o["params"].items():
            np.testing.assert_array_equal(p, saved[name], err_msg=name)
        _check_moments(o["leaves"], want_state, "model_parallel 2")


def test_accumulation_window_resumes_at_stages_2(stepped):
    """A save in the middle of a 2-step accumulation window at stages 2
    (the window's mean in JAX's MultiSteps layout; the leaves summed over
    the stages held by stage 0 again on load) and a resume give the
    straight window's update."""
    for o in (o[4] for o in stepped["s2"]):
        for name, p in o["straight"].items():
            np.testing.assert_allclose(o["resumed"][name], p, rtol=1e-6,
                                       atol=1e-8, err_msg=name)


def test_evaluation_on_the_gathered_tower(stepped):
    """The evaluation's features at stages 2, on the tower gathered whole
    (before the step), equal one process's; the gathered blocks are
    freed after it."""
    s = stepped
    for o in (o[0] for o in s["s2"]):
        assert o["numel_after_eval"] == o["local_numel"]
        for k, want in s["one_eval"].items():
            np.testing.assert_allclose(o["eval"][k], want, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_seed_divisor_is_the_stages():
    """The host seeds (`seed + rank // model axis`) give both stages of a
    data index one seed: under pipeline stages the model axis is S, not
    `model_parallel` (JAX's run.py:126 overrides it)."""
    from mico_tpu_torch.run import model_axis_size

    assert model_axis_size({"pipeline_stages": 2, "model_parallel": 1}) == 2
    assert model_axis_size({"pipeline_stages": 1, "model_parallel": 2}) == 2
    assert model_axis_size({}) == 1


def test_run_cli_at_pipeline_stages_2(corpus, tmp_path):  # noqa: F811
    """Two CPU processes at `run_cfg.pipeline_stages=2` (one data index;
    `model_parallel` overridden by the stages): two training steps, an
    evaluation and a save after each; rank 0 writes the record and the
    files, and the steps' losses are finite."""
    _, cfg_path = corpus
    out = str(tmp_path / "out")
    store = tmp_path / "rendezvous"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mico_tpu_torch.run", "--config",
         str(cfg_path), "--output_dir", out, "--device", "cpu",
         "run_cfg.multihost=true",
         f"run_cfg.coordinator_address=file://{store}",
         "run_cfg.num_processes=2", f"run_cfg.process_id={r}",
         "run_cfg.pipeline_stages=2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    assert "pipeline: 2 stages" in logs[0]
    with open(os.path.join(out, "log", "record.json")) as f:
        rec = json.load(f)
    assert rec["mesh"] == {"data": 1, "model": 2} and rec["world"] == 1
    assert [s["step"] for s in rec["steps"]] == [1, 2]
    assert all(np.isfinite(v) for s in rec["steps"]
               for v in s["losses"].values())
    assert [e["step"] for e in rec["evals"]] == [1, 2]
    files = os.listdir(os.path.join(out, "ckpt"))
    assert {"model_step_2.npz", "optimizer_step_2.npz"} <= set(files)
