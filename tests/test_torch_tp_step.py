"""The port's tensor- and sequence-parallel step on gloo ranks on the CPU
against JAX's single-device `make_train_step` on the global batch (JAX's TP
and SP are GSPMD layouts of that one program), at the tiny fp32 config
with dropout off and JAX's draws recorded and injected, as
`tests/test_torch_data_parallel.py` holds the data-parallel step:

  - one `ret%tva_cap%tva` update at model 2 (2 ranks) and at data 2 ×
    model 2 (4 ranks), ZeRO-1 off and on, for a pre-norm ViT-g-like, a
    post-norm bigE-like (LayerScale) and an EVA02-like tower (RoPE,
    SwiGLU with an uneven hidden of 171, sub-LN), each against JAX's
    single-device step (losses rtol 1e-4; parameters rtol 2e-4, atol 2e-5,
    JAX's own tolerance in tests/test_training.py:323-375), and the
    pre-norm ZeRO-1 case also against JAX's dp4 × tp2 mesh step as that
    test builds it;
  - the seed trap: with every rate above 0 (hidden and attention dropout,
    DropPath, PatchDropout) and the ranks' own draws, both ranks of a
    model group give the same losses, equal to one process's at that
    data index;
  - sequence parallelism (`shard_condition_sequence`) over 25 condition
    tokens (uneven over 2) against the same step without it and against
    JAX's `shard_condition_sequence` losses on the dp4 × tp2 mesh
    (tests/test_training.py:257-280);
  - the checkpoint saved at model 2 is JAX's full layout (qkv as
    [q | k | v]; JAX's `resume_latest` reads it), and resumes at model 1
    in the port with JAX's moments;
  - `python -m mico_tpu_torch.run` with `run_cfg.model_parallel=2` on two
    CPU processes.
The ranks of a mesh are spawned once and run every case while JAX takes
its steps.
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

from mico_tpu.parallel.mesh import create_mesh as jax_mesh
from mico_tpu.train import checkpoints as jckpt
from mico_tpu.train import objectives as jobj
from mico_tpu.train import optim as joptim
from mico_tpu.train import train_step as jtrain_step
from mico_tpu_torch.convert import mico_from_jax, params_from_jax
from mico_tpu_torch.train import checkpoints as tckpt
from mico_tpu_torch.train.optim import OptimConfig, build_optimizer

from test_torch_data_parallel import NO_DROPOUT, OC, _record
from test_torch_run import ROOT, corpus  # noqa: F401
from torch_dist_common import run_ranks, tp_steps
from torch_port_common import configs, perturbed_params, to_numpy

TASK = "ret%tva_cap%tva"
B = 4
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
TOWERS = {
    "pre-norm": {},
    "post-norm": dict(postnorm=True, ls_init_value=0.1),
    "eva02": dict(rope=True, naiveswiglu=True, subln=True, intp_freq=True,
                  mlp_ratio=2.672),
}
MESHES = {"m2": (2, 2), "d2m2": (4, 2)}       # (processes, model)
CASES = [(mesh, tower, zero1) for mesh in MESHES for tower in TOWERS
         for zero1 in (False, True)]
RATES = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


def _batch(rng, frames: int = 2):
    ids = rng.integers(200, 20000, (B, 12)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((B, 12), np.int32)
    for i, n in enumerate((12, 9, 7, 12)):
        mask[i, n:] = 0
        ids[i, n:] = 0
    return {
        "vision_pixels": rng.standard_normal(
            (B, frames, 3, 28, 28)).astype(np.float32),
        "audio_spectrograms": rng.standard_normal(
            (B, 2, 28, 28)).astype(np.float32),
        "caption_ids": ids, "caption_mask": mask,
    }


def _jax_step(jcfg, params, batch, key: int = 0):
    """JAX's single-device update. → (losses, params, optimizer state)."""
    jopt = joptim.build_optimizer(params, joptim.OptimConfig(**OC))
    step = jtrain_step.make_train_step(jcfg, jopt, TASK, donate=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    p, state, losses = step(params, jopt.init(params), jbatch,
                            jax.random.PRNGKey(key))
    return {k: float(v) for k, v in losses.items()}, to_numpy(p), state


def _jax_mesh_step(jcfg, params, batch, key: int = 0):
    """JAX's step on the dp4 × tp2 mesh with ZeRO-1, the layout of
    tests/test_training.py:323-375. → (losses, params)."""
    jopt = joptim.build_optimizer(params, joptim.OptimConfig(**OC))
    mesh = jax_mesh(data=4, model=2)
    step = jtrain_step.make_train_step(jcfg, jopt, TASK, donate=False,
                                       mesh=mesh, zero1=True,
                                       model_axis="model")
    with jax.sharding.set_mesh(mesh):
        p, s = jtrain_step.shard_train_state(
            mesh, params, jopt.init(params), model_axis="model", zero1=True)
        p, _, losses = step(p, s, jtrain_step.shard_batch(mesh, {
            k: jnp.asarray(v) for k, v in batch.items()}),
            jax.random.PRNGKey(key))
    return {k: float(v) for k, v in losses.items()}, to_numpy(p)


def _jax_sp_losses(jcfg, params, batch, key: int = 0):
    """JAX's `shard_condition_sequence` losses on the dp4 × tp2 mesh
    (tests/test_training.py:257-280)."""
    cfg_sp = dataclasses.replace(jcfg, shard_condition_sequence=True)
    mesh = jax_mesh(data=4, model=2)
    with jax.sharding.set_mesh(mesh):
        got = jax.jit(lambda p, b: jobj.task_losses(
            jax.random.PRNGKey(key), p, cfg_sp, b, TASK, axis_name=None))(
            params, jtrain_step.shard_batch(mesh, {
                k: jnp.asarray(v) for k, v in batch.items()}))
    return {k: float(v) for k, v in got.items()}


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    rng = np.random.default_rng(19)
    batch = _batch(rng)
    sp_batch = _batch(rng, frames=3)
    refs, work, tcfgs = {}, {m: [] for m in MESHES}, {}
    for tower, flags in TOWERS.items():
        jcfg, tcfg = configs(eva=flags, bert=NO_DROPOUT)
        params = perturbed_params(jcfg, seed=5)
        call = _record(jcfg, params, TASK, [batch], [0])[0]
        refs[tower] = dict(jcfg=jcfg, params=params, call=call)
        tcfgs[tower] = tcfg
    start = {k: to_numpy(v["params"]) for k, v in refs.items()}
    for mesh, tower, zero1 in CASES:
        work[mesh].append(dict(task=TASK, zero1=zero1, params=start[tower],
                               tcfg=tcfgs[tower], oc=OC,
                               call=refs[tower]["call"]))
    # model 2 alone: SP on and off over the 3-frame batch, then the seed
    # trap, then the case whose files the checkpoint tests read
    jcfg, tcfg = configs(bert=NO_DROPOUT)
    params = refs["pre-norm"]["params"]
    sp_call = _record(jcfg, params, TASK, [sp_batch], [1])[0]
    rates_cfg = configs(eva=dict(drop_path_rate=0.1, patch_dropout=0.5),
                        bert=RATES)[1]
    rates_cfg = dataclasses.replace(rates_cfg, itm_ratio=1.0)
    extra = [dict(task=TASK, zero1=False, params=start["pre-norm"],
                  tcfg=dataclasses.replace(tcfg, shard_condition_sequence=sp),
                  oc=OC, call=sp_call) for sp in (False, True)]
    extra.append(dict(task=TASK, zero1=False, params=start["pre-norm"],
                      tcfg=rates_cfg, oc=OC, call=(batch, [], []), seed=7))
    extra.append(dict(work["m2"][1]))      # pre-norm, ZeRO-1
    save_dir = tmp_path_factory.mktemp("tp_ckpt")
    with ThreadPoolExecutor(2) as pool:
        m2 = pool.submit(run_ranks, tp_steps, 2, tmp_path_factory.mktemp(
            "m2"), 2, work["m2"] + extra, save_dir)
        d2m2 = pool.submit(run_ranks, tp_steps, 4, tmp_path_factory.mktemp(
            "d2m2"), 2, work["d2m2"])
        want = {t: _jax_step(r["jcfg"], r["params"], batch)
                for t, r in refs.items()}
        mesh_want = _jax_mesh_step(refs["pre-norm"]["jcfg"], params, batch)
        sp_want = _jax_step(jcfg, params, sp_batch, key=1)[0]
        sp_mesh = _jax_sp_losses(jcfg, params, sp_batch, key=1)
        m2, d2m2 = m2.result(), d2m2.result()
    # the seed trap's one process at data index 0
    one = tp_steps(0, 1, 1, [extra[2]])[0]
    got = {}
    n = len(work["m2"])
    for i, (mesh, tower, zero1) in enumerate(c for c in CASES
                                             if c[0] == "m2"):
        got[mesh, tower, zero1] = [o[i] for o in m2]
    for i, (mesh, tower, zero1) in enumerate(c for c in CASES
                                             if c[0] == "d2m2"):
        got[mesh, tower, zero1] = [o[i] for o in d2m2]
    return dict(want=want, mesh_want=mesh_want, sp_want=sp_want,
                sp_mesh=sp_mesh, got=got, tcfgs=tcfgs,
                sp=[[o[n], o[n + 1]] for o in m2],
                trap=[o[n + 2] for o in m2], one=one, start=start,
                save_dir=str(save_dir), saved=[o[n + 3] for o in m2])


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
        moved = max(float(np.abs(want[k] - start[k]).max()) for k in want)
        assert moved > 100 * PARAM_TOL["atol"]


@pytest.mark.parametrize("mesh,tower,zero1", CASES,
                         ids=[f"{m}-{t}-{'zero1' if z else 'plain'}"
                              for m, t, z in CASES])
def test_tp_step_matches_jax_single_device(stepped, mesh, tower, zero1):
    s = stepped
    want_losses, want_params, _ = s["want"][tower]
    start = {k: v.numpy() for k, v in params_from_jax(
        s["start"][tower], s["tcfgs"][tower]).items()}
    outs = s["got"][mesh, tower, zero1]
    assert len(outs) == MESHES[mesh][0]
    for o in outs:
        assert o["mesh"] == {"data": MESHES[mesh][0] // 2, "model": 2}
        _check_losses(o["losses"], want_losses, f"{mesh} {tower}")
        _check_params(o["params"], want_params, s["tcfgs"][tower],
                      f"{mesh} {tower}", start)
        # each rank holds its part of the sharded leaves
        assert o["local_numel"] < sum(p.size for p in o["params"].values())
    if zero1 and MESHES[mesh][0] == 4:       # moments split over data too
        assert all(o["moment_numel"] < 0.75 * o["local_numel"]
                   for o in outs)
    if not zero1:
        assert all(o["moment_numel"] == o["local_numel"] for o in outs)
    assert sorted(o["index"] for o in outs) == sorted(
        (r // 2, r % 2) for r in range(MESHES[mesh][0]))


def test_tp_step_matches_jax_dp_tp_mesh(stepped):
    s = stepped
    losses, params = s["mesh_want"]
    for o in s["got"]["d2m2", "pre-norm", True]:
        _check_losses(o["losses"], losses, "dp4xtp2")
        _check_params(o["params"], params, s["tcfgs"]["pre-norm"],
                      "dp4xtp2")


def test_seed_trap_same_draws_on_a_model_group(stepped):
    """Rates above 0 and each data index's own generator: both ranks of
    the model group draw what one process draws, so their losses agree
    with each other and with one process's; the rates bite (the losses
    are not the no-dropout step's)."""
    s = stepped
    a, b = s["trap"]
    for k in a["losses"]:
        assert a["losses"][k] == b["losses"][k], k
        np.testing.assert_allclose(a["losses"][k], s["one"]["losses"][k],
                                   **LOSS_TOL, err_msg=k)
    for name in a["params"]:
        np.testing.assert_allclose(a["params"][name],
                                   s["one"]["params"][name], **PARAM_TOL,
                                   err_msg=name)
    plain = s["want"]["pre-norm"][0]
    assert abs(a["losses"]["loss_cap"] - plain["loss_cap"]) > 1e-3


def test_sequence_parallel_matches_tp_and_jax(stepped):
    s = stepped
    for off, on in s["sp"]:
        for k in s["sp_want"]:
            np.testing.assert_allclose(on["losses"][k], off["losses"][k],
                                       **LOSS_TOL, err_msg=k)
            np.testing.assert_allclose(on["losses"][k], s["sp_want"][k],
                                       **LOSS_TOL, err_msg=k)
        for k in s["sp_mesh"]:            # the task losses, no total
            np.testing.assert_allclose(on["losses"][k], s["sp_mesh"][k],
                                       **LOSS_TOL, err_msg=k)
        for name in on["params"]:
            np.testing.assert_allclose(on["params"][name],
                                       off["params"][name], **PARAM_TOL,
                                       err_msg=name)


def test_checkpoint_at_model_2_is_jax_layout_and_resumes_at_model_1(
        stepped):
    s = stepped
    out = s["save_dir"]
    want_losses, want_params, want_state = s["want"]["pre-norm"]
    # JAX's loader reads the model file; the fused qkv is [q | k | v]
    params, _, step = jckpt.resume_latest(out)
    assert step == 1
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        b = want_params
        for k in path:
            b = b[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_allclose(np.asarray(a), b, **PARAM_TOL,
                                   err_msg=str(path))
    # the port at model 1: the model, then JAX's moments in its optimizer
    tcfg = s["tcfgs"]["pre-norm"]
    model = mico_from_jax(s["start"]["pre-norm"], tcfg, device="cpu")
    assert tckpt.resume_latest(out, model) == 1
    for name, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), s["saved"][0]["params"][
            name])
    opt = build_optimizer(model, OptimConfig(**OC))
    assert tckpt.load_latest_opt_state(out, opt, step=1)
    assert opt.count == 1
    leaves = tckpt.jax_optimizer_leaves(opt)
    jleaves = jax.tree.leaves(want_state)
    assert len(leaves) == len(jleaves)
    names = dict(zip(opt.names, opt.params))
    for (kind, rows), leaf in zip(leaves, jleaves):
        if kind not in ("mu", "nu"):
            continue
        field = "exp_avg" if kind == "mu" else "exp_avg_sq"
        rows = [(rows, np.asarray(leaf))] if isinstance(rows, str) else zip(
            rows, np.asarray(leaf))
        for name, a in rows:
            got = opt.torch_optimizer.state[names[name]][field].numpy()
            np.testing.assert_allclose(got, a, rtol=2e-4, atol=1e-9,
                                       err_msg=f"{kind} {name}")


def test_run_cli_at_model_parallel_2(corpus, tmp_path):  # noqa: F811
    """Two CPU processes at `run_cfg.model_parallel=2` (one data index):
    one training step, the evaluation and a save; rank 0 writes the
    record and the files, and the step's losses are finite."""
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
         "run_cfg.model_parallel=2", "run_cfg.num_train_steps=1"],
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
    with open(os.path.join(out, "log", "record.json")) as f:
        rec = json.load(f)
    assert rec["mesh"] == {"data": 1, "model": 2} and rec["world"] == 1
    assert [s["step"] for s in rec["steps"]] == [1]
    assert all(np.isfinite(v) for v in rec["steps"][0]["losses"].values())
    assert [e["step"] for e in rec["evals"]] == [1]
    assert "model_step_1.npz" in os.listdir(os.path.join(out, "ckpt"))
