"""`.orbax` checkpoints in the port (`train/ocdbt.py`, `train/orbax_format.py`,
`train/checkpoints.py`) against the JAX package's orbax backend, at the
tiny config, on the CPU:

  - the committed fixtures (`scripts/make_orbax_fixtures.py`: one process
    with a leaf over a 4-device mesh, and two processes' merged database)
    read bit for bit against their numpy recipe;
  - what JAX's `ModelSaver(backend="orbax")` writes (model, optimizer and
    best, leaves sharded over 4 devices) is read bit for bit: the tree,
    and the model and optimizer resumed equal to the npz route's;
  - what the port's `ModelSaver(backend="orbax")` writes is read by JAX's
    `load_checkpoint_path`, `load_latest_opt_state` and
    `resume_latest_sharded` (onto a 4-device mesh) bit for bit, with
    JAX's own `.zarray` dtypes and `_METADATA` trees;
  - `mico_tpu_torch.run` resumed from a JAX-written `.orbax` gives the
    losses, to the bit, of the same run resumed from the npz;
  - under ZeRO-1 over two gloo ranks each rank's moments equal the
    one-process resume's slices, and each rank decodes only the chunks
    under its slice.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import mico_tpu_torch.run as trun
from mico_tpu.train import checkpoints as jax_ckpt
from mico_tpu_torch import convert
from mico_tpu_torch.models.mico import MiCo
from mico_tpu_torch.train import checkpoints, optim as toptim, orbax_format

import torch_orbax_recipe as recipe
from test_torch_checkpoints import OPT, _jax_run
from test_torch_run import ROOT, corpus  # noqa: F401
from torch_dist_common import run_ranks, zero1_orbax_resume
from torch_port_common import configs, perturbed_params

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "orbax")
STEP = 3


def host(t: torch.Tensor) -> np.ndarray:
    """A tensor's numpy bits (bf16 as uint16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def flat(tree, prefix=()):
    """{key path: leaf} of nested dicts and lists."""
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree)
             if isinstance(tree, list) else None)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, prefix + (k,)))
    return out


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_fixture_reads_bitwise(kind):
    ckpt = os.path.join(FIXTURES, kind, "ckpt")
    tree = checkpoints.load_checkpoint_path(
        os.path.join(ckpt, f"model_step_{STEP}.orbax"))
    got = flat(tree)
    want = {keys: (dtype, arr) for keys, dtype, arr in
            recipe.model_leaves(kind)}
    assert set(got) == set(want)
    for keys, (dtype, arr) in want.items():
        t = got[keys]
        assert t.dtype == orbax_format.DTYPES[dtype][1], keys
        assert np.array_equal(host(t), arr), keys
    if kind == "single":
        assert isinstance(tree["blocks"], list)
        opt = checkpoints.load_checkpoint_path(
            os.path.join(ckpt, f"optimizer_step_{STEP}.orbax"))
        for (k,), dtype, arr in recipe.optimizer_leaves(kind):
            assert np.array_equal(host(opt[k]), arr), k
        c = orbax_format.Checkpoint(os.path.join(
            ckpt, f"model_step_{STEP}.orbax"))
        assert c.array(".".join(recipe.SHARDED)).grid() == (4, 1)
    else:                       # the merged database of two processes
        root = os.path.join(ckpt, f"model_step_{STEP}.orbax")
        assert {"ocdbt.process_0", "ocdbt.process_1"} <= set(os.listdir(root))


@pytest.fixture(scope="module")
def jax_state():
    """JAX's parameters and optax state after 3 updates (the tiny config),
    and the port's model and optimizer holding them (from JAX's npz)."""
    jcfg, tcfg = configs()
    params = perturbed_params(jcfg, seed=5)
    p, state, _, _ = _jax_run(params, 1, STEP)
    return jcfg, tcfg, p, state


def sharded(tree, n=4):
    """Leaves whose first dimension divides by n, split over n devices."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("d",))

    def put(x):
        spec = (PartitionSpec("d") if x.ndim and x.shape[0] % n == 0
                else PartitionSpec())
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, tree), mesh


def port_resumed(out, tcfg):
    model = MiCo(tcfg, device="cpu", init_weights=False).to_empty(
        device="cpu")
    step = checkpoints.resume_latest(out, model)
    opt = toptim.build_optimizer(model, toptim.OptimConfig(**OPT))
    assert checkpoints.load_latest_opt_state(out, opt, step=step)
    return step, model, opt


def test_port_reads_what_jax_writes(jax_state, tmp_path):
    """JAX's orbax model, optimizer and best files (leaves over a 4-device
    mesh): the tree bit for bit, and the resumed model and optimizer equal
    to those resumed from JAX's npz of the same state."""
    _, tcfg, p, state = jax_state
    ps, _ = sharded(p)
    orb, npz = str(tmp_path / "orbax"), str(tmp_path / "npz")
    saver = jax_ckpt.ModelSaver(orb, backend="orbax")
    saver.save(STEP, ps, sharded(state)[0])
    saver.save_best("r1", ps)
    saver.wait()
    jax_ckpt.ModelSaver(npz).save(STEP, p, state)
    for name in (f"model_step_{STEP}", "best_r1"):
        got = flat(checkpoints.load_checkpoint_path(
            os.path.join(orb, "ckpt", f"{name}.orbax")))
        want = {tuple(k.key if hasattr(k, "key") else k.idx for k in path):
                np.asarray(v) for path, v in
                jax.tree_util.tree_flatten_with_path(p)[0]}
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(host(got[k]), want[k]), k
    a, b = port_resumed(orb, tcfg), port_resumed(npz, tcfg)
    assert a[0] == b[0] == STEP and a[2].count == b[2].count == STEP
    for k, v in b[1].state_dict().items():
        assert torch.equal(a[1].state_dict()[k], v), k
    sa, sb = a[2].torch_optimizer.state, b[2].torch_optimizer.state
    for oa, ob in zip(a[2].owned, b[2].owned):
        for f in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[oa][f], sb[ob][f])


def test_jax_reads_what_the_port_writes(jax_state, tmp_path):
    """The port's orbax save of JAX's state is JAX's state again, bit for
    bit, through JAX's three readers, and its `.zarray` dtypes and
    `_METADATA` trees are those of JAX's own save (fp32 and bf16)."""
    _, tcfg, p, state = jax_state
    npz = str(tmp_path / "npz")
    jax_ckpt.ModelSaver(npz).save(STEP, p, state)
    _, model, opt = port_resumed(npz, tcfg)
    out = str(tmp_path / "port")
    saver = checkpoints.ModelSaver(out, backend="orbax")
    saver.save(STEP, model, opt)
    saver.save_best("r1", model)
    ckpt = os.path.join(out, "ckpt")
    assert sorted(os.listdir(ckpt)) == [
        "best_r1.orbax", f"model_step_{STEP}.orbax",
        f"optimizer_step_{STEP}.orbax"]

    def same(got, want):
        g, w = jax.tree.leaves(got), jax.tree.leaves(want)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for x, y in zip(g, w):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            assert np.array_equal(np.asarray(x), np.asarray(y))

    for name in (f"model_step_{STEP}", "best_r1"):
        same(jax_ckpt.load_checkpoint_path(os.path.join(ckpt,
                                                        f"{name}.orbax")), p)
    same(jax_ckpt.load_latest_opt_state(out, state), state)
    ps, mesh = sharded(p)
    ss, _ = sharded(state)
    shard_of = (lambda x: x.sharding)
    got_p, got_s, step = jax_ckpt.resume_latest_sharded(
        out, jax.eval_shape(lambda: p), jax.tree.map(shard_of, ps),
        jax.eval_shape(lambda: state), jax.tree.map(shard_of, ss))
    assert step == STEP
    same(got_p, p)
    same(got_s, state)
    assert jax.tree.leaves(got_p)[0].sharding.mesh.devices.size == 4
    # JAX's own orbax save of the same trees, fp32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        tree = jax.tree.map(lambda x: x.astype(dtype.__str__().split(".")[1])
                            if x.dtype == np.float32 else x, p)
        jdir, pdir = str(tmp_path / f"j{dtype}"), str(tmp_path / f"p{dtype}")
        js = jax_ckpt.ModelSaver(jdir, backend="orbax")
        js.save(STEP, tree, state if dtype == torch.float32 else None)
        js.wait()
        m = convert.mico_from_jax(jax.tree.map(np.asarray, p), tcfg,
                                  device="cpu", dtype=dtype)
        checkpoints.ModelSaver(pdir, backend="orbax").save(
            STEP, m, opt if dtype == torch.float32 else None)
        names = ["model"] + (["optimizer"] if dtype == torch.float32 else [])
        for name in names:
            paths = [os.path.join(d, "ckpt", f"{name}_step_{STEP}.orbax")
                     for d in (jdir, pdir)]
            metas = []
            for path in paths:
                with open(os.path.join(path, "_METADATA")) as f:
                    meta = json.load(f)
                c = orbax_format.Checkpoint(path)
                metas.append((
                    {k: (v["key_metadata"], v["value_metadata"]["value_type"])
                     for k, v in meta["tree_metadata"].items()},
                    {n: c.array(n).dtype for n in c.names()},
                    meta["use_ocdbt"], meta["use_zarr3"]))
            assert metas[0] == metas[1], (name, dtype)


def test_run_resumes_from_jax_orbax_as_from_npz(corpus, tmp_path):  # noqa: F811
    """`mico_tpu_torch.run` trains 2 steps (npz); JAX rewrites that step's
    model and optimizer as `.orbax`; a resume for 2 more steps from each
    directory gives the same losses, to the bit."""
    _, cfg_path = corpus
    first = str(tmp_path / "npz")
    base = ["--config", str(cfg_path), "--device", "cpu",
            "--data_cfg.val", "[]"]
    trun.main(base + ["--output_dir", first])
    orb = str(tmp_path / "orbax")
    shutil.copytree(os.path.join(first, "log"), os.path.join(orb, "log"))
    ckpt = os.path.join(first, "ckpt")
    params = jax_ckpt.load_pytree_npz(os.path.join(ckpt, "model_step_2.npz"))
    with np.load(os.path.join(ckpt, "optimizer_step_2.npz")) as z:
        opt = [z[str(i)] for i in range(len(z.files))]
    saver = jax_ckpt.ModelSaver(orb, backend="orbax")
    saver.save(2, jax.tree.map(jax.numpy.asarray, params),
               [jax.numpy.asarray(x) for x in opt])
    saver.wait()
    losses = []
    for out in (first, orb):
        rec = trun.main(base + ["--output_dir", out, "run_cfg.resume=true",
                                "run_cfg.num_train_steps=4"])
        assert rec["start_step"] == 2
        losses.append([s["losses"] for s in rec["steps"]])
    assert losses[0] == losses[1] and len(losses[0]) == 2
    # the npz save of step 4 removed the `.orbax` steps it resumed from
    assert sorted(os.listdir(os.path.join(orb, "ckpt"))) == \
        ["model_step_4.npz", "optimizer_step_4.npz"]


def test_zero1_ranks_read_only_their_chunks(jax_state, tmp_path,
                                            monkeypatch):
    """Two gloo ranks resume ZeRO-1 from a port `.orbax` cut into small
    chunks: each rank's μ and ν equal its slice of the one-process
    resume's, and the chunks it decoded are exactly those under its
    slice."""
    _, tcfg, p, state = jax_state
    npz = str(tmp_path / "npz")
    jax_ckpt.ModelSaver(npz).save(STEP, p, state)
    _, model, opt = port_resumed(npz, tcfg)
    out = str(tmp_path / "orbax")
    monkeypatch.setattr(orbax_format, "CHUNK_BYTES", 2048)
    checkpoints.ModelSaver(out, backend="orbax").save(STEP, model, opt)
    _, _, one = port_resumed(out, tcfg)
    ranks = run_ranks(zero1_orbax_resume, 2, tmp_path, out, tcfg, OPT)
    path = os.path.join(out, "ckpt", f"optimizer_step_{STEP}.orbax")
    c = orbax_format.Checkpoint(path)
    kinds = checkpoints.jax_optimizer_leaves(one)
    index = {n: i for i, n in enumerate(one.names)}
    all_chunks = set()
    for name in c.names():
        a = c.array(name)
        all_chunks |= {f"{name}/{'.'.join(map(str, ix)) or '0'}"
                       for ix in np.ndindex(*a.grid())}
    state1 = one.torch_optimizer.state
    for r, got in enumerate(ranks):
        assert got["count"] == STEP
        want = set()
        for i, (kind, rows) in enumerate(kinds):
            a = c.array(str(i))
            grid = [range(n) for n in a.grid()]
            if kind in ("mu", "nu"):
                first = rows if isinstance(rows, str) else rows[0]
                d = got["split_dims"][first]
                if d is not None and isinstance(rows, str) and d == 0:
                    n = a.shape[0]
                    sl = torch.arange(n).chunk(2)[r]
                    per = a.chunks[0]
                    grid[0] = range(int(sl[0]) // per, int(sl[-1]) // per + 1)
            want |= {f"{i}/{'.'.join(map(str, ix)) or '0'}"
                     for ix in __import__("itertools").product(*grid)}
        assert set(got["decoded"]) == want, r
        assert len(got["decoded"]) == len(want)         # each once
        for name, (mu, nu) in got["moments"].items():
            j = index[name]
            whole = one.gather(j, state1[one.owned[j]]["exp_avg"])
            d = got["split_dims"][name]
            sl = whole if d is None else whole.chunk(2, d)[r]
            assert np.array_equal(mu, sl.numpy()), name
            whole = one.gather(j, state1[one.owned[j]]["exp_avg_sq"])
            sl = whole if d is None else whole.chunk(2, d)[r]
            assert np.array_equal(nu, sl.numpy()), name
    assert set(ranks[0]["decoded"]) != set(ranks[1]["decoded"])
    assert len(ranks[0]["decoded"]) < len(all_chunks)


@pytest.mark.parametrize("layout", ["tensor_parallel", "pipeline_stage"])
def test_rank_reads_only_its_region(jax_state, tmp_path, monkeypatch,
                                    layout):
    """A model-axis rank loaded from `.orbax` holds the leaves a whole load
    gives it and decodes only the chunks under them: a tensor-parallel
    rank from JAX's save sharded by JAX's model-axis specs over 2 devices
    (a chunk a shard), a pipeline stage from the port's save (a chunk a
    block row) no row of the other stage's blocks."""
    from mico_tpu.parallel.partition import mico_param_specs
    from mico_tpu_torch.parallel import pipeline_parallel as pp
    from mico_tpu_torch.parallel import tensor_parallel as tp

    _, tcfg, p, _ = jax_state
    whole = convert.mico_from_jax(jax.tree.map(np.asarray, p), tcfg,
                                  device="cpu")
    out = str(tmp_path / "out")
    if layout == "tensor_parallel":
        mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
        saver = jax_ckpt.ModelSaver(out, backend="orbax")
        saver.save(STEP, jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), p,
            mico_param_specs(p)))
        saver.wait()
    else:
        checkpoints.ModelSaver(out, backend="orbax").save(STEP, whole)
    path = os.path.join(out, "ckpt", f"model_step_{STEP}.orbax")
    c = orbax_format.Checkpoint(path)
    total = sum(int(np.prod(c.array(n).grid())) for n in c.names())
    opened = []

    class Counted(orbax_format.Checkpoint):
        def __init__(self, path):
            super().__init__(path)
            opened.append(self)

    monkeypatch.setattr(orbax_format, "Checkpoint", Counted)
    decoded = []
    ref = whole.state_dict()
    for r in range(2):
        m = MiCo(tcfg, device="cpu", init_weights=False).to_empty(
            device="cpu")
        if layout == "tensor_parallel":
            tp.shard_module(m, tp.ModelAxis(None, 2, r))
        else:
            pp.stage_module(m, pp.StageAxis(None, 2, r, ranks=(0, 1)))
        with torch.no_grad():
            for v in m.state_dict().values():
                v.fill_(float("nan"))
        assert checkpoints.resume_latest(out, m) == STEP
        for k, v in m.state_dict().items():
            assert torch.equal(v, tp.local_part(m, k, ref[k])), (r, k)
        keys = opened[-1].decoded
        assert len(set(keys)) == len(keys)              # each chunk once
        decoded.append(set(keys))
        if layout == "pipeline_stage":
            assert not any(k.startswith("vision_encoder.blocks.")
                           and k.split("/")[1].split(".")[0] == str(1 - r)
                           for k in keys), r
    assert decoded[0] != decoded[1]
    assert all(len(d) < total for d in decoded)
