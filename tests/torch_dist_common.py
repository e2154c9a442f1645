"""Multi-process set-up of the port's data-parallel CPU tests: gloo ranks
spawned once per test module, joined through a `FileStore` file under the
test's temporary directory (no port, so pytest-xdist workers cannot
collide), and the functions those ranks run. This module imports torch and
the port only: the spawned ranks never import JAX.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import traceback
from datetime import timedelta

import numpy as np

RANK_TIMEOUT_S = 240


def _rank_main(fn, rank, world, store, out, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=RANK_TIMEOUT_S))
        out.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # noqa: BLE001 — reported by the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_dir, *args) -> list:
    """fn(rank, world, *args) on `world` spawned gloo ranks; → their
    results in rank order. A rank that raises fails the call with its
    traceback."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(str(tmp_dir), "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, ok, value = out.get(timeout=RANK_TIMEOUT_S)
            (results.__setitem__(rank, value) if ok
             else errors.append(f"rank {rank}:\n{value}"))
            if errors:
                break
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(world)) - set(results))} "
                      f"gave no result in {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else RANK_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(world)]


def rows(x: np.ndarray, rank: int, world: int) -> np.ndarray:
    """This rank's rows of a global batch."""
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


# ---------------------------------------------------------------------------
# the ranks' work
# ---------------------------------------------------------------------------


def collective_checks(rank: int, world: int, x: np.ndarray, w: np.ndarray,
                      variable: list, wv: np.ndarray) -> dict:
    """Each collective of `mico_tpu_torch.parallel` on this rank's rows of
    x, with the gradient of sum(gathered * w[rank]) through the gather;
    `gather_variable_batch` once for each entry of `variable` (the ranks'
    row counts: rank r takes x's next sizes[r] rows), with the gradient of
    sum(gathered * wv[rank])."""
    import torch
    import torch.distributed as dist

    from mico_tpu_torch.parallel import collectives as c
    from mico_tpu_torch.parallel import mesh as m

    g = dist.group.WORLD
    out = {"index": c.data_axis_index(g), "size": c.data_axis_size(g),
           "none": (c.data_axis_index(None), c.data_axis_size(None))}
    xr = torch.from_numpy(rows(x, rank, world).copy()).requires_grad_(True)
    gathered = c.all_gather_concat(xr, g)
    (gathered * torch.from_numpy(w[rank])).sum().backward()
    out["gather"] = gathered.detach().numpy()
    out["gather_grad"] = xr.grad.numpy()
    no_grad = c.all_gather_no_grad(xr, g)
    out["no_grad"] = (no_grad.numpy(), no_grad.requires_grad)
    out["reduce_scatter"] = c.reduce_scatter_tensor(
        torch.from_numpy(x * (rank + 1)), g).numpy()
    out["all_reduce"] = c.all_reduce_sum(torch.from_numpy(x[rank]), g).numpy()
    out["variable"] = []
    for sizes in variable:
        b, start = sizes[rank], sum(sizes[:rank])
        xv = torch.from_numpy(x[start:start + b].copy()).requires_grad_(True)
        gv, valid = c.gather_variable_batch(xv, g, max(sizes))
        (gv * torch.from_numpy(wv[rank][:world * max(sizes)])).sum().backward()
        out["variable"].append((gv.detach().numpy(), valid.numpy(),
                                xv.grad.numpy()))
    out["objects"] = c.gather_objects({"rank": rank,
                                       "arr": np.arange(rank + 2)})
    out["broadcast"] = c.broadcast_object(
        {"from": rank, "payload": list(range(3 * (rank + 1)))})
    out["allgather"] = c.process_allgather(np.array([rank, 2 * rank]))
    mesh = m.create_mesh()
    out["mesh"] = (mesh.shape, mesh.rank, mesh.group is g)
    # the model axis over every rank: a data group of one rank each, the
    # model group of all
    tp = m.create_mesh(model=world)
    out["model_parallel"] = (tp.shape, tp.rank, tp.model_index,
                             c.data_axis_size(tp.group),
                             c.data_axis_size(tp.model_group))
    m.create_mesh()               # the run's layout back to model 1
    return out


def dp_steps(rank: int, world: int, cases: list) -> list:
    """Each case's updates on this rank: the port model from the case's
    JAX params, `build_optimizer(group=, zero1=)` and `make_train_step`
    over the world, this rank's rows of each global batch and the global
    draws. → per case the global losses of every call, the parameters
    after the last, and the moments' element counts."""
    import torch
    import torch.distributed as dist

    from mico_tpu_torch.convert import mico_from_jax
    from mico_tpu_torch.parallel.mesh import create_mesh
    from mico_tpu_torch.train.objectives import Draws
    from mico_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mico_tpu_torch.train.train_step import make_train_step

    mesh = create_mesh()
    results = []
    for case in cases:
        model = mico_from_jax(case["params"], case["tcfg"], device="cpu")
        opt = build_optimizer(model, OptimConfig(**case["oc"]),
                              accum_steps=case["accum"], group=mesh.group,
                              zero1=case["zero1"])
        step = make_train_step(case["tcfg"], opt, case["task"], mesh=mesh,
                               zero1=case["zero1"])
        losses = []
        for i, (batch, masks, negatives) in enumerate(case["calls"]):
            local = {k: torch.from_numpy(rows(v, rank, world).copy())
                     for k, v in batch.items()}
            local = {k: v if v.is_floating_point() else v.long()
                     for k, v in local.items()}
            draws = Draws(
                masks=[tuple(torch.from_numpy(a) for a in p) for p in masks],
                negatives=[tuple(torch.from_numpy(a) for a in p)
                           for p in negatives])
            got = step(model, local, torch.Generator().manual_seed(
                100 * rank + i), draws=draws)
            assert not draws.masks and not draws.negatives
            losses.append({k: v.item() for k, v in got.items()})
        state = opt.torch_optimizer.state
        moments = sum(state[o]["exp_avg"].numel() for o in opt.owned)
        results.append(dict(
            losses=losses,
            params={k: v.detach().numpy().copy()
                    for k, v in model.named_parameters()},
            moment_numel=moments,
            param_numel=sum(p.numel() for p in opt.params),
            split=sum(d is not None for d in opt.split_dims),
            leaves=len(opt.split_dims),
            world=dist.get_world_size()))
    return results


def tp_steps(rank: int, world: int, model: int, cases: list,
             save_dir=None) -> list:
    """Each case's update on a data × `model` mesh of the world: the port
    model from the case's JAX params, sharded over the model group as it
    is placed (`mico_from_jax(mesh=)`), the optimizer over the data group
    (ZeRO-1 by the case), this data index's rows of the global batch and
    draws (the injected JAX draws, or with `seed` the rank's generator
    seeded by its data index). → per case the global losses, the whole
    parameters (gathered over the model group), the moments' element
    count and the parameters' on this rank. With `save_dir` the last
    case's model and optimizer are saved there after its step."""
    import torch

    from mico_tpu_torch.convert import mico_from_jax
    from mico_tpu_torch.parallel.mesh import create_mesh
    from mico_tpu_torch.parallel.tensor_parallel import whole_state_dict
    from mico_tpu_torch.train.checkpoints import ModelSaver
    from mico_tpu_torch.train.objectives import Draws
    from mico_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mico_tpu_torch.train.train_step import make_train_step

    mesh = create_mesh(data=world // model, model=model)
    d = mesh.rank
    results = []
    for case in cases:
        net = mico_from_jax(case["params"], case["tcfg"], device="cpu",
                            mesh=mesh)
        opt = build_optimizer(net, OptimConfig(**case["oc"]),
                              group=mesh.group, zero1=case["zero1"])
        step = make_train_step(case["tcfg"], opt, case["task"], mesh=mesh,
                               zero1=case["zero1"])
        batch, masks, negatives = case["call"]
        n = mesh.shape["data"]
        local = {k: torch.from_numpy(rows(v, d, n).copy())
                 for k, v in batch.items()}
        local = {k: v if v.is_floating_point() else v.long()
                 for k, v in local.items()}
        draws = None if case.get("seed") is not None else Draws(
            masks=[tuple(torch.from_numpy(a) for a in p) for p in masks],
            negatives=[tuple(torch.from_numpy(a) for a in p)
                       for p in negatives])
        gen = torch.Generator().manual_seed(
            (case.get("seed") or 0) + d)
        got = step(net, local, gen, draws=draws)
        state = opt.torch_optimizer.state
        results.append(dict(
            losses={k: v.item() for k, v in got.items()},
            params={k: v.numpy().copy()
                    for k, v in whole_state_dict(net).items()},
            moment_numel=sum(state[o]["exp_avg"].numel() for o in opt.owned),
            local_numel=sum(p.numel() for p in net.parameters()),
            mesh=dict(mesh.shape), index=(d, mesh.model_index)))
        if save_dir is not None and case is cases[-1]:
            ModelSaver(str(save_dir)).save(1, net, opt)
    return results


def _whole_params(model) -> dict:
    """{name: numpy} of a pipeline-staged model as a whole one: another
    stage's block leaves broadcast from their owner, this rank's own
    tensors for the rest (collective over the model group)."""
    from mico_tpu_torch.parallel import pipeline_parallel as pp

    named = {k: v.detach() for k, v in model.named_parameters()}
    twins = pp.remote_names(model)
    return {k: pp.fetch(model, k, named, twins).numpy().copy()
            for k in pp.whole_entries(model, named)}


def _opt_leaves(opt) -> list:
    """The optimizer file's leaves (JAX's positional layout) as numpy
    arrays, gathered as a save gathers them (collective)."""
    from mico_tpu_torch.train.checkpoints import optimizer_leaves

    return [np.stack([r.float().numpy() for r in rows]) if stacked
            else rows[0].numpy() for _, rows, stacked in
            optimizer_leaves(opt)]


def pp_steps(rank: int, world: int, stages: int, cases: list,
             save_dir=None) -> list:
    """Each case on a data × `stages` mesh of the world, its config at
    `pipeline_stages=stages`: the port model from the case's JAX params,
    this stage's EVA blocks alone (`mico_from_jax(mesh=)`), the optimizer
    over the data group (ZeRO-1 by the case), this data index's rows of
    the global batch and draws (the injected JAX draws, or with `seed` the
    rank's generator seeded by its data index). → per case the global
    losses, the parameters as a whole model (another stage's blocks
    broadcast, this rank's copy of every replicated leaf), the moments'
    and the parameters' element counts on this rank; with `eval` the
    condition and contra features of that batch on the tower gathered
    whole (`whole_tower`) before the step; with `save` the model and optimizer saved to
    `save_dir` after the step. A `resume` case ("pp" at these stages, or
    "tp": tensor parallelism at model `stages`) loads `save_dir` instead
    and returns the parameters and the optimizer file's leaves. An
    `accum` case takes two micro-steps of a 2-step accumulation window on
    `batches` (the ranks' generators seeded by step and data index),
    straight and with a save and a resume between them (under
    `save_dir`/accum), → the parameters of both."""
    import torch

    from mico_tpu_torch.convert import mico_from_jax
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.parallel.mesh import create_mesh
    from mico_tpu_torch.parallel.pipeline_parallel import whole_tower
    from mico_tpu_torch.parallel.tensor_parallel import whole_state_dict
    from mico_tpu_torch.train import checkpoints as ckpt
    from mico_tpu_torch.train.objectives import Draws, compute_features
    from mico_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mico_tpu_torch.train.train_step import make_train_step

    mesh = create_mesh(data=world // stages, model=stages)
    d = mesh.rank
    results = []
    def local_rows(batch):
        n = mesh.shape["data"]
        out = {k: torch.from_numpy(rows(v, d, n).copy())
               for k, v in batch.items()}
        return {k: v if v.is_floating_point() else v.long()
                for k, v in out.items()}

    for case in cases:
        oc = OptimConfig(**case["oc"])
        if case.get("accum"):
            out_dir = os.path.join(str(save_dir), "accum")
            got = {}
            for how in ("straight", "resumed"):
                net = mico_from_jax(case["params"], case["tcfg"],
                                    device="cpu", mesh=mesh)
                for i, batch in enumerate(case["batches"]):
                    if how == "resumed" and i == 1:
                        ckpt.ModelSaver(out_dir).save(1, net, opt)
                        net = MiCo(case["tcfg"], device="cpu",
                                   init_weights=False,
                                   mesh=mesh).to_empty(device="cpu")
                        assert ckpt.resume_latest(out_dir, net) == 1
                    if i == 0 or how == "resumed":
                        opt = build_optimizer(net, oc, accum_steps=2,
                                              group=mesh.group)
                        step = make_train_step(case["tcfg"], opt,
                                               case["task"], mesh=mesh)
                    if how == "resumed" and i == 1:
                        assert ckpt.load_latest_opt_state(out_dir, opt,
                                                          step=1)
                        assert opt.mini_step == 1
                    step(net, local_rows(batch),
                         torch.Generator().manual_seed(10 + i + 100 * d))
                assert opt.count == 1 and opt.mini_step == 0
                got[how] = _whole_params(net)
            results.append(got)
            continue
        if case.get("resume"):
            net = MiCo(case["tcfg"], device="cpu", init_weights=False,
                       mesh=mesh).to_empty(device="cpu")
            step = ckpt.resume_latest(str(save_dir), net)
            opt = build_optimizer(net, oc, group=mesh.group)
            assert ckpt.load_latest_opt_state(str(save_dir), opt, step=step)
            params = (_whole_params(net) if case["resume"] == "pp" else
                      {k: v.numpy().copy()
                       for k, v in whole_state_dict(net).items()})
            results.append(dict(step=step, count=opt.count, params=params,
                                leaves=_opt_leaves(opt)))
            continue
        net = mico_from_jax(case["params"], case["tcfg"], device="cpu",
                            mesh=mesh)
        opt = build_optimizer(net, oc, group=mesh.group,
                              zero1=case["zero1"])
        step = make_train_step(case["tcfg"], opt, case["task"], mesh=mesh,
                               zero1=case["zero1"])
        batch, masks, negatives = case["call"]
        local = local_rows(batch)
        draws = None if case.get("seed") is not None else Draws(
            masks=[tuple(torch.from_numpy(a) for a in p) for p in masks],
            negatives=[tuple(torch.from_numpy(a) for a in p)
                       for p in negatives])
        gen = torch.Generator().manual_seed((case.get("seed") or 0) + d)
        out = {}
        if case.get("eval") is not None:
            ev = {k: torch.from_numpy(v) for k, v in case["eval"].items()}
            with whole_tower(net), torch.no_grad():
                feats = compute_features(net, net.cfg, ev, "va")
            out["eval"] = {k: v.numpy().copy() for k, v in feats.items()}
            out["numel_after_eval"] = sum(p.numel() for p in net.parameters())
        got = step(net, local, gen, draws=draws)
        state = opt.torch_optimizer.state
        out.update(
            losses={k: v.item() for k, v in got.items()},
            params=_whole_params(net),
            moment_numel=sum(state[o]["exp_avg"].numel() for o in opt.owned),
            local_numel=sum(p.numel() for p in net.parameters()),
            mesh=dict(mesh.shape), index=(d, mesh.model_index))
        if case.get("save"):
            ckpt.ModelSaver(str(save_dir)).save(1, net, opt)
        results.append(out)
    return results


def pp_schedule_checks(rank: int, world: int, toy: dict, meshes: list,
                       towers: list) -> dict:
    """The GPipe schedule on this rank. `toy`: JAX's toy layer stack
    (tanh(h @ w + b) over w (L, D, D), b (L, D), x (B, D)) at each (S, M)
    of `meshes`, on a data × S mesh of the world (every model group runs
    the whole batch) → the output, this stage's layers' gradients and x's
    of sum(out²). `towers`: each an EVA tower at `pipeline_stages=2` on a
    data 2 × stages 2 mesh (`mico_from_jax(mesh=)`, this data index's rows
    of `pixels`): `eva_vit_forward`'s tokens, and after the backward of
    sum(tokens · w) and the optimizer's `sync_grads` (the data group's
    mean, the model group's sums), the vision tower's gradients on this
    rank."""
    import torch

    from mico_tpu_torch.convert import mico_from_jax
    from mico_tpu_torch.models.eva_vit import eva_vit_forward
    from mico_tpu_torch.parallel.mesh import create_mesh
    from mico_tpu_torch.parallel.partition import stage_range
    from mico_tpu_torch.parallel.pipeline_parallel import pipelined
    from mico_tpu_torch.train.optim import OptimConfig, build_optimizer

    out = {"toy": [], "towers": []}
    for stages, n_micro in meshes:
        mesh = create_mesh(data=world // stages, model=stages)
        axis = mesh.stage_axis
        a, b = stage_range(toy["w"].shape[0], stages, axis.index)
        ws = [torch.tensor(toy["w"][i], requires_grad=True)
              for i in range(a, b)]
        bs = [torch.tensor(toy["b"][i], requires_grad=True)
              for i in range(a, b)]
        x = torch.tensor(toy["x"], requires_grad=True)

        def layer_fn(layers, h):
            for w, bias in layers:
                h = torch.tanh(h @ w + bias)
            return h

        y = pipelined(layer_fn, axis, n_micro)(list(zip(ws, bs)), x)
        y.square().sum().backward()
        out["toy"].append(dict(
            out=y.detach().numpy(), layers=(a, b),
            w=np.stack([w.grad.numpy() for w in ws]),
            b=np.stack([v.grad.numpy() for v in bs]), x=x.grad.numpy()))
    mesh = create_mesh(data=world // 2, model=2)
    d, n = mesh.rank, mesh.shape["data"]
    for case in towers:
        net = mico_from_jax(case["params"], case["tcfg"], device="cpu",
                            mesh=mesh)
        opt = build_optimizer(net, OptimConfig(), group=mesh.group)
        px = torch.from_numpy(rows(case["pixels"], d, n).copy())
        tokens = eva_vit_forward(net.vision_encoder, px, attn_impl="flash",
                                 pipeline_stages=2,
                                 pipeline_microbatches=case.get("n_micro"))
        (tokens * torch.from_numpy(rows(case["w"], d, n))).sum().backward()
        opt.sync_grads()
        out["towers"].append(dict(
            tokens=tokens.detach().numpy(),
            grads={k: p.grad.numpy().copy()
                   for k, p in net.named_parameters()
                   if k.startswith("vision_encoder.")}))
    return out


def zero1_orbax_resume(rank: int, world: int, out: str, tcfg, oc: dict
                       ) -> dict:
    """A ZeRO-1 resume of the `.orbax` checkpoint under `out` on this rank
    (the model whole, the moments sliced over the world). → the moments it
    holds by parameter name, each parameter's split dimension, the update
    count, and the chunk keys its optimizer read decoded."""
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.parallel.mesh import create_mesh
    from mico_tpu_torch.train import checkpoints, orbax_format
    from mico_tpu_torch.train.optim import OptimConfig, build_optimizer

    opened = []

    class Counted(orbax_format.Checkpoint):
        def __init__(self, path):
            super().__init__(path)
            opened.append(self)

    orbax_format.Checkpoint = Counted
    mesh = create_mesh()
    model = MiCo(tcfg, device="cpu", init_weights=False).to_empty(
        device="cpu")
    step = checkpoints.resume_latest(out, model)
    opt = build_optimizer(model, OptimConfig(**oc), group=mesh.group,
                          zero1=True)
    assert checkpoints.load_latest_opt_state(out, opt, step=step)
    state = opt.torch_optimizer.state
    decoded = [k for c in opened if "optimizer_step" in c.path
               for k in c.decoded]
    return dict(
        moments={n: (state[o]["exp_avg"].numpy().copy(),
                     state[o]["exp_avg_sq"].numpy().copy())
                 for n, o in zip(opt.names, opt.owned) if o in state},
        split_dims=dict(zip(opt.names, opt.split_dims)), count=opt.count,
        decoded=decoded)
