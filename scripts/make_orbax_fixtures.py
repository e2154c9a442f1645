"""Write the `.orbax` fixtures of the port's tests and `chip_smoke.py`
through the JAX package's own `ModelSaver(backend="orbax")`.

    python scripts/make_orbax_fixtures.py [--out tests/fixtures/orbax]

It needs JAX, orbax and tensorstore, so it runs where the JAX package runs
(not on the card's machine), and it spawns two processes for the second
fixture. Values come from `tests/torch_orbax_recipe.py` (numpy alone), so
a reader rebuilds them without JAX. It writes:

  - `single/ckpt/model_step_3.orbax` and `optimizer_step_3.orbax`: one
    process, every leaf on one device (one chunk) but the sharded leaf,
    which a 4-device CPU mesh splits into four chunks;
  - `multi/ckpt/model_step_3.orbax`: two processes under
    `jax.distributed` on the CPU, each writing its own shard of the
    sharded leaf (`ocdbt.process_0`, `ocdbt.process_1`, merged at the top).
"""

from __future__ import annotations

import argparse
import os
import shutil
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _recipe():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_orbax_recipe", os.path.join(ROOT, "tests",
                                           "torch_orbax_recipe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_tree(leaves, put):
    """The nested dicts and lists of recipe leaves as JAX arrays, each
    placed by `put(array, sharded)`."""
    import jax.numpy as jnp

    recipe = _recipe()
    tree = {}
    for keys, dtype, arr in leaves:
        if dtype == "bfloat16":
            arr = arr.view(jnp.bfloat16)
        x = put(arr, keys == recipe.SHARDED)
        node = tree
        for k, nxt in zip(keys[:-1], keys[1:]):
            empty = [] if isinstance(nxt, int) else {}
            if isinstance(k, int):
                while len(node) <= k:
                    node.append(empty)
                node = node[k]
            else:
                node = node.setdefault(k, empty)
        if isinstance(keys[-1], int):
            node.append(x)
        else:
            node[keys[-1]] = x
    return tree


def _save(out: str, kind: str, devices) -> None:
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from mico_tpu.train.checkpoints import ModelSaver

    recipe = _recipe()
    mesh = Mesh(np.array(devices), ("d",))

    def put(arr, sharded):
        if not sharded and kind == "single":
            return jax.device_put(arr, devices[0])  # one chunk
        spec = PartitionSpec("d", None) if sharded else PartitionSpec()
        return jax.make_array_from_callback(
            arr.shape, NamedSharding(mesh, spec), lambda idx: arr[idx])

    params = jax_tree(recipe.model_leaves(kind), put)
    opt = [put(x, False) for _, _, x in recipe.optimizer_leaves(kind)]
    saver = ModelSaver(out, backend="orbax")
    saver.save(recipe.MODEL_STEP, params,
               opt_state=opt if kind == "single" else None)
    saver.wait()


def worker(out: str, pid: int, port: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=2, process_id=pid)
    _save(out, "multi", jax.devices())
    jax.distributed.shutdown()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "fixtures",
                                                  "orbax"))
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.worker:
        out, pid, port = args.worker
        worker(out, int(pid), int(port))
        return
    out = os.path.abspath(args.out)
    shutil.rmtree(out, ignore_errors=True)
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_platforms", "cpu")
    _save(os.path.join(out, "single"), "single", jax.devices()[:4])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    procs = [subprocess.Popen([sys.executable, __file__, "--worker",
                               os.path.join(out, "multi"), str(pid),
                               str(port)], env=env) for pid in (0, 1)]
    if any(p.wait(timeout=600) for p in procs):
        raise SystemExit("a fixture process failed")
    total = 0
    for d, _, files in os.walk(out):
        for f in files:
            total += os.path.getsize(os.path.join(d, f))
    print(f"wrote {out}: {total} bytes")


if __name__ == "__main__":
    main()
