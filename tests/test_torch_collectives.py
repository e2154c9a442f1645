"""The port's collectives (`mico_tpu_torch/parallel/`) at 2 gloo ranks on the
CPU against JAX's (`mico_tpu.parallel.collectives`) under `shard_map` over 2
of the conftest's virtual CPU devices: values and gradients of
`all_gather_concat`, `all_gather_no_grad` and `gather_variable_batch`, the
axis index and size; and the host-side object collectives
(`gather_objects`, `broadcast_object`, `process_allgather`), the
reduce-scatter and the all-reduce against their one-process meaning. The
ranks are spawned once (`torch_dist_common.run_ranks`) and run every check.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from mico_tpu.parallel import collectives as jc

from torch_dist_common import collective_checks, run_ranks

WORLD = 2
# the variable batch: equal counts (held to JAX, whose shard_map takes one
# shape a device) and unequal ones (held to pad, concatenate and mask)
VARIABLE = [(2, 2), (1, 2)]


@pytest.fixture(scope="module")
def checked(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2 * WORLD, 3, 5)).astype(np.float32)
    w = rng.standard_normal((WORLD, 2 * WORLD, 3, 5)).astype(np.float32)
    wv = rng.standard_normal((WORLD, 2 * WORLD, 3, 5)).astype(np.float32)
    out = run_ranks(collective_checks, WORLD,
                    tmp_path_factory.mktemp("collectives"), x, w, VARIABLE,
                    wv)
    return x, w, wv, out


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


def _jax_gather(x, w):
    """JAX's all_gather_concat under shard_map: each device's gathered
    rows and the gradient of the devices' summed sum(gathered * w[d])."""

    @partial(shard_map, mesh=_jax_mesh(), in_specs=(P("data"), P("data")),
             out_specs=(P("data"), P("data")), check_vma=False)
    def f(xl, wl):
        g = jc.all_gather_concat(xl, "data")
        return g[None], jnp.sum(g * wl[0])[None]

    gathered, _ = f(x, w)
    grad = jax.grad(lambda a: jnp.sum(f(a, w)[1]))(x)
    return np.asarray(gathered), np.asarray(grad)


def test_axis_index_and_size(checked):
    *_, out = checked
    assert [o["index"] for o in out] == list(range(WORLD))
    assert all(o["size"] == WORLD for o in out)
    assert all(o["none"] == (0, 1) for o in out)     # axis_name=None

    @partial(shard_map, mesh=_jax_mesh(), in_specs=P("data"),
             out_specs=P("data"), check_vma=False)
    def f(x):
        return jnp.stack([jc.data_axis_index("data"),
                          jc.data_axis_size("data")])[None]

    want = np.asarray(f(jnp.zeros((WORLD, 1))))
    np.testing.assert_array_equal(want, [[o["index"], o["size"]] for o in out])


def test_all_gather_concat_values_and_gradient(checked):
    x, w, _, out = checked
    want, want_grad = _jax_gather(x, w)
    for r, o in enumerate(out):
        np.testing.assert_allclose(o["gather"], want[r], rtol=0, atol=0)
        np.testing.assert_allclose(o["gather_grad"],
                                   want_grad[2 * r:2 * r + 2], rtol=1e-6,
                                   atol=1e-6)
    # the backward sums every rank's cotangent of this rank's rows
    np.testing.assert_allclose(out[0]["gather_grad"], w[:, :2].sum(0),
                               rtol=1e-6, atol=1e-6)


def test_all_gather_no_grad(checked):
    x, *_, out = checked

    @partial(shard_map, mesh=_jax_mesh(), in_specs=P("data"),
             out_specs=P("data"), check_vma=False)
    def f(xl):
        return jc.all_gather_no_grad(xl, "data")[None]

    want = np.asarray(f(x))
    grad = jax.grad(lambda a: jnp.sum(f(a)))(x)
    assert not np.asarray(grad).any()                # stop_gradient
    for r, o in enumerate(out):
        values, requires_grad = o["no_grad"]
        np.testing.assert_array_equal(values, want[r])
        assert not requires_grad


def test_gather_variable_batch_matches_jax(checked):
    x, _, wv, out = checked
    sizes = VARIABLE[0]
    n = max(sizes)

    @partial(shard_map, mesh=_jax_mesh(), in_specs=(P("data"), P("data")),
             out_specs=(P("data"), P("data"), P("data")), check_vma=False)
    def f(xl, wl):
        g, v = jc.gather_variable_batch(xl, "data", max_batch=n)
        return g[None], v[None], jnp.sum(g * wl[0, :WORLD * n])[None]

    g, v, _ = f(x, wv)
    grad = jax.grad(lambda a: jnp.sum(f(a, wv)[2]))(x)
    for r, o in enumerate(out):
        got, valid, got_grad = o["variable"][0]
        np.testing.assert_array_equal(got, np.asarray(g)[r])
        np.testing.assert_array_equal(valid, np.asarray(v)[r])
        np.testing.assert_allclose(got_grad, np.asarray(grad)[2 * r:2 * r + 2],
                                   rtol=1e-6, atol=1e-6)


def test_gather_variable_batch_unequal_counts(checked):
    """Unequal counts: each rank's rows padded to the max, concatenated in
    rank order, the mask marking the real rows; a row's gradient is the
    sum over ranks of its slot's weights."""
    x, _, wv, out = checked
    sizes = VARIABLE[1]
    n = max(sizes)
    want = np.zeros((WORLD * n,) + x.shape[1:], np.float32)
    mask = np.zeros(WORLD * n, bool)
    start = 0
    for r, b in enumerate(sizes):
        want[r * n:r * n + b] = x[start:start + b]
        mask[r * n:r * n + b] = True
        start += b
    slot_grad = wv[:, :WORLD * n].sum(0)
    for r, o in enumerate(out):
        got, valid, got_grad = o["variable"][1]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(valid, mask)
        np.testing.assert_allclose(got_grad, slot_grad[r * n:r * n + sizes[r]],
                                   rtol=1e-6, atol=1e-6)


def test_reduce_scatter_and_all_reduce(checked):
    x, *_, out = checked
    total = sum(x * (r + 1) for r in range(WORLD))
    for r, o in enumerate(out):
        np.testing.assert_allclose(o["reduce_scatter"],
                                   total[2 * r:2 * r + 2], rtol=1e-6)
        np.testing.assert_allclose(o["all_reduce"], x[:WORLD].sum(0),
                                   rtol=1e-6)


def test_object_collectives(checked):
    *_, out = checked
    for o in out:
        objs = o["objects"]
        assert [d["rank"] for d in objs] == list(range(WORLD))
        for r, d in enumerate(objs):
            np.testing.assert_array_equal(d["arr"], np.arange(r + 2))
        assert o["broadcast"] == {"from": 0, "payload": [0, 1, 2]}
        np.testing.assert_array_equal(o["allgather"],
                                      [[r, 2 * r] for r in range(WORLD)])
    # one process without a group: the identities JAX's give
    assert jc.gather_objects({"a": 1}) == [{"a": 1}]
    from mico_tpu_torch.parallel import collectives as tc

    assert tc.gather_objects({"a": 1}) == [{"a": 1}]
    assert tc.broadcast_object([3]) == jc.broadcast_object([3]) == [3]
    np.testing.assert_array_equal(tc.process_allgather(np.arange(3)),
                                  jc.process_allgather(np.arange(3)))


def test_mesh_over_the_ranks(checked):
    *_, out = checked
    for r, o in enumerate(out):
        assert o["mesh"] == ({"data": WORLD, "model": 1}, r, True)
        # create_mesh(model=WORLD) builds: one data index, WORLD model ranks
        assert o["model_parallel"] == ({"data": 1, "model": WORLD}, 0, r, 1,
                                       WORLD)
    from mico_tpu_torch.parallel import create_mesh

    assert create_mesh().shape == {"data": 1, "model": 1}
    assert create_mesh().group is None
