"""The port's collectives on a 2-process gloo world, held against the JAX
package's collectives under shard_map on 2 devices of the CPU mesh.

Same per-rank inputs (numpy, seeded) on both sides.  Each rank's loss is
``sum(op(x_r) * w_r)``; values and the gradients the reference's autodiff
rules give must agree to 1e-6 (fp32; the sums run in another order).
bf16 tensors in the fused reduce agree to one bf16 rounding, 1e-2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import _torch_world
from horovod_tpu.ops import collectives as jc
from horovod_tpu.ops.collectives import shard_map_compat

TOL = 1e-6
N = 7
WORLD = 2


def _inputs():
    rng = np.random.RandomState(0)
    xs = rng.randn(WORLD, N).astype(np.float32)
    ws = rng.randn(WORLD, N).astype(np.float32)
    bf = rng.randn(WORLD, 4).astype(np.float32)
    return xs, ws, bf


@pytest.fixture(scope="module")
def port():
    xs, ws, bf = _inputs()
    return _torch_world.run_world(_torch_world.collectives_worker,
                                  (xs, ws, bf), world=WORLD)


def _jax_case(op_fn):
    """Per-rank (values, grads) of ``op_fn`` under shard_map on WORLD
    devices with the same inputs."""
    xs, ws, _ = _inputs()
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("hvd",))

    def local(x, w):
        y = op_fn(x[0])
        return y[None], (y * w[0]).sum()[None]

    f = shard_map_compat(local, mesh=mesh, in_specs=(P("hvd"), P("hvd")),
                         out_specs=(P("hvd"), P("hvd")))
    vals = f(jnp.asarray(xs), jnp.asarray(ws))[0]
    grads = jax.grad(lambda x: f(x, jnp.asarray(ws))[1].sum())(
        jnp.asarray(xs))
    return np.asarray(vals), np.asarray(grads)


@pytest.mark.parametrize("case,op,pre,post", [
    ("avg", jc.Average, 1.0, 1.0),
    ("sum", jc.Sum, 1.0, 1.0),
    ("avg_scaled", jc.Average, 0.5, 3.0),
    ("sum_scaled", jc.Sum, 2.0, 0.25),
])
def test_allreduce_values_and_grads(port, case, op, pre, post):
    vals, grads = _jax_case(lambda x: jc.allreduce(
        x, op, prescale_factor=pre, postscale_factor=post))
    for r in range(WORLD):
        np.testing.assert_allclose(port[r][case][0], vals[r], atol=TOL,
                                   rtol=TOL, err_msg=f"{case} rank {r}")
        np.testing.assert_allclose(port[r][case][1], grads[r], atol=TOL,
                                   rtol=TOL, err_msg=f"{case} grad {r}")


def test_broadcast_values_and_grads(port):
    vals, grads = _jax_case(lambda x: jc.broadcast(x, 1))
    for r in range(WORLD):
        np.testing.assert_allclose(port[r]["broadcast"][0], vals[r],
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(port[r]["broadcast"][1], grads[r],
                                   atol=TOL, rtol=TOL)
    # the rule itself: the root gets the summed cotangent, others zero
    _, ws, _ = _inputs()
    np.testing.assert_allclose(port[1]["broadcast"][1], ws.sum(0), atol=TOL)
    assert not port[0]["broadcast"][1].any()


def test_grouped_allreduce_values_and_grads(port):
    xs, ws, bf = _inputs()
    for r in range(WORLD):
        vals, grads = port[r]["grouped"]
        np.testing.assert_allclose(vals[0], xs[:, :3].mean(0), atol=TOL)
        np.testing.assert_allclose(vals[1].reshape(-1), xs[:, 3:].mean(0),
                                   atol=TOL)
        np.testing.assert_allclose(vals[2], bf.mean(0), atol=1e-2)
        assert vals[1].shape == (1, N - 3)
        # allreduce-average's grad is the average of the cotangents
        np.testing.assert_allclose(grads[0], ws[:, :3].mean(0), atol=TOL)
        np.testing.assert_allclose(grads[1].reshape(-1), ws[:, 3:].mean(0),
                                   atol=TOL)
    # the JAX grouped reduce on the same per-rank lists agrees
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("hvd",))
    f = shard_map_compat(
        lambda a, b: [o[None] for o in jc.grouped_allreduce(
            [a[0, :3], a[0, 3:], b[0]], jc.Average)],
        mesh=mesh, in_specs=(P("hvd"), P("hvd")),
        out_specs=[P("hvd")] * 3)
    want = f(jnp.asarray(xs), jnp.asarray(bf, jnp.bfloat16))
    for r in range(WORLD):
        got = port[r]["grouped"][0]
        np.testing.assert_allclose(got[0], np.asarray(want[0][r]), atol=TOL)
        np.testing.assert_allclose(got[1].reshape(-1),
                                   np.asarray(want[1][r]), atol=TOL)
        np.testing.assert_allclose(got[2], np.asarray(want[2][r],
                                                      np.float32),
                                   atol=1e-2)


def test_rank_arithmetic(port):
    for r, res in enumerate(port):
        assert (res["rank"], res["size"]) == (r, WORLD)
        assert (res["local_rank"], res["local_size"]) == (r, WORLD)
        assert (res["cross_rank"], res["cross_size"]) == (0, 1)
        assert res["homogeneous"] is True
