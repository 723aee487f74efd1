"""The port's collectives on a 2-process gloo world, held against the JAX
package's collectives under shard_map on 2 devices of the CPU mesh.

Same per-rank inputs (numpy, seeded) on both sides.  Each rank's loss is
``sum(op(x_r) * w_r)``; values and the gradients the reference's autodiff
rules give must agree to 1e-6 (fp32; the sums run in another order).
bf16 tensors in the fused reduce agree to one bf16 rounding, 1e-2.  A
ragged dim 0 (allgather, reducescatter) has no traced JAX form, so those
cases are held to the reference's eager semantics, written out in numpy
here, at the same 1e-6.  ``ErrorFeedbackCompressor`` is held to the JAX
one call for call: wire values and residuals bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_world
from horovod_tpu.ops import collectives as jc
from horovod_tpu.ops import compression as jcomp
from horovod_tpu.ops.collectives import shard_map_compat
from horovod_tpu_torch.ops import compression as tcomp

TOL = 1e-6
N = 7
WORLD = 2
R, C = 4, 3     # rows per rank and columns of the row-wise ops


def _inputs():
    rng = np.random.RandomState(0)
    xs = rng.randn(WORLD, N).astype(np.float32)
    ws = rng.randn(WORLD, N).astype(np.float32)
    bf = rng.randn(WORLD, 4).astype(np.float32)
    return xs, ws, bf


def _rows():
    """Per case of the row-wise ops: (x, loss weights), one per rank."""
    rng = np.random.RandomState(1)
    f = lambda *shape: rng.randn(*shape).astype(np.float32)  # noqa: E731
    return {
        "allgather": (f(WORLD, R, C), f(WORLD, WORLD * R, C)),
        # rank 0 gives 3 rows, rank 1 five
        "allgather_ragged": ([f(3, C), f(5, C)], f(WORLD, 8, C)),
        "alltoall": (f(WORLD, R, C), f(WORLD, R, C)),
        "reducescatter_sum": (f(WORLD, R, C), f(WORLD, R // WORLD, C)),
        "reducescatter_avg": (f(WORLD, R, C), f(WORLD, R // WORLD, C)),
        # 5 rows over 2 ranks: rank 0 keeps 3, rank 1 two
        "reducescatter_ragged": (f(WORLD, 5, C), [f(3, C), f(2, C)]),
        "reduce_scatter_flat_sum": (f(WORLD, 8), f(WORLD, 4)),
        "reduce_scatter_flat_avg": (f(WORLD, 8), f(WORLD, 4)),
        "all_gather_flat": (f(WORLD, 4), f(WORLD, 8)),
        "extreme": f(WORLD, N),
    }


@pytest.fixture(scope="module")
def port():
    xs, ws, bf = _inputs()
    return _torch_world.run_world(_torch_world.collectives_worker,
                                  (xs, ws, bf, _rows()), world=WORLD)


def _jax_case(op_fn, xs=None, ws=None):
    """Per-rank (values, grads) of ``op_fn`` under shard_map on WORLD
    devices with the same inputs (``_inputs()``'s unless given)."""
    if xs is None:
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


@pytest.mark.parametrize("case,op_fn", [
    ("allgather", lambda x: jc.allgather(x)),
    ("alltoall", lambda x: jc.alltoall(x)),
    ("reducescatter_sum", lambda x: jc.reducescatter(x, jc.Sum)),
    ("reducescatter_avg", lambda x: jc.reducescatter(x, jc.Average)),
    ("reduce_scatter_flat_sum", lambda x: jc.reduce_scatter_flat(x)),
    ("reduce_scatter_flat_avg",
     lambda x: jc.reduce_scatter_flat(x, jc.Average)),
    ("all_gather_flat", lambda x: jc.all_gather_flat(x)),
])
def test_row_collectives_values_and_grads(port, case, op_fn):
    xs, ws = _rows()[case]
    vals, grads = _jax_case(op_fn, xs, ws)
    for r in range(WORLD):
        got_val, got_grad = port[r][case]
        assert got_val.shape == vals[r].shape, case
        np.testing.assert_allclose(got_val, vals[r], atol=TOL, rtol=TOL,
                                   err_msg=f"{case} rank {r}")
        np.testing.assert_allclose(got_grad, grads[r], atol=TOL, rtol=TOL,
                                   err_msg=f"{case} grad {r}")


def test_ragged_allgather_follows_the_eager_reference(port):
    """Rows of 3 and 5: every rank gets the 8 rows in rank order; the
    gradient is the gathered cotangent summed over ranks, each rank keeping
    the rows it gave (the reference rule)."""
    xs, ws = _rows()["allgather_ragged"]
    summed = ws.sum(0)
    for r, (lo, hi) in enumerate(((0, 3), (3, 8))):
        val, grad = port[r]["allgather_ragged"]
        np.testing.assert_allclose(val, np.concatenate(xs), atol=TOL)
        np.testing.assert_allclose(grad, summed[lo:hi], atol=TOL)


def test_ragged_reducescatter_follows_the_eager_reference(port):
    """5 rows over 2 ranks: the first ``5 % 2`` ranks keep one row more
    (rows 0-2 and 3-4 of the sum); each input's gradient is every rank's
    cotangent in rank order."""
    xs, ws = _rows()["reducescatter_ragged"]
    total = xs.sum(0)
    for r, (lo, hi) in enumerate(((0, 3), (3, 5))):
        val, grad = port[r]["reducescatter_ragged"]
        np.testing.assert_allclose(val, total[lo:hi], atol=TOL)
        np.testing.assert_allclose(grad, np.concatenate(ws), atol=TOL)


@pytest.mark.parametrize("case,op", [("min", jc.Min), ("max", jc.Max)])
def test_min_max_values_and_no_gradient(port, case, op):
    """Values as ``lax.pmin`` / ``pmax``; neither has a differentiation rule
    on this jax, and the port's backward raises the same way."""
    xs = _rows()["extreme"]
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("hvd",))
    f = shard_map_compat(lambda x: jc.allreduce(x[0], op)[None], mesh=mesh,
                         in_specs=P("hvd"), out_specs=P("hvd"))
    vals = np.asarray(f(jnp.asarray(xs)))
    want = xs.min(0) if op == jc.Min else xs.max(0)
    prim = "pmin" if op == jc.Min else "pmax"
    with pytest.raises(NotImplementedError, match=prim):
        jax.grad(lambda x: f(x).sum())(jnp.asarray(xs))
    for r in range(WORLD):
        got, err = port[r][case]
        np.testing.assert_array_equal(got, vals[r])
        np.testing.assert_array_equal(got, want)
        assert err is not None and f"'{prim}' not implemented" in err


def test_alltoall_refuses_a_dim0_the_world_does_not_divide(port):
    for res in port:
        assert "must divide the axis size" in res["alltoall_odd"]


@pytest.mark.parametrize("inner", ["bf16", "fp16"])
def test_error_feedback_compressor_matches_jax(inner):
    """Three calls on one key, a fourth after a shape change (the residual
    resets), and ``reset()``: wire values and residuals equal the JAX
    compressor's bit for bit; the carried residual makes the sum of the
    decompressed wires track the sum of the inputs."""
    rng = np.random.RandomState(2)
    xs = [rng.randn(6, 5).astype(np.float32) for _ in range(3)]
    xs.append(rng.randn(4).astype(np.float32))
    jef = jcomp.ErrorFeedbackCompressor(
        getattr(jcomp.Compression, inner))
    tef = tcomp.ErrorFeedbackCompressor(
        getattr(tcomp.Compression, inner))
    wires, residual3 = [], None
    for i, x in enumerate(xs):
        jwire, jctx = jef.compress(jnp.asarray(x), key="g")
        twire, tctx = tef.compress(torch.from_numpy(x), key="g")
        np.testing.assert_array_equal(
            twire.float().numpy(), np.asarray(jwire, np.float32))
        np.testing.assert_array_equal(
            tef._residuals["g"].numpy(), np.asarray(jef._residuals["g"]))
        back = tef.decompress(twire, tctx)
        assert back.dtype == torch.float32 and back.shape == x.shape
        wires.append(back.numpy())
        if i == 2:
            residual3 = tef._residuals["g"].numpy()
    # the error is carried, not compounded: over the first three calls
    # what the wires carried plus the last residual is what went in
    np.testing.assert_allclose(sum(wires[:3]) + residual3, sum(xs[:3]),
                               atol=1e-5)
    tef.reset()
    jef.reset()
    assert tef._residuals == {} and jef._residuals == {}
