"""The port's Adasum (``horovod_tpu_torch.ops.adasum``, ``allreduce(op=
Adasum)``, ``DistributedOptimizer(op=Adasum)``) held against the JAX
package's (``horovod_tpu.ops.adasum``) on the same numpy inputs.

Multi-rank cases run in one 4-rank gloo world laid out as 2 hosts of 2
ranks: Adasum over the world, and over each host's pair (the local
group, a 2-rank reduction); JAX runs ``adasum_allreduce`` and ``jax.grad``
of ``sum(adasum(x) * w)`` on the first 4 and 2 devices of the 8-device
mesh.  Values and gradients agree to 1e-5 (fp32 sums in other orders; the
float64 ``_numpy_adasum_rows`` to 1e-5 too).  The gpt-nano AdamW steps
through ``DistributedOptimizer(op=Adasum)`` are held to
``test_torch_optim.py``'s bounds: losses 2e-4; parameters 1e-4, and 1e-6 on
all but 0.1% of the elements.  One exception: the key third of each qkv
bias has an exactly zero gradient (softmax ignores a constant added to
every key), so what reaches AdamW there is rounding noise, which Adasum's
projection does not average away as the mean does, and AdamW moves such an
element by about lr a step in the direction the noise's sign picks: those
elements are held at 2 x STEPS x lr.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_world
import horovod_tpu as jhvd
from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu.ops.adasum import _numpy_adasum_rows as jax_numpy_rows
from horovod_tpu.ops.adasum import adasum_allreduce as jax_adasum
from horovod_tpu.ops.adasum import adasum_combine as jax_combine
from horovod_tpu.ops.collectives import shard_map_compat
from horovod_tpu_torch.models import params_from_jax
from horovod_tpu_torch.ops.adasum import _numpy_adasum_rows, adasum_combine

WORLD = 4
LOCAL = 2
TOL = 1e-5
STEPS = 3
SEQ = 16
LOSS_TOL = 2e-4
PARAM_TOL = 1e-4
CLOSE_TOL, CLOSE_SHARE = 1e-6, 1e-3
LR = 1e-4
NOISE_TOL = 2 * STEPS * LR  # the key bias: see the module docstring
EMB = 128                   # gpt-nano's width: qkv bias = [q | k | v]


@pytest.mark.parametrize("case", ["orthogonal", "identical", "mixed"])
def test_adasum_combine_limits(case):
    """Orthogonal vectors sum, identical ones average, and any pair
    combines as JAX's ``adasum_combine`` does."""
    a, b = {"orthogonal": ([1.0, 0.0], [0.0, 1.0]),
            "identical": ([2.0, 2.0], [2.0, 2.0]),
            "mixed": ([1.0, -2.0, 0.5], [0.3, 1.0, 4.0])}[case]
    ta, tb = torch.tensor(a), torch.tensor(b)
    got = adasum_combine(ta, tb, ta @ tb, ta @ ta, tb @ tb).numpy()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want = np.asarray(jax_combine(ja, jb, ja @ jb, ja @ ja, jb @ jb))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if case == "orthogonal":
        np.testing.assert_allclose(got, [1.0, 1.0], rtol=1e-6)
    if case == "identical":
        np.testing.assert_allclose(got, a, rtol=1e-6)


def test_numpy_rows_copy_matches_the_reference():
    rows = np.random.RandomState(5).randn(6, 7)
    for n in (1, 2, 3, 4, 5, 6):
        np.testing.assert_array_equal(_numpy_adasum_rows(rows[:n]),
                                      jax_numpy_rows(rows[:n]))


def _inputs():
    rng = np.random.RandomState(7)
    xs = rng.randn(WORLD, 3, 5).astype(np.float32)
    ws = rng.randn(WORLD, 3, 5).astype(np.float32)
    # two leaves whose per-leaf and fused Adasum differ: the projection
    # coefficients come from each tensor's own dots
    leaves = (rng.randn(WORLD, 6).astype(np.float32),
              (5.0 * rng.randn(WORLD, 4)).astype(np.float32))
    return xs, ws, leaves


def _jax_adasum(xs, ws, n):
    """JAX on the mesh's first ``n`` devices: per-device values of
    ``adasum_allreduce`` and the gradient of ``sum(adasum(x) * w)``."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), (jhvd.DP_AXIS,))

    def local(x, w):
        def loss(v):
            return jnp.sum(jax_adasum(v[0]) * w[0])

        return jax_adasum(x[0])[None], jax.grad(loss)(x)

    fn = shard_map_compat(local, mesh=mesh,
                          in_specs=(P(jhvd.DP_AXIS), P(jhvd.DP_AXIS)),
                          out_specs=(P(jhvd.DP_AXIS), P(jhvd.DP_AXIS)))
    y, g = jax.jit(fn)(jnp.asarray(xs[:n]), jnp.asarray(ws[:n]))
    return np.asarray(y), np.asarray(g)


def _setup():
    model = jax_gpt("nano", dtype=jnp.float32, flash_block_q=16,
                    flash_block_k=16)
    tokens = np.random.RandomState(0).randint(0, 1024, (8, SEQ + 1))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:2, :-1]))
    return model, tokens, params


@pytest.fixture(scope="module")
def port():
    xs, ws, leaves = _inputs()
    _, tokens, params = _setup()
    init = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    return _torch_world.run_world(
        _torch_world.adasum_worker, (xs, ws, leaves, init, tokens, STEPS),
        world=WORLD, local_size=LOCAL, timeout=240)


@pytest.mark.parametrize("case,n", [("world", 4), ("pair", 2)])
def test_allreduce_adasum_matches_jax(port, case, n):
    """Values and gradients on every rank: the 4-rank world against JAX on
    4 devices, each host's pair against JAX on 2 (the pair of ranks 2, 3
    holds rows 2, 3)."""
    xs, ws, _ = _inputs()
    for r, res in enumerate(port):
        first = 0 if case == "world" else r - r % LOCAL
        y_j, g_j = _jax_adasum(xs[first:first + n], ws[first:first + n], n)
        y, g = res[case]
        np.testing.assert_allclose(y, y_j[r - first], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(g, g_j[r - first], atol=TOL, rtol=TOL)
        want = _numpy_adasum_rows([x.reshape(-1)
                                   for x in xs[first:first + n]])
        np.testing.assert_allclose(y.reshape(-1), want, atol=TOL, rtol=TOL)


def test_ranks_of_a_pair_hold_identical_results(port):
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(port[a]["pair"][0], port[b]["pair"][0])
    for res in port[1:]:
        np.testing.assert_array_equal(res["world"][0], port[0]["world"][0])


def test_bf16_input_is_reduced_in_fp32_and_cast_back(port):
    xs, _, _ = _inputs()
    want = _numpy_adasum_rows([x.reshape(-1) for x in xs])
    for res in port:
        dtype, y = res["bf16"]
        assert dtype == "torch.bfloat16"
        # bf16 inputs and output: 8 bits of mantissa, 2^-8 relative twice
        np.testing.assert_allclose(y.reshape(-1), want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max())


def test_a_world_that_is_not_a_power_of_two_raises(port):
    """A 3-rank world refuses ``allreduce(op=Adasum)``, as the reference
    does (``adasum.py:97-99``); so does a 3-rank group of the 4-rank
    world."""
    res = _torch_world.run_world(_torch_world.adasum_odd_world_worker,
                                 world=3, timeout=240)
    assert all("power-of-2" in e and "got 3" in e for e in res)
    for res in port[:3]:
        assert "power-of-2" in res["three"] and "got 3" in res["three"]


def test_adasum_reduces_each_leaf_alone(port):
    """``grouped_allreduce`` with Adasum equals each leaf reduced alone,
    and differs from the leaves reduced as one fused buffer: fusing them
    would give the whole list one set of coefficients."""
    _, _, leaves = _inputs()
    for res in port:
        for got, alone in zip(res["grouped"], res["alone"]):
            np.testing.assert_array_equal(got, alone)
        fused = res["fused"]
        assert not np.allclose(np.concatenate(res["grouped"]), fused,
                               rtol=1e-3)
        for leaf, got in zip(leaves, res["grouped"]):
            np.testing.assert_allclose(got, _numpy_adasum_rows(list(leaf)),
                                       atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def reference():
    """JAX: STEPS AdamW steps through ``DistributedOptimizer(op=Adasum)``
    on 4 devices, two rows each; (losses, final params by port name)."""
    model, tokens, params = _setup()
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), (jhvd.DP_AXIS,))
    tx = jhvd.DistributedOptimizer(optax.adamw(1e-4), op=jhvd.Adasum)

    def local_step(p, s, toks):
        def loss_fn(p):
            logits = model.apply(p, toks[:, :-1])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, toks[:, 1:]).mean()

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(grads, s, p)
        return (optax.apply_updates(p, updates), s,
                jax.lax.pmean(loss, jhvd.DP_AXIS))

    step = jax.jit(shard_map_compat(
        local_step, mesh=mesh, in_specs=(P(), P(), P(jhvd.DP_AXIS)),
        out_specs=(P(), P(), P())))
    state, losses = tx.init(params), []
    toks = jnp.asarray(tokens, jnp.int32)
    for _ in range(STEPS):
        params, state, loss = step(params, state, toks)
        losses.append(float(loss))
    return losses, params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           params))


def test_distributed_optimizer_adasum_matches_jax(reference, port):
    losses, params = reference
    for res in port:
        got = res["optimizer"]
        np.testing.assert_allclose(got["losses"], losses, atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        assert set(got["params"]) == set(params)
        far = total = 0
        for name, p in got["params"].items():
            want = params[name].numpy()
            atol = np.full(p.shape, PARAM_TOL)
            if name.endswith(".qkv.bias"):
                atol[EMB:2 * EMB] = NOISE_TOL
            assert (np.abs(p - want) <= atol).all(), (
                name, np.abs(p - want).max())
            far += int((np.abs(p - want) > CLOSE_TOL).sum())
            total += p.size
        assert far <= CLOSE_SHARE * total, (far, total)
    for res in port[1:]:
        for name, p in res["optimizer"]["params"].items():
            np.testing.assert_array_equal(p, port[0]["optimizer"]["params"]
                                          [name], err_msg=name)
