"""The port's data-parallel step held against the JAX package's.

JAX: ``DistributedOptimizer(optax.adamw(1e-4))`` under shard_map on the
8-device CPU mesh, one row of a global batch of 8 per device.  Port: a
2-process gloo world, four rows per rank, ``DistributedOptimizer`` around
``torch.optim.AdamW`` with optax's constants.  Averaged gradients make
both the global-batch step, so after 3 steps of gpt-nano (fp32, flash
attention, the same initial weights) the losses agree to 2e-4.  Adam
divides each gradient element by its own running RMS, so an element whose
gradient is at the level of fp32 rounding can move by up to one step's
update (lr = 1e-4) in a direction rounding decides: the parameters agree
to 1e-4 everywhere, and to 1e-6 on all but 0.1% of the elements.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

import _torch_world
import horovod_tpu as jhvd
from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu.ops.collectives import shard_map_compat
from horovod_tpu_torch.models import params_from_jax

STEPS = 3
SEQ = 16
LOSS_TOL = 2e-4
PARAM_TOL = 1e-4
CLOSE_TOL, CLOSE_SHARE = 1e-6, 1e-3


def _setup():
    model = jax_gpt("nano", dtype=jnp.float32, flash_block_q=16,
                    flash_block_k=16)
    tokens = np.random.RandomState(0).randint(0, 1024, (8, SEQ + 1))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:2, :-1]))
    return model, tokens, params


@pytest.fixture(scope="module")
def reference():
    """JAX: STEPS data-parallel AdamW steps; (losses, final params)."""
    model, tokens, params = _setup()
    tx = jhvd.DistributedOptimizer(optax.adamw(1e-4))

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
        local_step, mesh=jhvd.mesh("flat"),
        in_specs=(P(), P(), P(jhvd.DP_AXIS)), out_specs=(P(), P(), P())))
    state, losses = tx.init(params), []
    toks = jnp.asarray(tokens, jnp.int32)
    for _ in range(STEPS):
        params, state, loss = step(params, state, toks)
        losses.append(float(loss))
    return losses, params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           params))


def _port(k_passes):
    _, tokens, params = _setup()
    init = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    return _torch_world.run_world(
        _torch_world.optim_worker, (init, tokens, STEPS, k_passes))


@pytest.fixture(scope="module")
def port():
    return _port(k_passes=1)


def test_losses_match_jax(reference, port):
    for res in port:
        np.testing.assert_allclose(res["losses"], reference[0],
                                   atol=LOSS_TOL, rtol=LOSS_TOL)


def _assert_params_match(got_params, want):
    assert set(got_params) == set(want)
    far = total = 0
    for name, got in got_params.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(got, ref, atol=PARAM_TOL, rtol=0,
                                   err_msg=name)
        far += int((np.abs(got - ref) > CLOSE_TOL).sum())
        total += got.size
    assert far <= CLOSE_SHARE * total, (far, total)


def test_params_match_jax_after_adamw_steps(reference, port):
    for res in port:
        _assert_params_match(res["params"], reference[1])


def test_replicas_stay_identical(port):
    for name, p0 in port[0]["params"].items():
        np.testing.assert_array_equal(p0, port[1]["params"][name],
                                      err_msg=name)


def test_broadcast_parameters_and_optimizer_state(port):
    assert all(res["bcast_ok"] for res in port)
    assert port[0]["state_digest"] == port[1]["state_digest"]


def test_backward_passes_per_step_matches_jax(reference):
    """Two micro-batches of two rows per rank, one reduce and one update:
    the same global-batch step (the mean of the micro-batch gradients,
    as optax.MultiSteps takes it)."""
    for res in _port(k_passes=2):
        _assert_params_match(res["params"], reference[1])


def test_build_gpt_step_on_a_cpu_world():
    """The port's entry point: finite losses, each rank on its rows of the
    seeded global batch, identical replicas after the steps."""
    res = _torch_world.run_world(_torch_world.train_step_worker, (2,))
    tokens = np.random.RandomState(0).randint(0, 1024, (4, 17))
    for r, out in enumerate(res):
        assert out["rank"] == r and out["device"] == "cpu"
        assert out["static"] == {"n_chips": 2, "global_batch": 4,
                                 "carry_len": 2}
        np.testing.assert_array_equal(out["tokens"], tokens[2 * r:2 * r + 2])
        assert all(np.isfinite(out["losses"]))
        assert out["dtype"] == "torch.float32"
    assert res[0]["losses"] == res[1]["losses"]
    assert res[0]["checksum"] == res[1]["checksum"]


def test_wire_options_reduce_like_the_reference():
    """Average, Sum, the bf16/fp16 wire casts (within one rounding of the
    wire type, 2^-8 and 2^-11 relative, summed over 2 ranks) and the
    predivide split (exact up to fp32 rounding)."""
    grads = np.random.RandomState(3).randn(2, 5, 3).astype(np.float32)
    res = _torch_world.run_world(_torch_world.reduce_worker, (grads,))
    mean, total = grads.mean(0), grads.sum(0)
    for out in res:
        np.testing.assert_allclose(out["average"], mean, rtol=1e-6)
        np.testing.assert_allclose(out["sum"], total, rtol=1e-6)
        np.testing.assert_allclose(out["predivide"], mean, rtol=1e-6)
        for wire, eps in (("bf16", 2.0 ** -8), ("fp16", 2.0 ** -11)):
            np.testing.assert_allclose(
                out[wire], mean, rtol=0,
                atol=3 * eps * np.abs(grads).max())
            assert out[wire].dtype == np.float32
    np.testing.assert_array_equal(res[0]["bf16"], res[1]["bf16"])
