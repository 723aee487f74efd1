"""The training-health plane of the port (``obs/health.py``,
``obs/divergence.py``, ``OverlapPlan(health=True)``) against the JAX
package's on the same inputs.

* the on-device digest (run on the CPU) equals the reference's
  ``jit_digest`` and the numpy host digest bit for bit: bf16, fp32 and
  8-byte leaves (the reference's ``jit_digest`` has no 8-byte rule: those
  against the host digest), words >= 2**31, n > 2**16, an empty bucket;
* ``health_bundle`` within 1e-6 relative of the reference's, NaN where
  NaN; the anomaly judge's alerts and the monitor's first-nonfinite record
  equal the reference's;
* in a gloo world of 2, ``OverlapPlan(health=True)`` bundles on gpt-nano
  weights carried over by ``tree_from_jax`` are within 1e-5 of the JAX
  ``OverlapPlan.local_step(health=True)`` bundles on a 2-device mesh, in
  ``bucket`` and ``bucket+zero1`` (bucket norms compared over
  ``bucket_components``: the two packages bucket the same parameters in
  their own leaf orders);
* a ``grad_ready`` ``flip_bits`` on rank 1 is localized by the port's
  sentinel to the bucket and leaf the JAX sentinel names from the same
  two ranks' parameters.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_world
import horovod_tpu as jhvd
from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu.obs import divergence as jdiv
from horovod_tpu.obs import health as jhealth
from horovod_tpu.obs import registry as jregistry
from horovod_tpu.ops.collectives import shard_map_compat
from horovod_tpu.optim import overlap as joverlap
from horovod_tpu_torch.models.convert import (bucket_components,
                                              jax_leaf_names, tree_from_jax)
from horovod_tpu_torch.obs import divergence as tdiv
from horovod_tpu_torch.obs import health as thealth
from horovod_tpu_torch.obs.registry import MetricsRegistry

WORLD, SEQ, STEPS = 2, 16, 2
# gpt-tiny: gpt-nano's widths at one block (the JAX reference compiles in
# seconds)
TINY = dict(num_layers=1, flash_block_q=16, flash_block_k=16)
BUNDLE_RTOL = 1e-5
LEAF_RTOL = 1e-6
# one parameter per bucket: the two packages' layouts pair bucket for
# bucket, whatever their leaf orders
BUCKET_MB = 1e-6
FLIP = "grad_ready:rank=1:step=2:name=bucket3:action=flip_bits"


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------


def _bf16(rng, n):
    return rng.randn(n).astype(ml_dtypes.bfloat16)


def _torch_of(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


DIGEST_CASES = {
    "bf16": lambda rng: [_bf16(rng, 33), _bf16(rng, 7)],
    "fp32": lambda rng: [rng.randn(40).astype(np.float32),
                         np.array([0.0, -0.0, np.inf, np.nan], np.float32)],
    "high_words": lambda rng: [np.array(
        [0xFFFFFFFF, 0x80000000, 0x80000001, 0xC0000000],
        np.uint32).view(np.float32)],
    "long": lambda rng: [rng.randn(70_001).astype(np.float32),
                         _bf16(rng, 65_537)],
    "empty": lambda rng: [np.zeros(0, np.float32)],
    "eight_byte": lambda rng: [rng.randn(9), np.array(
        [-1, 2**63 - 1, -(2**62)], np.int64)],
}


@pytest.mark.parametrize("case", sorted(DIGEST_CASES))
def test_device_digest_is_bit_exact(case):
    leaves = DIGEST_CASES[case](np.random.RandomState(0))
    layout = jdiv_layout(len(leaves))
    host, _ = jdiv.tree_digest_vector(leaves, layout)
    mat = tdiv.digest_matrix_host(
        tdiv.device_digest(layout)(*[_torch_of(a) for a in leaves]))
    np.testing.assert_array_equal(mat.ravel(), host)
    port_host, _ = tdiv.tree_digest_vector(
        [_torch_of(a) for a in leaves], layout)
    np.testing.assert_array_equal(port_host, host)
    if case != "eight_byte":
        ref = np.asarray(jdiv.jit_digest(layout)(
            *[jnp.asarray(a) for a in leaves]))
        np.testing.assert_array_equal(mat, ref)


def jdiv_layout(n_leaves):
    """One bucket over every leaf, as the digests' bucket prefix takes."""
    from types import SimpleNamespace

    return SimpleNamespace(buckets=[SimpleNamespace(
        index=0, leaf_indices=tuple(range(n_leaves)))])


def test_serving_digests_match():
    rng = np.random.RandomState(3)
    raw = rng.bytes(37)
    np.testing.assert_array_equal(tdiv.blob_digest(raw),
                                  jdiv.blob_digest(raw))
    np.testing.assert_array_equal(tdiv.serve_state_digest(raw, None),
                                  jdiv.serve_state_digest(raw, None))


# ---------------------------------------------------------------------------
# the bundle, the judge and the monitor
# ---------------------------------------------------------------------------


def _bundle_inputs(nan: bool):
    rng = np.random.RandomState(1)
    shapes = [(6, 5), (5,), (3, 4), (4,)]
    grads = [rng.randn(*s).astype(np.float32) for s in shapes]
    upd = [1e-3 * rng.randn(*s).astype(np.float32) for s in shapes]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    params[1][:] = 0.0   # a zero leaf: the ratio's eps shows
    if nan:
        grads[2][1, 2] = np.nan
    layout = joverlap.build_layout(params, 64)
    return 2.5, grads, layout, upd, params


@pytest.mark.parametrize("nan", [False, True])
def test_health_bundle_matches_the_reference(nan):
    loss, grads, layout, upd, params = _bundle_inputs(nan)
    want = np.asarray(jhealth.health_bundle(
        loss, [jnp.asarray(g) for g in grads], layout,
        [jnp.asarray(u) for u in upd], [jnp.asarray(p) for p in params]))
    got = thealth.health_bundle(
        torch.tensor(loss), [torch.from_numpy(g) for g in grads], layout,
        [torch.from_numpy(u) for u in upd],
        [torch.from_numpy(p) for p in params]).numpy()
    assert got.shape == want.shape == (4 + len(layout.buckets),)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=LEAF_RTOL, atol=0)
    assert thealth.bundle_names(3) == jhealth.bundle_names(3)


def _series():
    """A bundle stream: warm-up, a loss spike, a grad explosion, a
    vanishing gradient, a dead bucket, a NaN."""
    rows = []
    for k in range(40):
        loss, grad, nf, buckets = 2.0 - 0.01 * k, 1.0 + 0.001 * k, 0, \
            [0.5, 0.7]
        if k == 12:
            loss = 9.0
        if k == 18:
            grad = 40.0
        if 22 <= k < 25:
            grad = 1e-6
        if k >= 26:
            buckets = [0.5, 0.0]
        if k == 38:
            loss, nf = float("nan"), 3
        rows.append((loss, grad, nf, buckets))
    return rows


def test_anomaly_judge_alerts_equal_the_reference():
    tj, jj = thealth.AnomalyJudge(), jhealth.AnomalyJudge()
    for loss, grad, nf, buckets in _series():
        kw = dict(loss=loss, grad_norm=grad, nonfinite=nf,
                  bucket_norms=buckets)
        assert tj.observe(**kw) == [
            thealth.Alert(a.cls, a.rising, a.detail)
            for a in jj.observe(**kw)]
    assert tj.alerts_total == jj.alerts_total
    assert set(tj.alerts_total.values()) != {0}


def test_monitor_publishes_what_the_reference_does():
    tr, jr = MetricsRegistry(), jregistry.MetricsRegistry()
    _, grads, layout, _, _ = _bundle_inputs(True)
    names = [f"p{i}" for i in range(len(grads))]
    tm = thealth.HealthMonitor(len(layout.buckets), rank=1,
                               leaf_names=names, registry=tr)
    jm = jhealth.HealthMonitor(len(layout.buckets), rank=1,
                               leaf_names=names, registry=jr)
    for step, (loss, grad, nf, _) in enumerate(_series()):
        vec = [loss, grad, 0.01, nf] + [0.5] * len(layout.buckets)
        tm.observe_bundle(step, np.asarray(vec),
                          [torch.from_numpy(g) for g in grads], layout)
        jm.observe_bundle(step, np.asarray(vec), grads, layout)
    assert tm.first_nonfinite == jm.first_nonfinite
    assert tm.first_nonfinite["leaf"] == "p2"
    assert tr.snapshot() == jr.snapshot()


# ---------------------------------------------------------------------------
# the plan's bundles and the sentinel in a gloo world of 2
# ---------------------------------------------------------------------------


def _setup():
    model = jax_gpt("nano", dtype=jnp.float32, **TINY)
    tokens = np.random.RandomState(0).randint(0, 1024, (8, SEQ + 1))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:2, :-1]))
    return model, tokens, params


@pytest.fixture(scope="module")
def both():
    """The port's gloo world (in a background thread) and the JAX
    reference, computed side by side."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(_port)
        ref = _reference()
        return ref, world.result()


@pytest.fixture(scope="module")
def reference(both):
    return both[0]


@pytest.fixture(scope="module")
def port(both):
    return both[1]


def _reference():
    """JAX: STEPS AdamW steps through OverlapPlan(health=True) in each
    mode on a 2-device mesh: mode -> (device 0's bundles, the layout)."""
    model, tokens, params = _setup()
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), (jhvd.DP_AXIS,))
    out = {}
    for mode in ("bucket", "bucket+zero1"):
        plan = joverlap.OverlapPlan(params, optax.adamw(1e-4), mode=mode,
                                    bucket_mb=BUCKET_MB, mesh=mesh,
                                    publish_metrics=False)
        spec = plan.state_spec()

        def local_step(ostate, toks, plan=plan):
            def loss_fn(p):
                logits = model.apply(p, toks[:, :-1])
                return optax.softmax_cross_entropy_with_integer_labels(
                    logits, toks[:, 1:]).mean()

            ostate, loss, bundle = plan.local_step(loss_fn,
                                                   health=True)(ostate)
            return ostate, bundle[None]

        step = jax.jit(shard_map_compat(
            local_step, mesh=mesh, in_specs=(spec, P(jhvd.DP_AXIS)),
            out_specs=(spec, P(jhvd.DP_AXIS))))
        state, bundles = plan.init(params), []
        toks = jnp.asarray(tokens, jnp.int32)
        for _ in range(STEPS):
            state, bundle = step(state, toks)
            bundles.append(np.asarray(bundle)[0])
        out[mode] = (bundles, plan.layout)
    return out


def _port():
    _, tokens, params = _setup()
    # the reference's weights, in the port's names and layouts
    init = _flat(tree_from_jax(jax.tree_util.tree_map(
        np.asarray, params)["params"]))
    return _torch_world.run_world(
        _torch_world.health_worker,
        (init, tokens, STEPS, BUCKET_MB, FLIP, TINY),
        world=WORLD, timeout=240)


def _flat(tree, prefix=""):
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict):
            out.update(_flat(sub, f"{prefix}{name}."))
        else:
            out[prefix + name] = sub.numpy()
    return out


def _ref_names():
    _, _, params = _setup()
    return jax_leaf_names(jax.tree_util.tree_map(np.asarray, params))


def _layout_of(buckets):
    from types import SimpleNamespace

    return SimpleNamespace(buckets=[
        SimpleNamespace(index=i, leaf_indices=tuple(b))
        for i, b in enumerate(buckets)])


@pytest.mark.parametrize("mode", ["bucket", "bucket+zero1"])
def test_plan_bundles_match_the_jax_plan(reference, port, mode):
    ref_bundles, ref_layout = reference[mode]
    got = port[0][mode]
    comps = bucket_components(_layout_of(got["buckets"]), port[0]["names"],
                              ref_layout, _ref_names())
    assert len(comps) == len(ref_layout.buckets)  # a bijection
    for mine, want in zip(got["bundles"], ref_bundles):
        mine = np.asarray(mine)
        np.testing.assert_allclose(mine[:4], want[:4], rtol=BUNDLE_RTOL,
                                   atol=0)
        for pb, rb in comps:
            np.testing.assert_allclose(
                math.sqrt(sum(mine[4 + i] ** 2 for i in pb)),
                math.sqrt(sum(float(want[4 + i]) ** 2 for i in rb)),
                rtol=BUNDLE_RTOL, atol=1e-12)


def test_flip_bits_is_localized_like_the_jax_sentinel(port):
    reps = [res["sentinel"] for res in port]
    assert all(r is not None for r in reps)
    # both ranks reach the same verdict
    assert reps[0]["bucket"] == reps[1]["bucket"]
    assert reps[0]["leaf"] == reps[1]["leaf"]
    assert reps[0]["minority"] == [1]
    # the JAX sentinel over the same two ranks' parameters, in its layout
    _, _, params = _setup()
    jparams = jax.tree_util.tree_map(np.asarray, params)
    ref_names = _ref_names()
    jleaves, _ = jax.tree_util.tree_flatten(jparams)
    jlayout = joverlap.build_layout(
        jparams, int(BUCKET_MB * 1024 * 1024))

    def leaves_of(rank):
        named = port[rank]["sentinel"]["params"]
        out = []
        for name, ref in zip(ref_names, jleaves):
            a = named[name]
            out.append(a if a.shape == ref.shape else a.T.copy())
        return out

    ranks = [leaves_of(0), leaves_of(1)]

    def exchange(vec, name):
        if ".b" in name:
            b = jlayout.buckets[int(name.split(".b")[1].split(".")[0])]
            return np.concatenate([jdiv.leaf_digest_matrix(lv, b).ravel()
                                   for lv in ranks])
        return np.concatenate([jdiv.tree_digest_vector(lv, jlayout)[0]
                               for lv in ranks])

    sentinel = jdiv.DivergenceSentinel(
        jlayout, rank=0, check_steps=STEPS, exchange=exchange,
        leaf_names=ref_names, registry=jregistry.MetricsRegistry())
    want = sentinel.check(STEPS, ranks[0])
    assert want is not None and want.minority_ranks == (1,)
    assert reps[0]["leaf"] == want.leaf_name
    comps = bucket_components(_layout_of(reps[0]["buckets"]),
                              port[0]["names"], jlayout, ref_names)
    assert ([reps[0]["bucket"]], [want.bucket]) in comps
