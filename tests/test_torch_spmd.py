"""The port's SPMD training surface (``mesh``, ``distribute``,
``DistributedGradientTransform``, ``sync_gradients``; ROADMAP A14) held
against the JAX package's on every input of the reference's own tests of
those names: ``tests/test_optimizer.py`` (the transform: averaging,
predivide, the bf16 wire), ``tests/test_sparse.py`` (sparse leaves, Adasum
refusing them), ``tests/test_train_slice.py`` (linear regression, the
``distribute`` helper) and ``tests/test_overlap.py`` (``sync_gradients``,
``has_aux``, the op check), plus every ``mesh`` shape and ``slice_grid``.

The port runs in gloo worlds (``tests/_torch_world.py``): one of 2 ranks
for the transform, ``distribute`` and ``sync_gradients``, one of 4 (2 hosts
of 2, 2 forced slices) for the meshes.  Where the result depends on the
world size (the transform's averages, the per-shard loss of
``sync_gradients``), the reference runs on a 2-device mesh built directly
(``Mesh(jax.devices()[:2])``); where it does not (an average over equal
shards of per-shard means: the linear regression, the ``distribute``
helper, the gpt-nano steps), it runs on ``hvd.mesh("flat")``'s 8 devices,
one row per device.  The stacked inputs give rank / device ``r`` row
``r``.

Tolerances: the transform's average and predivide 1e-6 (one sum of two
fp32 values); the bf16 wire within one bf16 rounding of the reference's
result (2^-7 relative) and, as the reference test, 3e-2 of the fp32
mean; sparse leaves 1e-6; the regressions 1e-5 on the parameters and
1e-4 on the losses; ``sync_gradients`` 1e-5 (XLA's and torch's fp32
matmuls sum in other orders), and the port's own plain reduction bit for
bit.  The slice as a whole: gpt-nano (fp32, flash attention) built the
SPMD way in both packages, ``distribute`` + ``sync_gradients`` +
``DistributedGradientTransform`` into AdamW 1e-4, 2 steps from the same
weights (``models.params_from_jax``): losses 2e-4, parameters 1e-4 and
1e-6 on all but 0.1% of the elements (the bounds of
``tests/test_torch_optim.py``, for the same reason: Adam divides each
element by its own RMS).
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_spmd
import _torch_world
import horovod_tpu as jhvd
from horovod_tpu.basics import slice_grid as jslice_grid
from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu.ops.sparse import IndexedSlices as JSlices
from horovod_tpu.ops.sparse import to_dense as jto_dense
from horovod_tpu.optim import overlap as joverlap
from horovod_tpu_torch.basics import slice_grid
from horovod_tpu_torch.models import params_from_jax

WORLD = 2
AX = jhvd.DP_AXIS
GPT_STEPS = 2
SEQ = 16
LOSS_TOL = 2e-4
PARAM_TOL = 1e-4
CLOSE_TOL, CLOSE_SHARE = 1e-6, 1e-3


def _mlp_params():
    """tests/test_overlap.py::_init_params: odd leaves (37, 41)."""
    sizes = [32, 64, 37, 41, 10]
    key = jax.random.PRNGKey(0)
    params = []
    for i in range(4):
        k, key = jax.random.split(key)
        params.append({
            "w": jax.random.normal(k, (sizes[i], sizes[i + 1])) * 0.1,
            "b": jnp.zeros(sizes[i + 1], jnp.float32)})
    return params


def _mlp_loss(params, x, y):
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < 3:
            h = jax.nn.relu(h)
    return jnp.mean((h - y) ** 2)


def _gpt_setup():
    model = jax_gpt("nano", dtype=jnp.float32, flash_block_q=16,
                    flash_block_k=16)
    tokens = np.random.RandomState(0).randint(0, 1024, (8, SEQ + 1))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:2, :-1]))
    return model, tokens, params


def _inputs() -> dict:
    rng = np.random.RandomState(0)
    w_true = rng.randn(5, 1).astype(np.float32)
    X = rng.randn(64, 5).astype(np.float32)
    srng = np.random.RandomState(1)
    _, tokens, params = _gpt_setup()
    return {
        "average": np.random.RandomState(0).randn(WORLD, 4).astype(
            np.float32),
        "predivide": np.random.RandomState(1).randn(WORLD, 4).astype(
            np.float32),
        "bf16": np.random.RandomState(2).randn(WORLD, 16).astype(
            np.float32),
        "sparse_values": srng.randn(WORLD, 2, 2).astype(np.float32),
        "sparse_indices": srng.randint(0, 8, size=(WORLD, 2)).astype(
            np.int32),
        "kept_values": np.arange(WORLD * 2 * 2, dtype=np.float32).reshape(
            WORLD, 2, 2),
        "kept_indices": np.tile(np.arange(2, dtype=np.int32), (WORLD, 1)),
        "linreg_X": X, "linreg_y": X @ w_true, "linreg_w": w_true,
        "helper_batch": np.random.RandomState(1).randn(16, 3).astype(
            np.float32),
        "mlp": jax.tree_util.tree_map(np.asarray, _mlp_params()),
        "mlp_x": np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                              (16, 32))),
        "mlp_y": np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                              (16, 10))),
        "gpt_state": {k: v.numpy() for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)).items()},
        "gpt_tokens": tokens, "gpt_steps": GPT_STEPS,
    }


INPUTS = _inputs()


def _in_background(fn):
    """Run ``fn`` on a thread (the port's world runs while the reference
    compiles); the returned callable joins it and returns its result."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as exc:  # noqa: BLE001 - re-raised on join
            box["exc"] = exc

    th = threading.Thread(target=run, daemon=True)
    th.start()
    done = {}

    def join():
        if "out" in done:
            return done["out"]
        th.join(timeout=300)
        if "exc" in box:
            raise box["exc"]
        done["out"] = box["out"]
        return box["out"]
    return join


def _mesh_world():
    return _torch_world.run_world(_torch_spmd.mesh_worker, world=4,
                                  local_size=2, timeout=240)


@pytest.fixture(scope="module", autouse=True)
def started():
    """Both worlds, started on threads before the first test: the tests
    compute the reference first and join the port's world after."""
    spmd = _in_background(lambda: _torch_world.run_world(
        _torch_spmd.spmd_worker, (INPUTS,), world=WORLD, timeout=240))
    return {"spmd": spmd, "mesh": _in_background(_mesh_world)}


def _mesh2():
    return Mesh(np.asarray(jax.devices()[:WORLD], dtype=object), (AX,))


def _per_rank(fn, *stacked):
    return shard_map(fn, mesh=_mesh2(),
                     in_specs=tuple(P(AX) for _ in stacked),
                     out_specs=P(AX), check_vma=False)(*stacked)


# ---------------------------------------------------------------------------
# DistributedGradientTransform (tests/test_optimizer.py)
# ---------------------------------------------------------------------------


def _jax_transform(tx, grads, tree):
    def fn(g):
        out, _ = tx.update(tree(g[0]), tx.init(None))
        return jax.tree_util.tree_leaves(out)[0][None]
    return np.asarray(_per_rank(fn, jnp.asarray(grads)))


@pytest.mark.parametrize("case,kwargs,tree", [
    ("average", {}, lambda g: {"w": g}),
    ("predivide", {"gradient_predivide_factor": 2.0}, lambda g: (g,)),
])
def test_transform_reduces_like_the_reference(started, case, kwargs, tree):
    grads = INPUTS[case]
    want = _jax_transform(jhvd.DistributedGradientTransform(
        jhvd.Average, **kwargs), grads, tree)
    port = started["spmd"]()
    for r, res in enumerate(port):
        np.testing.assert_allclose(res[case], want[r], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(res[case], grads.mean(0), rtol=1e-5)


def test_transform_bf16_wire(started):
    grads = INPUTS["bf16"]
    want = _jax_transform(jhvd.DistributedGradientTransform(
        jhvd.Average, compression=jhvd.Compression.bf16), grads,
        lambda g: (g,))
    port = started["spmd"]()
    for r, res in enumerate(port):
        assert res["bf16_dtype"] == "torch.float32"  # decompressed back
        np.testing.assert_allclose(res["bf16"], want[r], rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max())
        np.testing.assert_allclose(res["bf16"], grads.mean(0), rtol=3e-2,
                                   atol=3e-2)


def test_transform_validates_like_the_reference():
    import horovod_tpu_torch as hvd

    for mod in (hvd, jhvd):
        with pytest.raises(ValueError, match="Average/Sum/Adasum"):
            mod.DistributedGradientTransform(mod.Max)
        with pytest.raises(ValueError, match="hierarchical_axes"):
            mod.DistributedGradientTransform(hierarchical_axes=("a",))
        # predivide x hierarchical is refused at the first update only
        mod.DistributedGradientTransform(
            gradient_predivide_factor=2.0,
            hierarchical_axes=(mod.LOCAL_AXIS, mod.CROSS_AXIS))


def test_transform_predivide_with_hierarchy_raises_at_update(started):
    import torch

    import horovod_tpu_torch as hvd

    tx = hvd.DistributedGradientTransform(
        gradient_predivide_factor=2.0,
        hierarchical_axes=(hvd.LOCAL_AXIS, hvd.CROSS_AXIS))
    assert tx.init({"w": torch.zeros(1)}) == ()
    port = started["spmd"]()
    for res in port:
        assert "flat-psum knob" in res["predivide_hierarchy"]


# ---------------------------------------------------------------------------
# sparse leaves (tests/test_sparse.py)
# ---------------------------------------------------------------------------


def test_adasum_refuses_sparse_leaves(started):
    port = started["spmd"]()
    for res in port:
        assert "Adasum does not support" in res["adasum_sparse"]
        assert "Adasum does not support" in res["adasum_coo"]


def test_sparse_as_dense_in_gradient_transform(started):
    values, indices = INPUTS["sparse_values"], INPUTS["sparse_indices"]
    tx = jhvd.DistributedGradientTransform()

    def step(v, i):
        grads = {"emb": JSlices(v[0], i[0], (8, 2)),
                 "w": jnp.ones((2,)) * i[0, 0].astype(jnp.float32)}
        out, _ = tx.update(grads, tx.init(None))
        return out["emb"][None], out["w"][None]

    emb, w = shard_map(step, mesh=_mesh2(), in_specs=(P(AX), P(AX)),
                       out_specs=(P(AX), P(AX)))(values, indices)
    port = started["spmd"]()
    for r, res in enumerate(port):
        np.testing.assert_allclose(res["sparse_as_dense"][0],
                                   np.asarray(emb[r]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(res["sparse_as_dense"][1],
                                   np.asarray(w[r]), rtol=1e-6)


def test_sparse_kept_sparse_when_disabled(started):
    values, indices = INPUTS["kept_values"], INPUTS["kept_indices"]
    tx = jhvd.DistributedGradientTransform(sparse_as_dense=False)

    def step(v, i):
        out, _ = tx.update({"emb": JSlices(v[0], i[0], (6, 2))},
                           tx.init(None))
        return jto_dense(out["emb"])[None]

    dense = shard_map(step, mesh=_mesh2(), in_specs=(P(AX), P(AX)),
                      out_specs=P(AX))(values, indices)
    port = started["spmd"]()
    for r, res in enumerate(port):
        is_slices, shape, got = res["kept"]
        # concatenated across ranks: WORLD x 2 rows
        assert is_slices and shape == (WORLD * 2, 2)
        np.testing.assert_allclose(got, np.asarray(dense[r]), rtol=1e-6)
        is_coo, got = res["kept_coo"]
        assert is_coo
        np.testing.assert_allclose(got, np.asarray(dense[r]), rtol=1e-6)


# ---------------------------------------------------------------------------
# distribute (tests/test_train_slice.py)
# ---------------------------------------------------------------------------


def test_linear_regression_converges(started):
    X, y = INPUTS["linreg_X"], INPUTS["linreg_y"]
    tx = jhvd.DistributedOptimizer(optax.sgd(0.2))

    def local_step(params, opt_state, xb, yb):
        def loss_fn(p):
            return jnp.mean((xb @ p["w"] - yb) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state,
                jhvd.allreduce(loss, op=jhvd.Average))

    step = jhvd.distribute(local_step,
                           in_specs=(P(), P(), P(AX), P(AX)),
                           out_specs=(P(), P(), P()))
    params = {"w": jnp.zeros((5, 1), jnp.float32)}
    state, losses = tx.init(params), []
    for _ in range(60):
        params, state, loss = step(params, state, X, y)
        losses.append(float(loss))
    port = started["spmd"]()
    for res in port:
        got_losses, got_w = res["linreg"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(got_w, np.asarray(params["w"]),
                                   atol=1e-5)
        assert got_losses[-1] < 1e-3 and got_losses[-1] < got_losses[0] * 1e-2
        np.testing.assert_allclose(got_w, INPUTS["linreg_w"], atol=0.05)


def test_distribute_helper(started):
    tx = jhvd.DistributedOptimizer(optax.sgd(0.5))
    target = jnp.asarray([1.0, 2.0, 3.0])

    def local_step(p, s, batch):
        def loss_fn(p):
            return jnp.mean((batch @ p[None].T - batch @ target[None].T)
                            ** 2)

        u, s = tx.update(jax.grad(loss_fn)(p), s, p)
        return optax.apply_updates(p, u), s

    step = jhvd.distribute(local_step)
    p = jnp.zeros((3,), jnp.float32)
    s = tx.init(p)
    batch = jnp.asarray(INPUTS["helper_batch"])
    for _ in range(100):
        p, s = step(p, s, batch)
    port = started["spmd"]()
    for res in port:
        np.testing.assert_allclose(res["helper"], np.asarray(p), atol=1e-5)
        np.testing.assert_allclose(res["helper"], np.asarray(target),
                                   atol=0.05)


def test_distribute_specs(started):
    batch = INPUTS["helper_batch"]
    port = started["spmd"]()
    for res in port:
        got, rows = res["gathered"]
        np.testing.assert_array_equal(got, batch * 2)  # P(axis): whole
        assert rows == len(batch) // WORLD             # P(): this rank's
        assert "cannot split dim 0" in res["indivisible"]
        np.testing.assert_array_equal(res["dim1"], batch[:, :2])
        assert res["axis"][1] == WORLD
    assert [res["axis"][0] for res in port] == list(range(WORLD))


# ---------------------------------------------------------------------------
# sync_gradients (tests/test_overlap.py)
# ---------------------------------------------------------------------------


def _jax_sync(has_aux=False):
    params = _mlp_params()
    x, y = INPUTS["mlp_x"], INPUTS["mlp_y"]

    def loss_aux(p, xb, yb):
        return _mlp_loss(p, xb, yb), {"n": jnp.asarray(1.0)}

    def synced(px, xb, yb):
        return joverlap.sync_gradients(
            loss_aux if has_aux else _mlp_loss, px, xb, yb,
            bucket_mb=8 / 1024.0, has_aux=has_aux)

    return shard_map(synced, mesh=_mesh2(), in_specs=(P(), P(AX), P(AX)),
                     out_specs=(P(), P()), check_vma=False)(params, x, y)


def test_sync_gradients_matches_the_reference(started, jax_sync):
    (loss, _), grads = jax_sync
    want = [[np.asarray(d["w"]), np.asarray(d["b"])] for d in grads]
    port = started["spmd"]()
    got_loss, got = port[0]["sync"]   # shard_map's P() out: shard 0's
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for res in port:
        flat = [a for pair in res["sync"][1] for a in pair]
        for a, b in zip(flat, res["plain"]):
            np.testing.assert_array_equal(a, b)   # the plain average
        # every bucket reduced once, each issued inside the backward
        assert sorted(res["sync_issued"]) == list(range(res["sync_buckets"]))
        assert res["sync_buckets"] > 1


def test_sync_gradients_has_aux(started, jax_sync):
    (loss, aux), grads = jax_sync
    port = started["spmd"]()
    for res in port:
        n, got_loss, keys = res["aux"]
        assert n == float(aux["n"]) == 1.0
        assert np.isfinite(got_loss)
        assert keys == [sorted(d) for d in grads]
    np.testing.assert_allclose(port[0]["aux"][1], float(loss), rtol=1e-5)


def test_sync_gradients_rejects_unsupported_op(started):
    with pytest.raises(ValueError, match="Average/Sum"):
        joverlap.sync_gradients(_mlp_loss, _mlp_params(), op=jhvd.Adasum)
    port = started["spmd"]()
    for res in port:
        assert "Average/Sum" in res["bad_op"]


# ---------------------------------------------------------------------------
# the slice as a whole: gpt-nano built the SPMD way
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_sync():
    """The reference's sync_gradients with has_aux: (loss, aux), grads."""
    return _jax_sync(has_aux=True)


@pytest.fixture(scope="module")
def gpt_reference():
    model, tokens, params = _gpt_setup()
    tx = optax.chain(jhvd.DistributedGradientTransform(), optax.adamw(1e-4))

    def loss_fn(p, toks):
        logits = model.apply(p, toks[:, :-1])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, toks[:, 1:]).mean()

    def local_step(p, s, toks):
        loss, grads = joverlap.sync_gradients(loss_fn, p, toks,
                                              bucket_mb=0.25)
        updates, s = tx.update(grads, s, p)
        return (optax.apply_updates(p, updates), s,
                jax.lax.pmean(loss, AX))

    step = jhvd.distribute(local_step, out_specs=(P(), P(), P()))
    state, losses = tx.init(params), []
    toks = jnp.asarray(tokens, jnp.int32)
    for _ in range(GPT_STEPS):
        params, state, loss = step(params, state, toks)
        losses.append(float(loss))
    return losses, params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           params))


def test_gpt_nano_spmd_steps_match_jax(started, gpt_reference):
    losses, want = gpt_reference
    port = started["spmd"]()
    for res in port:
        got = res["gpt"]
        np.testing.assert_allclose(got["losses"], losses, atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        assert set(got["params"]) == set(want)
        far = total = 0
        for name, a in got["params"].items():
            b = want[name].numpy()
            np.testing.assert_allclose(a, b, atol=PARAM_TOL, rtol=0,
                                       err_msg=name)
            far += int((np.abs(a - b) > CLOSE_TOL).sum())
            total += a.size
        assert far <= CLOSE_SHARE * total, (far, total)
    for name, a in port[0]["gpt"]["params"].items():
        np.testing.assert_array_equal(a, port[1]["gpt"]["params"][name],
                                      err_msg=name)


# ---------------------------------------------------------------------------
# mesh and slice_grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ranks,num_slices,hosts", [
    (8, 2, 1), (8, 2, 2), (8, 4, 1), (8, 1, 4), (4, 2, 1), (1, 1, 1)])
def test_slice_grid_is_the_references(ranks, num_slices, hosts):
    got = slice_grid(list(range(ranks)), num_slices, hosts)
    want = jslice_grid(list(range(ranks)), num_slices, hosts)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_slices,hosts", [(3, 1), (2, 3), (0, 1),
                                              (2, 0)])
def test_slice_grid_refuses_what_the_reference_refuses(num_slices, hosts):
    with pytest.raises(ValueError) as mine:
        slice_grid(list(range(8)), num_slices, hosts)
    with pytest.raises(ValueError) as ref:
        jslice_grid(list(range(8)), num_slices, hosts)
    assert str(mine.value) == str(ref.value)


def test_mesh_errors_are_the_references(started):
    port = started["spmd"]()
    for shape, key in (("slice", "slice_error"), ("torus", "unknown_error")):
        with pytest.raises(ValueError) as ref:
            jhvd.mesh(shape)
        for res in port:
            assert res[key] == str(ref.value)


def test_flat_mesh(started):
    for r, res in enumerate(started["mesh"]()):
        m = res["flat"]
        assert m["shape"] == (4,) and m["names"] == (AX,)
        assert m["grid"] == [0, 1, 2, 3] and m["ranks"] == [[0, 1, 2, 3]]
        assert m["own"] == [True] and m["cached"]


def test_hierarchical_mesh_is_the_two_level_groups(started):
    want = np.arange(4).reshape(2, 2)   # hosts x ranks per host
    for r, res in enumerate(started["mesh"]()):
        m = res["hierarchical"]
        assert m["names"] == (jhvd.CROSS_AXIS, jhvd.LOCAL_AXIS)
        assert m["shape"] == (2, 2) and m["grid"] == want.tolist()
        assert m["ranks"] == [want[:, r % 2].tolist(),
                              want[r // 2].tolist()]
        assert m["own"] == [True, True]   # group_of_axis's, no second one
        assert "uneven" in res["uneven"]


def test_slice_mesh_follows_slice_grid(started):
    # 2 slices of 1 host (cross_size 2 // 2) of 2 ranks
    want = jslice_grid(list(range(4)), 2, 1).astype(int)
    for r, res in enumerate(started["mesh"]()):
        m = res["slice"]
        assert m["names"] == (jhvd.SLICE_AXIS, jhvd.CROSS_AXIS,
                              jhvd.LOCAL_AXIS)
        assert m["shape"] == (2, 1, 2) and m["grid"] == want.tolist()
        s, _, l = np.argwhere(want == r)[0]
        assert m["ranks"] == [want[:, 0, l].tolist(), [r],
                              want[s, 0].tolist()]
        # SLICE_AXIS resolves to the mesh's group, LOCAL_AXIS is the
        # two-level local group; the hosts of one slice are narrower than
        # the two-level cross group, so that dimension has its own
        assert m["own"] == [True, False, True]
