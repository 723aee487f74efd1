"""The port's sparse gradient path (``horovod_tpu_torch.ops.sparse`` and
``DistributedOptimizer(sparse_as_dense=...)``) held against the JAX
package's (``horovod_tpu.ops.sparse``): the cases of ``test_sparse.py``,
on a 2-rank gloo world whose ranks hold different numbers of rows (3 and
5), with repeated indices.

An allreduce of IndexedSlices is an allgather of values and indices,
duplicates kept, values divided by the world for Average.  The expected
dense results are the numpy scatter-add of every rank's rows, and JAX's
``to_dense`` of the same concatenated slices; both to 1e-6 (one fp32
division).  ``nn.Embedding(sparse=True)`` trains by SGD for 3 steps under
``sparse_as_dense`` True and False to the same bits: the weights, the loss
weights and the step are multiples of 2^-4 no larger than 4, so every sum
is exact whatever order the scatter-adds take, and the two paths differ
only in where the duplicates are combined.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_world
from horovod_tpu.ops.sparse import IndexedSlices as JaxSlices
from horovod_tpu.ops.sparse import apply_sparse_update as jax_apply
from horovod_tpu.ops.sparse import to_dense as jax_to_dense
from horovod_tpu_torch.ops.sparse import (IndexedSlices, apply_sparse_update,
                                          from_coo, to_coo, to_dense)

WORLD = 2
ROWS, DIM = 8, 2
PER_RANK = (3, 5)   # ragged
TOL = 1e-6
STEPS = 3


def _cases():
    rng = np.random.RandomState(0)
    cases = []
    for n in PER_RANK:
        values = rng.randn(n, DIM).astype(np.float32)
        indices = rng.randint(0, ROWS, size=n).astype(np.int64)
        indices[-1] = indices[0]  # a duplicate on every rank
        cases.append((values, indices))
    return cases


def _embedding_inputs():
    rng = np.random.RandomState(1)
    state = (rng.randint(-32, 33, (ROWS, DIM)) / 16).astype(np.float32)
    idx = rng.randint(0, ROWS, (WORLD, 6))
    idx[:, 1] = idx[:, 0]
    w = (rng.randint(-8, 9, (WORLD, 6, DIM)) / 16).astype(np.float32)
    return state, idx, w


def _expected(op):
    out = np.zeros((ROWS, DIM), np.float32)
    for values, indices in _cases():
        np.add.at(out, indices, values)
    return out / WORLD if op == "average" else out


@pytest.fixture(scope="module")
def port():
    state, idx, w = _embedding_inputs()
    return _torch_world.run_world(
        _torch_world.sparse_worker,
        (_cases(), ROWS, DIM, state, idx, w, STEPS), world=WORLD,
        timeout=240)


def test_to_dense_scatter_adds_duplicates():
    values = np.array([[1.0, 2.0], [3.0, 4.0], [10.0, 10.0]], np.float32)
    indices = np.array([1, 1, 3])
    got = to_dense(IndexedSlices(torch.from_numpy(values),
                                 torch.from_numpy(indices), (5, 2)))
    want = jax_to_dense(JaxSlices(jnp.asarray(values), jnp.asarray(indices),
                                  (5, 2)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), [[0, 0], [4, 6], [0, 0], [10, 10], [0, 0]])


def test_apply_sparse_update_matches_jax():
    values, indices = _cases()[1]
    params = np.random.RandomState(2).randn(ROWS, DIM).astype(np.float32)
    got = apply_sparse_update(torch.from_numpy(params),
                              IndexedSlices(torch.from_numpy(values),
                                            torch.from_numpy(indices),
                                            (ROWS, DIM)), -0.5)
    want = jax_apply(jnp.asarray(params),
                     JaxSlices(jnp.asarray(values), jnp.asarray(indices),
                               (ROWS, DIM)), -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("op", ["average", "sum"])
def test_allreduce_sparse_gathers_ragged_rows(port, op):
    """Every rank holds every rank's rows in rank order, duplicates kept,
    values divided by the world for Average; densified as JAX densifies
    the same slices."""
    cases = _cases()
    all_values = np.concatenate([v for v, _ in cases])
    all_indices = np.concatenate([i for _, i in cases])
    scale = 1.0 / WORLD if op == "average" else 1.0
    want_dense = np.asarray(jax_to_dense(JaxSlices(
        jnp.asarray(all_values * scale), jnp.asarray(all_indices),
        (ROWS, DIM))))
    for res in port:
        values, indices, shape, dense = res[op]
        assert shape == (ROWS, DIM)
        assert values.shape == (sum(PER_RANK), DIM)
        np.testing.assert_array_equal(indices, all_indices)
        np.testing.assert_allclose(values, all_values * scale, atol=TOL)
        np.testing.assert_allclose(dense, want_dense, atol=TOL)
        np.testing.assert_allclose(dense, _expected(op), atol=TOL)


def test_allreduce_mixed_list_with_sparse_leaf(port):
    for res in port:
        np.testing.assert_allclose(res["mixed_dense"], _expected("sum"),
                                   atol=TOL)
        np.testing.assert_array_equal(res["mixed_w"], np.full(DIM, WORLD))


def test_sparse_as_dense_in_distributed_optimizer(port):
    for res in port:
        np.testing.assert_allclose(res["as_dense"], _expected("average"),
                                   atol=TOL)


def test_sparse_kept_sparse_when_disabled(port):
    """``sparse_as_dense=False``: the gradient stays an uncoalesced COO
    tensor of every rank's rows, which densifies to the average."""
    for res in port:
        is_sparse, coalesced, values_shape, dense = res["kept"]
        assert is_sparse and not coalesced
        assert values_shape == (sum(PER_RANK), DIM)
        np.testing.assert_allclose(dense, _expected("average"), atol=TOL)


def test_adasum_sparse_raises_without_densify(port):
    for res in port:
        assert "Adasum does not support sparse" in res["adasum_sparse"]


def test_coo_round_trip_keeps_duplicates(port):
    cases = _cases()
    for r, res in enumerate(port):
        coalesced, values, indices, shape = res["coo"]
        assert not coalesced and shape == (ROWS, DIM)
        np.testing.assert_array_equal(values, cases[r][0])
        np.testing.assert_array_equal(indices, cases[r][1])


def test_coo_round_trip_of_an_embedding_gradient():
    """``nn.Embedding(sparse=True)``'s gradient reads as one row per lookup,
    repeated rows included, and writes back as the same tensor."""
    emb = torch.nn.Embedding(ROWS, DIM, sparse=True)
    idx = torch.tensor([3, 1, 3, 3])
    emb(idx).sum().backward()
    slices = from_coo(emb.weight.grad)
    np.testing.assert_array_equal(slices.indices.numpy(), [3, 1, 3, 3])
    assert slices.values.shape == (4, DIM)
    back = to_coo(slices)
    assert not back.is_coalesced()
    assert torch.equal(back.to_dense(), emb.weight.grad.to_dense())


def test_sparse_embedding_sgd_is_the_same_either_way(port):
    """Three SGD steps of ``nn.Embedding(sparse=True)``: the sparse
    gradient kept sparse and the densified one give the same weights, on
    every rank, and the weights moved."""
    state, _, _ = _embedding_inputs()
    for res in port:
        np.testing.assert_array_equal(res["embedding_True"],
                                      res["embedding_False"])
        assert not np.array_equal(res["embedding_True"], state)
    np.testing.assert_array_equal(port[0]["embedding_True"],
                                  port[1]["embedding_True"])
