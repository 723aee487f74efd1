"""Sparse (embedding) gradient collectives (counterpart of
``horovod_tpu/ops/sparse.py``; reference horovod/tensorflow/__init__.py:74-89).

A sparse gradient is never summed elementwise: every rank allgathers its
``(values, indices)`` pair and the optimizer applies the concatenated
slices, whose duplicate indices its scatter-add combines.  Rows may differ
in number across ranks (the collectives run eagerly, as the reference's
eager path does).

PyTorch's sparse gradient is the uncoalesced COO tensor that
``nn.Embedding(sparse=True)`` leaves in ``.grad``: :func:`from_coo` reads it
and :func:`to_coo` writes one back, both without coalescing, which would
combine the duplicate rows the reference keeps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..basics import size as _size
from .collectives import Average, ReduceOp, Sum, allgather

__all__ = [
    "IndexedSlices",
    "allreduce_sparse",
    "apply_sparse_update",
    "from_coo",
    "to_coo",
    "to_dense",
]


class IndexedSlices(NamedTuple):
    """Row slices of a dense tensor: ``values`` ``(n, *dense_shape[1:])``
    at rows ``indices`` ``(n,)`` of dim 0 (tf.IndexedSlices, the type the
    reference special-cases)."""

    values: torch.Tensor
    indices: torch.Tensor
    dense_shape: Tuple[int, ...]


def to_dense(slices: IndexedSlices) -> torch.Tensor:
    """Scatter-add the slices into a dense tensor: duplicate rows add."""
    values = slices.values
    dense = values.new_zeros(tuple(slices.dense_shape))
    return dense.index_add(0, slices.indices.long(), values)


def from_coo(grad: torch.Tensor) -> IndexedSlices:
    """The slices of a sparse COO tensor over dim 0 (an embedding's
    gradient), duplicates kept."""
    if grad.sparse_dim() != 1:
        raise ValueError(
            f"expected a COO tensor sparse in dim 0 only, got sparse_dim "
            f"{grad.sparse_dim()}")
    return IndexedSlices(grad._values(), grad._indices()[0],
                         tuple(grad.shape))


def to_coo(slices: IndexedSlices) -> torch.Tensor:
    """An uncoalesced COO tensor of the slices (duplicates kept); the
    indices are checked against the dense shape."""
    return torch.sparse_coo_tensor(slices.indices.long()[None],
                                   slices.values, tuple(slices.dense_shape),
                                   check_invariants=True)


def allreduce_sparse(
    slices: IndexedSlices,
    op: ReduceOp = Average,
    *,
    name: Optional[str] = None,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
) -> IndexedSlices:
    """Allreduce an IndexedSlices by allgathering its values and indices
    across the world: every rank's slices concatenated in rank order, the
    values divided by the world size for Average.  Duplicate indices are
    not combined (the optimizer's scatter-add does that), as in the
    reference."""
    if op not in (Average, Sum):
        raise NotImplementedError(
            "sparse allreduce supports Average/Sum only (reference parity: "
            "horovod/tensorflow/__init__.py:74-89)")
    del name
    values = slices.values
    if prescale_factor != 1.0:
        values = values * prescale_factor
    g_values = allgather(values)
    g_indices = allgather(slices.indices)
    if op == Average:
        g_values = g_values / _size()
    if postscale_factor != 1.0:
        g_values = g_values * postscale_factor
    return IndexedSlices(g_values, g_indices, tuple(slices.dense_shape))


def apply_sparse_update(params: torch.Tensor, slices: IndexedSlices,
                        step_size) -> torch.Tensor:
    """``params[indices] += step_size * values`` as a scatter-add (a new
    tensor): the optimizer's half of the sparse path."""
    return params.index_add(0, slices.indices.long(),
                            step_size * slices.values.to(params.dtype))
