"""Data-parallel optimizer (counterpart of ``horovod_tpu/optim/__init__.py``;
reference: hvd.DistributedOptimizer and the broadcast helpers of
horovod/torch/__init__.py).

:class:`DistributedOptimizer` wraps any ``torch.optim.Optimizer``: at
``step()`` it averages the gradients across ranks — in the fixed order of
the optimizer's parameters, through one :func:`grouped_allreduce` that
fuses them per dtype — and then steps the wrapped optimizer.  Every rank
steps with the same averaged gradients, so replicas stay identical.  The
reference transform's other paths (``DistributedGradientTransform``,
horovod_tpu/optim/__init__.py:59-220) are here too: ``op=Adasum`` (each
gradient on its own), sparse gradients (``sparse_as_dense``) and the
two-level schedule (``hierarchical_axes``, ``dcn_compression``).
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Union

import torch
import torch.distributed as dist

from ..basics import global_topology
from ..ops.collectives import Adasum, Average, ReduceOp, Sum, \
    grouped_allreduce
from ..ops.compression import Compression
from ..ops.sparse import allreduce_sparse, from_coo, to_coo, to_dense

__all__ = [
    "DistributedOptimizer",
    "broadcast_parameters",
    "broadcast_optimizer_state",
    "broadcast_object",
]


class DistributedOptimizer:
    """Wrap ``optimizer`` so its updates see globally reduced gradients.

    ``compression`` casts each gradient to its wire dtype around the
    reduce.  ``gradient_predivide_factor`` f splits averaging into a
    pre-scale 1/f and a post-scale f/N (Average only).
    ``backward_passes_per_step`` k accumulates k micro-batches before one
    reduce and one update, like the reference's ``optax.MultiSteps``:
    ``step()`` counts calls and acts on every k-th, using the mean of the k
    accumulated gradients, and ``zero_grad()`` keeps the gradients while an
    accumulation is open.

    ``op=Adasum`` reduces each gradient on its own (after compression),
    never a fused buffer.  A sparse gradient (the COO ``.grad`` of
    ``nn.Embedding(sparse=True)``) is made dense before the reduce when
    ``sparse_as_dense`` (the default); otherwise its rows are allgathered
    and it stays a sparse, uncoalesced ``.grad`` for the optimizer's
    scatter-add (``torch.optim.SGD`` takes one, ``AdamW`` does not), which
    Adasum refuses.  ``hierarchical_axes=(LOCAL_AXIS, CROSS_AXIS)`` reduces
    each gradient by the two-level schedule (Adasum across the cross group
    with ``op=Adasum``), ``dcn_compression`` casting its cross leg; a
    ``gradient_predivide_factor`` other than 1 then raises at the first
    step, where the schedule is used, as the reference's transform does.
    """

    def __init__(
        self,
        optimizer: torch.optim.Optimizer,
        *,
        op: ReduceOp = Average,
        compression=Compression.none,
        backward_passes_per_step: int = 1,
        gradient_predivide_factor: float = 1.0,
        sparse_as_dense: bool = True,
        hierarchical_axes=None,
        dcn_compression=None,
    ):
        if op not in (Average, Sum, Adasum):
            raise ValueError(
                f"DistributedOptimizer supports Average/Sum/Adasum, got "
                f"{op!r}")
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        if hierarchical_axes is not None and len(hierarchical_axes) != 2:
            raise ValueError(
                "hierarchical_axes must be (local_axis, cross_axis), got "
                f"{hierarchical_axes!r}")
        self.optimizer = optimizer
        self.op = op
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self.gradient_predivide_factor = gradient_predivide_factor
        self.sparse_as_dense = sparse_as_dense
        self.hierarchical_axes = (tuple(hierarchical_axes)
                                  if hierarchical_axes else None)
        self.dcn_compression = dcn_compression
        self._passes = 0

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict):
        self.optimizer.load_state_dict(state_dict)

    def zero_grad(self, set_to_none: bool = True) -> None:
        if self._passes == 0:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def synchronize(self) -> None:
        """Replace every gradient by its reduction across ranks."""
        params = [p for g in self.optimizer.param_groups
                  for p in g["params"] if p.grad is not None]
        if not params:
            return
        k = self.backward_passes_per_step
        dense, grads = [], []
        for p in params:
            if not p.grad.is_sparse:
                dense.append(p)
                grads.append(p.grad)
            elif self.sparse_as_dense:
                dense.append(p)
                grads.append(to_dense(from_coo(p.grad)))
            elif self.op == Adasum:
                # reference parity: horovod/torch/mpi_ops.py refuses it
                raise ValueError(
                    "Adasum does not support sparse (IndexedSlices) "
                    "gradients; use sparse_as_dense=True or op=Average/Sum.")
            else:
                # the mean over the micro-batches, then the rows of all ranks
                p.grad = to_coo(allreduce_sparse(
                    from_coo(p.grad), self.op, prescale_factor=1.0 / k))
        if not dense:
            return
        wire, ctxs = zip(*(self.compression.compress(g) for g in grads))
        reduced = [self.compression.decompress(r, c)
                   for r, c in zip(self._reduce(wire, k), ctxs)]
        for p, g, r in zip(dense, grads, reduced):
            if g is p.grad:
                p.grad.copy_(r)
            else:
                p.grad = r

    def _reduce(self, wire, k: int) -> list:
        """The reduction of the wire tensors, the mean over ``k``
        accumulated micro-batches (every reduction here is homogeneous of
        degree 1, so the scale goes first)."""
        if self.hierarchical_axes is not None:
            if self.gradient_predivide_factor != 1.0:
                raise ValueError(
                    "gradient_predivide_factor is a flat-psum knob; the "
                    "hierarchical schedule applies its averaging once after "
                    "the cross-fabric phase")
            from ..parallel.hierarchical import (  # noqa: PLC0415
                hierarchical_adasum,
                hierarchical_allreduce,
            )

            local_ax, cross_ax = self.hierarchical_axes
            if k != 1:
                wire = [w / k for w in wire]
            if self.op == Adasum:
                return [hierarchical_adasum(w, local_axis=local_ax,
                                            cross_axis=cross_ax)
                        for w in wire]
            return [hierarchical_allreduce(
                w, self.op, local_axis=local_ax, cross_axis=cross_ax,
                compression=self.dcn_compression) for w in wire]
        op, pre, post = self.op, 1.0, 1.0
        if self.op == Average and self.gradient_predivide_factor != 1.0:
            op = Sum
            pre = 1.0 / self.gradient_predivide_factor
            post = self.gradient_predivide_factor / global_topology().process_count
        # mean over the accumulated micro-batches (allreduce is linear)
        pre /= k
        return grouped_allreduce(wire, op, prescale_factor=pre,
                                 postscale_factor=post)

    def step(self, closure=None):
        self._passes += 1
        if self._passes < self.backward_passes_per_step:
            return None
        self._passes = 0
        self.synchronize()
        return self.optimizer.step(closure)


def _named_tensors(params) -> list:
    if isinstance(params, Mapping):
        return sorted(params.items())
    return list(params)


def broadcast_parameters(
    params: Union[Mapping[str, torch.Tensor], Iterable], root_rank: int = 0,
):
    """Overwrite ``params`` in place with ``root_rank``'s values.

    ``params`` is a ``state_dict()`` or an iterable of ``(name, tensor)``
    pairs such as ``named_parameters()``; returns it.  A world of one
    returns it unchanged, as the reference does.
    """
    if global_topology().process_count == 1:
        return params
    with torch.no_grad():
        for _, t in _named_tensors(params):
            _broadcast_inplace(t, root_rank)
    return params


def _broadcast_inplace(t: torch.Tensor, root_rank: int) -> None:
    dev = global_topology().device
    buf = t if (t.device == dev and t.is_contiguous()) else \
        t.detach().to(dev).contiguous()
    dist.broadcast(buf, src=root_rank)
    if buf is not t:
        t.copy_(buf)


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Make every rank's optimizer state ``root_rank``'s, in place.

    The root's state layout (keys, shapes, dtypes and non-tensor values)
    travels by :func:`broadcast_object`; ranks allocate the tensors they
    lack, then every tensor is broadcast in the fixed order of the
    parameters.  A ZeRO-1 plan (``optim.overlap.OverlapPlan`` in mode
    ``bucket+zero1``) is left alone: each rank's state is its own shard.
    """
    if getattr(optimizer, "sharded_state", False) \
            or global_topology().process_count == 1:
        return
    opt = optimizer
    while hasattr(opt, "optimizer"):  # DistributedOptimizer, OverlapPlan
        opt = opt.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    layout = broadcast_object(
        [
            {
                key: (("tensor", tuple(val.shape), val.dtype)
                      if torch.is_tensor(val) else ("value", val))
                for key, val in opt.state.get(p, {}).items()
            }
            for p in params
        ],
        root_rank,
    )
    for p, entries in zip(params, layout):
        state = opt.state[p]
        for key, (kind, *rest) in entries.items():
            if kind == "value":
                state[key] = rest[0]
                continue
            shape, dtype = rest
            cur = state.get(key)
            if not torch.is_tensor(cur) or tuple(cur.shape) != shape \
                    or cur.dtype != dtype:
                device = p.device if shape else torch.device("cpu")
                state[key] = torch.zeros(shape, dtype=dtype, device=device)
            _broadcast_inplace(state[key], root_rank)


def broadcast_object(obj: Any, root_rank: int = 0) -> Any:
    """Pickle-broadcast a Python object from ``root_rank``."""
    if global_topology().process_count == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root_rank)
    return box[0]
