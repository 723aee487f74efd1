"""Data-parallel optimizer and the SPMD training surface (counterpart of
``horovod_tpu/optim/__init__.py``; reference: hvd.DistributedOptimizer and
the broadcast helpers of horovod/torch/__init__.py).

:func:`DistributedGradientTransform` is the reference's gradient
transform: ``update(grads, state)`` reduces a pytree of gradients across
the ranks of an axis — dense leaves through one :func:`grouped_allreduce`
that fuses them per dtype, ``op=Adasum`` each on its own, sparse leaves
(an ``IndexedSlices`` or the COO ``.grad`` of ``nn.Embedding(sparse=True)``)
made dense first (``sparse_as_dense``) or allgathered, and the two-level
schedule with ``hierarchical_axes`` / ``dcn_compression``.
:class:`DistributedOptimizer` wraps any ``torch.optim.Optimizer``: at
``step()`` it reduces the gradients through the same code (:class:`_Reduce`)
in the fixed order of the optimizer's parameters, then steps the wrapped
optimizer, so every rank steps with the same reduced gradients.

:func:`distribute` is the reference's ``shard_map`` wrapper on process
groups: each rank runs the step on its block of the batch (``P(axis)``
arguments) and gets the global array back for outputs whose spec names an
axis.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Mapping, NamedTuple, Union

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from ..basics import DP_AXIS, global_topology, group_of_axis, \
    mesh as build_mesh
from ..ops.collectives import Adasum, Average, ReduceOp, Sum, axis_size, \
    grouped_allreduce
from ..obs.trace import phase
from ..ops.compression import Compression
from ..ops.sparse import IndexedSlices, allreduce_sparse, from_coo, to_coo, \
    to_dense
from .overlap import sync_gradients

__all__ = [
    "DistributedOptimizer",
    "DistributedGradientTransform",
    "GradientTransformation",
    "EmptyState",
    "P",
    "distribute",
    "sync_gradients",
    "broadcast_parameters",
    "broadcast_optimizer_state",
    "broadcast_object",
]


class GradientTransformation(NamedTuple):
    """``(init, update)``, optax's pair: ``init(params)`` makes the state,
    ``update(grads, state, params=None)`` returns ``(new_grads, state)``."""

    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    """The state of a transform that keeps none (optax's EmptyState)."""


def _is_sparse(leaf) -> bool:
    return isinstance(leaf, IndexedSlices) or (
        torch.is_tensor(leaf) and leaf.is_sparse)


class _Reduce:
    """The gradient reduction :func:`DistributedGradientTransform` and
    :class:`DistributedOptimizer` share (reference
    horovod_tpu/optim/__init__.py:60-222): validated once, applied to a
    list of gradient leaves by :meth:`__call__`."""

    def __init__(self, op, *, axis_name=DP_AXIS,
                 compression=Compression.none,
                 gradient_predivide_factor: float = 1.0,
                 sparse_as_dense: bool = True, hierarchical_axes=None,
                 dcn_compression=None, what="DistributedGradientTransform"):
        if op not in (Average, Sum, Adasum):
            raise ValueError(
                f"{what} supports Average/Sum/Adasum, got {op!r}")
        if hierarchical_axes is not None and len(hierarchical_axes) != 2:
            raise ValueError(
                "hierarchical_axes must be (local_axis, cross_axis), got "
                f"{hierarchical_axes!r}")
        # gradient_predivide_factor x hierarchical is refused at the first
        # reduce, where the schedule is used, not here (as the reference)
        self.op = op
        self.axis_name = axis_name
        self.compression = compression
        self.gradient_predivide_factor = gradient_predivide_factor
        self.sparse_as_dense = sparse_as_dense
        self.hierarchical_axes = (tuple(hierarchical_axes)
                                  if hierarchical_axes else None)
        self.dcn_compression = dcn_compression

    def __call__(self, leaves: list, k: int = 1) -> list:
        """The reduced leaves, each of its input's kind: a dense tensor, or
        a sparse leaf allgathered (an ``IndexedSlices`` stays one, a COO
        tensor comes back COO) unless ``sparse_as_dense`` made it dense.
        Each is first divided by ``k``, the mean over ``k`` accumulated
        micro-batches (every reduction here is homogeneous of degree
        1)."""
        out = list(leaves)
        dense_idx, dense = [], []
        for i, leaf in enumerate(leaves):
            if not _is_sparse(leaf):
                dense_idx.append(i)
                dense.append(leaf)
                continue
            slices = leaf if isinstance(leaf, IndexedSlices) else \
                from_coo(leaf)
            if self.sparse_as_dense:
                dense_idx.append(i)
                dense.append(to_dense(slices))
            elif self.op == Adasum:
                # reference parity: horovod/torch/mpi_ops.py refuses it
                raise ValueError(
                    "Adasum does not support sparse (IndexedSlices) "
                    "gradients; use sparse_as_dense=True or op=Average/Sum.")
            else:
                if group_of_axis(self.axis_name) is not dist.group.WORLD:
                    raise ValueError("sparse gradients reduce over the "
                                     "world (DP_AXIS) only")
                # every rank's rows (the mean over micro-batches first)
                red = allreduce_sparse(slices, self.op,
                                       prescale_factor=1.0 / k)
                out[i] = red if isinstance(leaf, IndexedSlices) else \
                    to_coo(red)
        if dense:
            wire, ctxs = zip(*(self.compression.compress(g) for g in dense))
            for i, r, c in zip(dense_idx, self._dense(list(wire), k), ctxs):
                out[i] = self.compression.decompress(r, c)
        return out

    def _dense(self, wire: list, k: int) -> list:
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
            # average = (1/f) before the wire, (f/N) after
            op = Sum
            pre = 1.0 / self.gradient_predivide_factor
            post = self.gradient_predivide_factor / axis_size(self.axis_name)
        pre /= k
        group = group_of_axis(self.axis_name)
        return grouped_allreduce(
            wire, op, prescale_factor=pre, postscale_factor=post,
            group=None if group is dist.group.WORLD else group)


def DistributedGradientTransform(
    op: ReduceOp = Average,
    *,
    axis_name: str = DP_AXIS,
    compression=Compression.none,
    gradient_predivide_factor: float = 1.0,
    groups=None,
    sparse_as_dense: bool = True,
    hierarchical_axes=None,
    dcn_compression=None,
) -> GradientTransformation:
    """A gradient transform that reduces the gradients across
    ``axis_name``'s ranks (reference ``hvd.DistributedGradientTransform``).
    Put it in front of the optimizer: ``grads, state = tx.update(grads,
    state)``, then write ``grads`` into the parameters' ``.grad`` and step.

    ``compression`` casts each gradient to its wire dtype around the
    reduce.  ``gradient_predivide_factor`` f splits Average into a
    pre-scale 1/f and a post-scale f/N.  ``groups`` is accepted for the
    reference's signature; the fusion is the port's (one reduce per dtype
    up to ``HVDTPU_FUSION_THRESHOLD``).  A sparse leaf (``IndexedSlices``
    or a COO tensor) is made dense first with ``sparse_as_dense``, else
    allgathered and left sparse (Adasum refuses it).
    ``hierarchical_axes=(LOCAL_AXIS, CROSS_AXIS)`` reduces each gradient
    by the two-level schedule, ``dcn_compression`` casting its cross leg;
    with a ``gradient_predivide_factor`` other than 1 that raises at the
    first ``update``.  Pytrees are dicts, lists and tuples of leaves
    (``torch.utils._pytree``)."""
    del groups
    reduce = _Reduce(op, axis_name=axis_name, compression=compression,
                     gradient_predivide_factor=gradient_predivide_factor,
                     sparse_as_dense=sparse_as_dense,
                     hierarchical_axes=hierarchical_axes,
                     dcn_compression=dcn_compression)

    def init_fn(params):
        del params
        return EmptyState()

    def update_fn(updates, state, params=None):
        del params
        leaves, spec = pytree.tree_flatten(updates, is_leaf=_is_sparse)
        return pytree.tree_unflatten(reduce(leaves), spec), state

    return GradientTransformation(init_fn, update_fn)


class DistributedOptimizer:
    """Wrap ``optimizer`` so its updates see globally reduced gradients.

    The reduction is :func:`DistributedGradientTransform`'s, over
    ``axis_name``, with the same ``op``, ``compression``,
    ``gradient_predivide_factor``, ``sparse_as_dense``,
    ``hierarchical_axes`` and ``dcn_compression``.
    ``backward_passes_per_step`` k accumulates k micro-batches before one
    reduce and one update, like the reference's ``optax.MultiSteps``:
    ``step()`` counts calls and acts on every k-th, using the mean of the k
    accumulated gradients, and ``zero_grad()`` keeps the gradients while an
    accumulation is open.  A sparse gradient left sparse
    (``sparse_as_dense=False``) comes back as an uncoalesced COO ``.grad``
    for the optimizer's scatter-add (``torch.optim.SGD`` takes one,
    ``AdamW`` does not).  ``step()`` runs the reduction in the span
    ``phase("grad_reduce")`` and the wrapped step in ``phase("optimizer")``
    (``obs/trace.py``).
    """

    def __init__(
        self,
        optimizer: torch.optim.Optimizer,
        *,
        op: ReduceOp = Average,
        axis_name: str = DP_AXIS,
        compression=Compression.none,
        backward_passes_per_step: int = 1,
        gradient_predivide_factor: float = 1.0,
        sparse_as_dense: bool = True,
        hierarchical_axes=None,
        dcn_compression=None,
    ):
        self._reduce = _Reduce(
            op, axis_name=axis_name, compression=compression,
            gradient_predivide_factor=gradient_predivide_factor,
            sparse_as_dense=sparse_as_dense,
            hierarchical_axes=hierarchical_axes,
            dcn_compression=dcn_compression, what="DistributedOptimizer")
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self.backward_passes_per_step = backward_passes_per_step
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
        grads = [p.grad for p in params]
        reduced = self._reduce(grads, self.backward_passes_per_step)
        for p, g, r in zip(params, grads, reduced):
            if g.is_sparse or r.is_sparse:
                p.grad = r
            else:
                p.grad.copy_(r)

    def step(self, closure=None):
        self._passes += 1
        if self._passes < self.backward_passes_per_step:
            return None
        self._passes = 0
        with phase("grad_reduce"):
            self.synchronize()
        with phase("optimizer"):
            return self.optimizer.step(closure)


class P(tuple):
    """A partition spec (the reference's ``jax.sharding.PartitionSpec``):
    one entry per leading dimension, ``None`` or an axis name (or a tuple
    of names) that splits it.  ``P()`` is replicated; ``P(DP_AXIS)`` splits
    dim 0 over the data-parallel ranks."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def distribute(
    step_fn,
    *,
    mesh_shape: str = "flat",
    axis_name: str = DP_AXIS,
    in_specs=None,
    out_specs=None,
    donate_argnums=(),
):
    """Wrap a per-rank step as the reference's SPMD program over the job's
    mesh (reference ``hvd.distribute``: ``shard_map`` + ``jit``), on
    process groups: every rank runs ``step_fn`` on its own block of each
    argument whose spec names an axis — the contiguous block of dim 0
    that its index along the axis selects — and an output whose spec
    names an axis is allgathered back along it, so the caller sees the
    global array, as ``shard_map`` gives it.  Replicated (``P()``)
    arguments and outputs pass through as they are.

    With specs omitted, every argument is replicated except the LAST,
    which is split along dim 0 over ``axis_name`` (the batch); outputs are
    replicated.  A spec is a :class:`P` for a whole argument, or a dict,
    list or tuple of them matching its structure.  A dimension the axis
    does not divide raises ``ValueError``.  ``donate_argnums`` is accepted
    for the reference's signature and has no effect: eager torch frees a
    buffer when its last reference goes.  Call it after ``init()``: the
    mesh is built here.
    """
    del donate_argnums
    m = build_mesh(mesh_shape)

    def wrapper(*args):
        specs = (in_specs if in_specs is not None
                 else (P(),) * (len(args) - 1) + (P(axis_name),))
        if len(specs) != len(args):
            raise ValueError(f"{len(specs)} in_specs for {len(args)} "
                             f"arguments")
        local = [_map_spec(spec, arg, lambda x, sp: _block(m, x, sp))
                 for spec, arg in zip(specs, args)]
        out = step_fn(*local)
        return _map_spec(P() if out_specs is None else out_specs, out,
                         lambda x, sp: _gather(m, x, sp))

    return wrapper


def _map_spec(spec, tree, fn):
    """``fn(leaf, P)`` over ``tree``, a :class:`P` applying to every leaf
    below it (a prefix of the tree, as ``shard_map``'s specs)."""
    if spec is None or isinstance(spec, P):
        spec = P() if spec is None else spec
        return pytree.tree_map(lambda x: fn(x, spec), tree)
    if isinstance(spec, Mapping):
        return type(tree)((k, _map_spec(spec[k], v, fn))
                          for k, v in tree.items())
    if len(spec) != len(tree):
        raise ValueError(f"spec {spec!r} does not match {type(tree)} of "
                         f"{len(tree)}")
    parts = [_map_spec(sp, t, fn) for sp, t in zip(spec, tree)]
    return type(tree)(*parts) if hasattr(tree, "_fields") else \
        type(tree)(parts)


def _spec_axes(m, entry) -> list:
    """``[(group, size, index)]`` of a spec entry's axes, outermost first."""
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    out = []
    for name in names:
        if name not in m.mesh_dim_names:
            raise ValueError(f"axis {name!r} is not an axis of the mesh "
                             f"{m.mesh_dim_names}")
        d = m.mesh_dim_names.index(name)
        out.append((m.get_group(name), m.size(d), m.get_local_rank(d)))
    return out


def _block(m, x, spec: P):
    """This rank's block of ``x`` under ``spec``."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n, index = 1, 0
        for _, size, i in _spec_axes(m, entry):
            n, index = n * size, index * size + i
        if not torch.is_tensor(x) or x.dim() <= dim or x.shape[dim] % n:
            raise ValueError(
                f"cannot split dim {dim} of "
                f"{tuple(x.shape) if torch.is_tensor(x) else type(x)} "
                f"over {entry!r} ({n} ranks)")
        x = x.narrow(dim, index * (x.shape[dim] // n), x.shape[dim] // n)
    return x


@torch.no_grad()
def _gather(m, x, spec: P):
    """The global array of the blocks ``x`` of every rank along ``spec``'s
    axes (the innermost axis first)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for group, size, _ in reversed(_spec_axes(m, entry)):
            if size == 1:
                continue
            parts = [torch.empty_like(x) for _ in range(size)]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts, dim)
    return x


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
