"""Collectives with Horovod's autodiff rules (counterpart of
``horovod_tpu/ops/collectives.py``), over the ``torch.distributed``
default process group: NCCL on CUDA, gloo on the CPU.

Each op is a ``torch.autograd.Function`` with the reference's backward
rule (horovod/torch/mpi_ops.py and ``horovod_tpu/ops/collectives.py``):

* allreduce (Sum/Average)  backward = allreduce of the cotangent with the
  same op; Min/Max have no gradient (``lax.pmin``/``pmax`` have none), so
  their backward raises;
* broadcast  backward = the cotangents summed onto the root, zero
  elsewhere;
* allgather  backward = reduce-scatter (sum) of the cotangent, each rank
  keeping the rows it contributed;
* reducescatter  backward = allgather of the cotangent;
* alltoall  backward = alltoall of the cotangent;
* the flat pair ``reduce_scatter_flat`` / ``all_gather_flat``: each is the
  other's backward (the ZeRO-1 building blocks of ``optim/overlap.py``).

``Average`` is Sum then divide by the world size, after the collective, as
in the reference.  The ops run eagerly, so allgather takes a ragged dim 0
(the sizes are exchanged, the rows padded, gathered and sliced) and
reducescatter a dim 0 the world does not divide (the first
``dim0 % world`` ranks get one row more), as the reference's eager path
does.

``op=Adasum`` reduces each tensor on its own through ``ops/adasum.py``
(never a fused buffer: its projection coefficients are per tensor).  An
:class:`~horovod_tpu_torch.ops.sparse.IndexedSlices` takes the sparse path
(``ops/sparse.py``).  ``allreduce_`` and ``broadcast_`` write the result
into their argument, as Horovod's torch API does.

The flat pair and the row helpers take a ``group`` (a subgroup of the
world: the two-level schedules of ``parallel/hierarchical.py``); inside a
group, ranks are the group's.

The axis collectives at the end are the reference's ``lax`` primitives
over a named axis (``basics.init_axes``) or a process group, for the
parallel schedules (``parallel/``), each with JAX's transpose:

* :func:`ring_shift` (``lax.ppermute`` over the ring ``j -> j + shift``)
  backward = the shift the other way;
* :func:`all_to_all` (``lax.all_to_all``, tiled or not) backward = the
  inverse exchange;
* :func:`psum` / :func:`pmean` and :func:`pvary`: a sum whose result is
  replicated, whose backward passes the cotangent through (``/ n`` for
  the mean), and the identity whose backward sums the cotangents over the
  axis.  They are Megatron's *g* and *f*, and the transposes JAX gives
  ``psum`` and its implicit ``pvary`` under replication tracking
  (``check_vma=True``).  Where a reduced value feeds every rank's own
  loss (JAX's transpose without replication tracking: ``psum``'s is
  ``psum``), compose ``pvary(psum(x))``.

On an axis of size 1 each is the identity and issues no collective.
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..basics import DP_AXIS, rank as _rank, size as _size
from ..utils import env as envmod

__all__ = [
    "ReduceOp",
    "Average",
    "Sum",
    "Adasum",
    "Min",
    "Max",
    "allreduce",
    "allreduce_",
    "grouped_allreduce",
    "broadcast",
    "broadcast_",
    "allgather",
    "alltoall",
    "reducescatter",
    "reduce_scatter_flat",
    "all_gather_flat",
    "ring_shift",
    "all_to_all",
    "psum",
    "pmean",
    "pvary",
    "pmax",
    "axis_rank",
    "axis_size",
]


class ReduceOp(enum.IntEnum):
    """Reduction ops (reference: horovod_reduce_op_{average,sum,adasum})."""

    AVERAGE = 1
    SUM = 2
    ADASUM = 3
    MIN = 4
    MAX = 5


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX


def _group_size(group) -> int:
    return _size() if group is None else dist.get_world_size(group)


def _group_rank(group) -> int:
    return _rank() if group is None else dist.get_rank(group)


def _sum_across(x: torch.Tensor, average: bool, fresh: bool = False,
                group=None) -> torch.Tensor:
    """The sum (or mean) over the world, or over ``group``; reduces ``x``
    itself when it is a ``fresh`` contiguous buffer no one else holds, else
    a copy."""
    y = x if fresh else x.detach().clone(
        memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    if average:
        y.div_(_group_size(group))
    return y


class _AllreduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, average, fresh, group=None):
        ctx.average, ctx.group = average, group
        if fresh:
            ctx.mark_dirty(x)
        return _sum_across(x, average, fresh, group)

    @staticmethod
    def backward(ctx, g):
        # reference rule: backward of allreduce is allreduce with the same op
        return _sum_across(g, ctx.average, group=ctx.group), None, None, None


class _AllreduceExtreme(torch.autograd.Function):
    """Min / Max across the world: no gradient, as ``lax.pmin``/``pmax``
    have no differentiation rule."""

    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=(dist.ReduceOp.MIN if op == Min
                               else dist.ReduceOp.MAX))
        return y

    @staticmethod
    def backward(ctx, g):
        prim = "pmin" if ctx.op == Min else "pmax"
        raise NotImplementedError(
            f"Differentiation rule for '{prim}' not implemented (allreduce "
            f"with op={ctx.op.name} has no gradient, as in the reference)")


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, root_rank):
        ctx.root_rank = root_rank
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(y, src=root_rank)
        return y

    @staticmethod
    def backward(ctx, g):
        # reference rule: sum cotangents to the root, zeros elsewhere
        summed = _sum_across(g, average=False)
        if _rank() != ctx.root_rank:
            summed.zero_()
        return summed, None


def allreduce(
    tensor,
    op: ReduceOp = Average,
    *,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    name: Optional[str] = None,
):
    """Allreduce across the world (reference: hvd.allreduce).  Returns a
    new tensor; differentiable.  An ``IndexedSlices`` is allgathered
    (:func:`~horovod_tpu_torch.ops.sparse.allreduce_sparse`)."""
    from .sparse import IndexedSlices, allreduce_sparse  # noqa: PLC0415

    if isinstance(tensor, IndexedSlices):
        return allreduce_sparse(tensor, op, prescale_factor=prescale_factor,
                                postscale_factor=postscale_factor)
    del name  # the world reduces in program order; no negotiation by name
    return _allreduce(tensor, op, prescale_factor, postscale_factor,
                      fresh=False)


def allreduce_(tensor: torch.Tensor, op: ReduceOp = Average,
               **kwargs) -> torch.Tensor:
    """:func:`allreduce` written into ``tensor`` itself, which it returns
    (Horovod's torch ``allreduce_``); not differentiable."""
    with torch.no_grad():
        tensor.copy_(allreduce(tensor, op, **kwargs))
    return tensor


def _allreduce(tensor, op, prescale_factor, postscale_factor, fresh,
               group=None):
    """:func:`allreduce` (over ``group``, the world by default); ``fresh``
    says ``tensor`` is a contiguous buffer the caller built for this
    reduce, which may be reduced in place."""
    if op not in (Average, Sum, Min, Max, Adasum):
        raise ValueError(f"unsupported reduce op {op!r}")
    if prescale_factor != 1.0:
        tensor, fresh = tensor * prescale_factor, True
    if op == Adasum:
        from .adasum import adasum_allreduce  # noqa: PLC0415

        y = adasum_allreduce(tensor, group=group)
    elif op in (Min, Max):
        if group is not None:
            raise ValueError("Min/Max reduce over the world only")
        y = _AllreduceExtreme.apply(tensor, op)
    else:
        y = _AllreduceSum.apply(tensor, op == Average, fresh, group)
    return y * postscale_factor if postscale_factor != 1.0 else y


def grouped_allreduce(
    tensors: Sequence[torch.Tensor],
    op: ReduceOp = Average,
    *,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    fusion_threshold_bytes: Optional[int] = None,
    group=None,
) -> list:
    """Fused allreduce of a list of tensors through flat buffers, over
    ``group`` (the world by default).

    Like the reference's tensor fusion, tensors are fused only with others
    of their dtype, into bins of at most ``fusion_threshold_bytes``
    (``HVDTPU_FUSION_THRESHOLD``, default 64 MB); a tensor larger than the
    threshold gets a bin of its own.  One allreduce per bin, in the order
    of the list.  Adasum fuses nothing: each tensor is reduced on its own,
    with its own projection coefficients.  Differentiable.
    """
    tensors = list(tensors)
    if not tensors:
        return []
    if fusion_threshold_bytes is None:
        fusion_threshold_bytes = envmod.env_int(
            envmod.FUSION_THRESHOLD, envmod.DEFAULT_FUSION_BYTES
        )
    out: list = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    scales = (prescale_factor, postscale_factor)

    def reduce_bin(idxs):
        if len(idxs) == 1:
            out[idxs[0]] = _allreduce(tensors[idxs[0]], op, *scales,
                                      fresh=False, group=group)
            return
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        reduced = _allreduce(flat, op, *scales, fresh=True, group=group)
        parts = reduced.split([tensors[i].numel() for i in idxs])
        for i, part in zip(idxs, parts):
            out[i] = part.view(tensors[i].shape)

    if op == Adasum:
        return [_allreduce(t, op, *scales, fresh=False, group=group)
                for t in tensors]
    for dtype, idxs in by_dtype.items():
        itemsize = torch.empty((), dtype=dtype).element_size()
        bin_idxs: list = []
        bin_bytes = 0
        for i in idxs:
            nbytes = tensors[i].numel() * itemsize
            if bin_idxs and bin_bytes + nbytes > fusion_threshold_bytes:
                reduce_bin(bin_idxs)
                bin_idxs, bin_bytes = [], 0
            bin_idxs.append(i)
            bin_bytes += nbytes
        if bin_idxs:
            reduce_bin(bin_idxs)
    return out


def broadcast(tensor: torch.Tensor, root_rank: int, *,
              name: Optional[str] = None) -> torch.Tensor:
    """The root's value on every rank (reference: hvd.broadcast).  Returns
    a new tensor; differentiable."""
    del name
    return _Broadcast.apply(tensor, root_rank)


def broadcast_(tensor: torch.Tensor, root_rank: int, *,
               name: Optional[str] = None) -> torch.Tensor:
    """:func:`broadcast` written into ``tensor`` itself, which it returns
    (Horovod's torch ``broadcast_``); not differentiable."""
    with torch.no_grad():
        tensor.copy_(broadcast(tensor, root_rank, name=name))
    return tensor


# ---------------------------------------------------------------------------
# allgather, reducescatter and the flat pair: rows gathered or
# reduce-scattered by rank, each the other's backward
# ---------------------------------------------------------------------------

# the single-tensor collectives under the names the installed torch has
# (all_gather_into_tensor / reduce_scatter_tensor before the renaming)
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _even_rows(n: int, world: int) -> list:
    """Rows per rank of a dim 0 of ``n``: the first ``n % world`` ranks get
    one more (the reference's eager convention)."""
    return [n // world + (r < n % world) for r in range(world)]


def _padded(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` contiguous, zero-padded along dim 0 to ``rows``."""
    if x.shape[0] == rows:
        return x.contiguous()
    out = x.new_zeros((rows,) + tuple(x.shape[1:]))
    out[:x.shape[0]] = x
    return out


def _gather_rows(x: torch.Tensor, sizes, group=None) -> torch.Tensor:
    """Every rank's rows (``sizes[r]`` of them from rank r of ``group``, the
    world by default), concatenated in rank order."""
    m = max(sizes)
    buf = x.new_empty((len(sizes) * m,) + tuple(x.shape[1:]))
    _all_gather_single(buf, _padded(x, m), group=group)
    if all(n == m for n in sizes):
        return buf
    return torch.cat([buf[r * m:r * m + n] for r, n in enumerate(sizes)])


def _scatter_rows(x: torch.Tensor, sizes, group=None) -> torch.Tensor:
    """The sum over ``group`` (the world by default) of ``x``'s rows, split
    ``sizes`` by rank of the group; this rank's part."""
    m = max(sizes)
    if all(n == m for n in sizes):
        buf = x.contiguous()
    else:
        buf = x.new_zeros((len(sizes) * m,) + tuple(x.shape[1:]))
        off = 0
        for r, n in enumerate(sizes):
            buf[r * m:r * m + n] = x[off:off + n]
            off += n
    out = x.new_empty((m,) + tuple(x.shape[1:]))
    _reduce_scatter_single(out, buf, group=group)
    return out[:sizes[_group_rank(group)]]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sizes, group=None):
        ctx.sizes, ctx.group = sizes, group
        return _gather_rows(x.detach(), sizes, group)

    @staticmethod
    def backward(ctx, g):
        # reference rule: reduce the gathered cotangent, keep own rows
        return _scatter_rows(g, ctx.sizes, ctx.group), None, None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sizes, group=None):
        ctx.sizes, ctx.group = sizes, group
        return _scatter_rows(x.detach(), sizes, group)

    @staticmethod
    def backward(ctx, g):
        # every rank's rows weigh 1 in every sum: gather the cotangents
        return _gather_rows(g, ctx.sizes, ctx.group), None, None


def _check_sum_or_average(op: ReduceOp, what: str) -> None:
    if op not in (Sum, Average):
        raise ValueError(f"{what} supports Sum/Average, got {op!r}")


def _average_after(y: torch.Tensor, op: ReduceOp,
                   group=None) -> torch.Tensor:
    """Average divides after the collective, as the reference does."""
    return y / _group_size(group) if op == Average else y


def allgather(tensor: torch.Tensor, *,
              name: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along dim 0 in rank order
    (reference: hvd.allgather).  Dim 0 may differ across ranks; the other
    dims may not.  Differentiable."""
    del name
    mine = torch.tensor([tensor.shape[0]], dtype=torch.int64,
                        device=tensor.device)
    sizes = mine.new_empty(_size())
    _all_gather_single(sizes, mine)
    return _GatherRows.apply(tensor, [int(n) for n in sizes.tolist()])


def reducescatter(tensor: torch.Tensor, op: ReduceOp = Average, *,
                  name: Optional[str] = None) -> torch.Tensor:
    """The sum (or mean) over the world, and this rank's slice of dim 0:
    with a dim 0 the world does not divide, the first ``dim0 % world``
    ranks get one row more.  Sum and Average only.  Differentiable."""
    del name
    _check_sum_or_average(op, "reducescatter")
    y = _ScatterRows.apply(tensor, _even_rows(tensor.shape[0], _size()))
    return _average_after(y, op)


def alltoall(tensor: torch.Tensor, *,
             name: Optional[str] = None) -> torch.Tensor:
    """Split dim 0 into ``world`` chunks, send chunk j to rank j, and
    concatenate the chunks received in rank order.  Dim 0 must divide by
    the world size.  Differentiable."""
    del name
    n = _size()
    if tensor.shape[0] % n:
        raise ValueError(
            f"alltoall dim0 ({tensor.shape[0]}) must divide the axis size "
            f"({n})")
    return _AllToAll.apply(tensor)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.detach().contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out

    @staticmethod
    def backward(ctx, g):
        # the exchange is its own transpose
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g)
        return out


def _flat_rows(flat: torch.Tensor, world: int, what: str) -> list:
    if flat.dim() != 1 or flat.shape[0] % world:
        raise ValueError(
            f"{what} takes a 1-D buffer whose length divides the world "
            f"size ({world}); got shape {tuple(flat.shape)} (pad first)")
    return [flat.shape[0] // world] * world


def reduce_scatter_flat(flat: torch.Tensor, op: ReduceOp = Sum, *,
                        group=None) -> torch.Tensor:
    """Reduce a 1-D buffer across the world (or ``group``) and keep this
    rank's tiled chunk (the length must divide the group's size).  Its
    backward is :func:`all_gather_flat` of the cotangent."""
    _check_sum_or_average(op, "reduce_scatter_flat")
    sizes = _flat_rows(flat, _group_size(group), "reduce_scatter_flat")
    return _average_after(_ScatterRows.apply(flat, sizes, group), op, group)


def all_gather_flat(shard: torch.Tensor, *, group=None) -> torch.Tensor:
    """Concatenate every rank's 1-D shard, in rank order of the world (or
    ``group``): the inverse of :func:`reduce_scatter_flat`'s slicing.  Its
    backward is the reduce-scatter (sum) of the cotangent."""
    if shard.dim() != 1:
        raise ValueError(
            f"all_gather_flat takes a 1-D shard, got {tuple(shard.shape)}")
    return _GatherRows.apply(shard, [shard.shape[0]] * _group_size(group),
                             group)


def allreduce_group(tensor: torch.Tensor, op: ReduceOp = Sum, *,
                    group=None) -> torch.Tensor:
    """Sum (or mean) over ``group`` (the world by default); its backward is
    the same reduce of the cotangent."""
    _check_sum_or_average(op, "allreduce_group")
    return _AllreduceSum.apply(tensor, op == Average, False, group)


# ---------------------------------------------------------------------------
# axis collectives: the reference's lax primitives over a named axis or a
# process group (see the module docstring)
# ---------------------------------------------------------------------------


def _axis(axis):
    """``(group, size, index)`` of ``axis``: a name of ``basics.init_axes``,
    a reserved axis name, or a process group."""
    from .. import basics  # noqa: PLC0415

    group = basics.group_of_axis(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def axis_rank(axis_name: str = DP_AXIS) -> int:
    """This rank's index along ``axis_name``: its rank in the axis's
    process group (reference ``lax.axis_index``)."""
    return _axis(axis_name)[2]


def axis_size(axis_name: str = DP_AXIS) -> int:
    """The width of ``axis_name``: its process group's size (reference
    ``lax.axis_size``)."""
    return _axis(axis_name)[1]


def _shift(x: torch.Tensor, group, n: int, me: int,
           shift: int) -> torch.Tensor:
    """Send ``x`` to group rank ``me + shift`` and receive from ``me -
    shift`` (mod ``n``), both posted together so a ring cannot deadlock."""
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dst, group=group),
        dist.P2POp(dist.irecv, out, src, group=group),
    ])
    for req in reqs:
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, shift):
        ctx.args = (group, n, me)
        ctx.shift = shift
        return _shift(x, group, n, me, shift)

    @staticmethod
    def backward(ctx, g):
        # ppermute's transpose: the cotangent goes back the way it came
        return _shift(g, *ctx.args, -ctx.shift), None, None, None, None


def ring_shift(x: torch.Tensor, axis, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute(x, axis, [(j, (j + shift) % n) for j in range(n)])``:
    every rank sends ``x`` to its ``shift``-th successor along ``axis`` and
    returns what its predecessor sent.  Differentiable."""
    group, n, me = _axis(axis)
    if n == 1 or shift % n == 0:
        return x
    return _RingShift.apply(x, group, n, me, shift)


def _exchange(x: torch.Tensor, group, n: int, split_axis: int,
              concat_axis: int, tiled: bool) -> torch.Tensor:
    """``lax.all_to_all``: ``x`` split into ``n`` chunks along
    ``split_axis``, chunk j to group rank j, the chunks received
    concatenated in rank order along ``concat_axis`` (tiled) or, untiled,
    stacked there in place of the split dim (``x.shape[split_axis] ==
    n``)."""
    if tiled:
        if x.shape[split_axis] % n:
            raise ValueError(
                f"all_to_all: dim {split_axis} ({x.shape[split_axis]}) does "
                f"not divide the axis size ({n})")
        parts = x.detach().chunk(n, dim=split_axis)
    else:
        if x.shape[split_axis] != n:
            raise ValueError(
                f"all_to_all(tiled=False): dim {split_axis} "
                f"({x.shape[split_axis]}) must equal the axis size ({n})")
        parts = x.detach().unbind(split_axis)
    send = torch.stack([p.contiguous() for p in parts])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if tiled:
        return torch.cat(recv.unbind(0), dim=concat_axis)
    return torch.stack(recv.unbind(0), dim=concat_axis)


class _AllToAllAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis, tiled):
        ctx.args = (group, n, concat_axis, split_axis, tiled)
        return _exchange(x, group, n, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        # the inverse exchange: split where the forward concatenated
        return (_exchange(g, *ctx.args), None, None, None, None, None)


def all_to_all(x: torch.Tensor, axis, split_axis: int, concat_axis: int,
               *, tiled: bool = True) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=tiled)``
    over ``axis``.  Differentiable; its backward is the inverse
    exchange."""
    group, n, _ = _axis(axis)
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if n == 1:
        if tiled:
            return x
        return x.movedim(split_axis, concat_axis)
    return _AllToAllAxis.apply(x, group, n, split_axis, concat_axis, tiled)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, mean):
        ctx.scale = 1.0 / n if mean else None
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y / n if mean else y

    @staticmethod
    def backward(ctx, g):
        # the result is replicated and counted once: each rank's input
        # takes the cotangent as it stands (Megatron's g)
        return (g if ctx.scale is None else g * ctx.scale), None, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a replicated value used by every rank's own computation: its
        # cotangent is the sum of theirs (Megatron's f)
        g = g.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum over ``axis``, replicated on every rank of it; the backward
    passes the cotangent through (``lax.psum`` under replication
    tracking; Megatron's row-parallel rejoin)."""
    group, n, _ = _axis(axis)
    return x if n == 1 else _Psum.apply(x, group, n, False)


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    """Mean over ``axis``; the backward scales the cotangent by ``1 /
    n``."""
    group, n, _ = _axis(axis)
    return x if n == 1 else _Psum.apply(x, group, n, True)


def pvary(x: torch.Tensor, axis) -> torch.Tensor:
    """The identity, whose backward sums the cotangent over ``axis``: mark
    a replicated value entering each rank's own computation (JAX's
    implicit ``pvary``; Megatron's column-parallel entry)."""
    group, n, _ = _axis(axis)
    return x if n == 1 else _Pvary.apply(x, group)


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """Elementwise maximum over ``axis`` (``lax.pmax``); no gradient."""
    group, n, _ = _axis(axis)
    if n == 1:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y
