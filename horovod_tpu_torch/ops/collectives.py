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
does.  Adasum is ROADMAP A5.
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..basics import rank as _rank, size as _size
from ..utils import env as envmod

__all__ = [
    "ReduceOp",
    "Average",
    "Sum",
    "Adasum",
    "Min",
    "Max",
    "allreduce",
    "grouped_allreduce",
    "broadcast",
    "allgather",
    "alltoall",
    "reducescatter",
    "reduce_scatter_flat",
    "all_gather_flat",
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


def _sum_across(x: torch.Tensor, average: bool,
                fresh: bool = False) -> torch.Tensor:
    """The sum (or mean) over the world; reduces ``x`` itself when it is a
    ``fresh`` contiguous buffer no one else holds, else a copy."""
    y = x if fresh else x.detach().clone(
        memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM)
    if average:
        y.div_(_size())
    return y


class _AllreduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, average, fresh):
        ctx.average = average
        if fresh:
            ctx.mark_dirty(x)
        return _sum_across(x, average, fresh)

    @staticmethod
    def backward(ctx, g):
        # reference rule: backward of allreduce is allreduce with the same op
        return _sum_across(g, ctx.average), None, None


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
    tensor: torch.Tensor,
    op: ReduceOp = Average,
    *,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    name: Optional[str] = None,
) -> torch.Tensor:
    """Allreduce across the world (reference: hvd.allreduce).  Returns a
    new tensor; differentiable."""
    del name  # the world reduces in program order; no negotiation by name
    return _allreduce(tensor, op, prescale_factor, postscale_factor,
                      fresh=False)


def _allreduce(tensor, op, prescale_factor, postscale_factor, fresh):
    """:func:`allreduce`; ``fresh`` says ``tensor`` is a contiguous buffer
    the caller built for this reduce, which may be reduced in place."""
    if op not in (Average, Sum, Min, Max):
        raise NotImplementedError(
            f"allreduce op {op!r} is not ported yet (ROADMAP A5); "
            "Average, Sum, Min and Max are"
        )
    if prescale_factor != 1.0:
        tensor, fresh = tensor * prescale_factor, True
    if op in (Min, Max):
        y = _AllreduceExtreme.apply(tensor, op)
    else:
        y = _AllreduceSum.apply(tensor, op == Average, fresh)
    return y * postscale_factor if postscale_factor != 1.0 else y


def grouped_allreduce(
    tensors: Sequence[torch.Tensor],
    op: ReduceOp = Average,
    *,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    fusion_threshold_bytes: Optional[int] = None,
) -> list:
    """Fused allreduce of a list of tensors through flat buffers.

    Like the reference's tensor fusion, tensors are fused only with others
    of their dtype, into bins of at most ``fusion_threshold_bytes``
    (``HVDTPU_FUSION_THRESHOLD``, default 64 MB); a tensor larger than the
    threshold gets a bin of its own.  One allreduce per bin, in the order
    of the list.  Differentiable.
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
                                      fresh=False)
            return
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        reduced = _allreduce(flat, op, *scales, fresh=True)
        parts = reduced.split([tensors[i].numel() for i in idxs])
        for i, part in zip(idxs, parts):
            out[i] = part.view(tensors[i].shape)

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


def _gather_rows(x: torch.Tensor, sizes) -> torch.Tensor:
    """Every rank's rows (``sizes[r]`` of them from rank r), concatenated in
    rank order."""
    m = max(sizes)
    buf = x.new_empty((len(sizes) * m,) + tuple(x.shape[1:]))
    _all_gather_single(buf, _padded(x, m))
    if all(n == m for n in sizes):
        return buf
    return torch.cat([buf[r * m:r * m + n] for r, n in enumerate(sizes)])


def _scatter_rows(x: torch.Tensor, sizes) -> torch.Tensor:
    """The sum over the world of ``x``'s rows, split ``sizes`` by rank;
    this rank's part."""
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
    _reduce_scatter_single(out, buf)
    return out[:sizes[_rank()]]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sizes):
        ctx.sizes = sizes
        return _gather_rows(x.detach(), sizes)

    @staticmethod
    def backward(ctx, g):
        # reference rule: reduce the gathered cotangent, keep own rows
        return _scatter_rows(g, ctx.sizes), None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sizes):
        ctx.sizes = sizes
        return _scatter_rows(x.detach(), sizes)

    @staticmethod
    def backward(ctx, g):
        # every rank's rows weigh 1 in every sum: gather the cotangents
        return _gather_rows(g, ctx.sizes), None


def _check_sum_or_average(op: ReduceOp, what: str) -> None:
    if op not in (Sum, Average):
        raise ValueError(f"{what} supports Sum/Average, got {op!r}")


def _average_after(y: torch.Tensor, op: ReduceOp) -> torch.Tensor:
    """Average divides after the collective, as the reference does."""
    return y / _size() if op == Average else y


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


def reduce_scatter_flat(flat: torch.Tensor, op: ReduceOp = Sum) -> torch.Tensor:
    """Reduce a 1-D buffer across the world and keep this rank's tiled
    chunk (the length must divide the world size).  Its backward is
    :func:`all_gather_flat` of the cotangent."""
    _check_sum_or_average(op, "reduce_scatter_flat")
    sizes = _flat_rows(flat, _size(), "reduce_scatter_flat")
    return _average_after(_ScatterRows.apply(flat, sizes), op)


def all_gather_flat(shard: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's 1-D shard (the inverse of
    :func:`reduce_scatter_flat`'s slicing).  Its backward is the
    reduce-scatter (sum) of the cotangent."""
    if shard.dim() != 1:
        raise ValueError(
            f"all_gather_flat takes a 1-D shard, got {tuple(shard.shape)}")
    return _GatherRows.apply(shard, [shard.shape[0]] * _size())
