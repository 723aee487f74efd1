"""Collectives with Horovod's autodiff rules (counterpart of
``horovod_tpu/ops/collectives.py``), over the ``torch.distributed``
default process group: NCCL on CUDA, gloo on the CPU.

Each op is a ``torch.autograd.Function`` with the reference's backward
rule (horovod/torch/mpi_ops.py):

* allreduce  backward = allreduce of the cotangent with the same op;
* broadcast  backward = the cotangents summed onto the root, zero
  elsewhere.

``Average`` is Sum then divide by the world size, as in the reference.
Only what the data-parallel training step calls is here; allgather,
alltoall, reducescatter and the Min/Max/Adasum reductions are ROADMAP A2.
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
    if op not in (Average, Sum):
        raise NotImplementedError(
            f"allreduce op {op!r} is not ported yet (ROADMAP A2); "
            "Average and Sum are"
        )
    if prescale_factor != 1.0:
        tensor, fresh = tensor * prescale_factor, True
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
