"""Two-level collectives over the local and cross groups (counterpart of
``horovod_tpu/parallel/hierarchical.py``; reference
NCCLHierarchicalAllreduce, horovod/common/ops/nccl_operations.cc:162-300).

A reduce-scatter within the host, an allreduce across hosts on the
scattered shards, an all-gather back within the host: the cross fabric
carries 1/local_size of the bytes.  ``compression`` casts only the cross
leg's shard to a narrower wire dtype (``"bf16"`` / ``"fp16"``) and back;
the local legs stay exact.

The groups are :func:`~horovod_tpu_torch.basics.local_group` and
:func:`~horovod_tpu_torch.basics.cross_group`, named by the reference's
axes (``local_axis=LOCAL_AXIS``, ``cross_axis=CROSS_AXIS``).  The
two-level scatter leaves rank (cross c, local l) holding shard
``l x cross_size + c`` of the buffer: the local index varies slowest.
Every function takes one tensor and is differentiable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..basics import CROSS_AXIS, LOCAL_AXIS, group_of_axis
from ..ops.collectives import (
    Average,
    ReduceOp,
    Sum,
    _group_size,
    all_gather_flat,
    allreduce_group,
    reduce_scatter_flat,
)
from ..ops.compression import Compression, ErrorFeedbackCompressor

__all__ = [
    "hierarchical_allreduce",
    "hierarchical_adasum",
    "hierarchical_reduce_scatter",
    "hierarchical_all_gather",
    "hierarchical_shard_index",
]

_CHOICES = {"bf16": Compression.bf16, "fp16": Compression.fp16}


def _resolve_compressor(compression):
    """``None`` / ``"none"`` / ``"bf16"`` / ``"fp16"`` / a stateless
    compressor class -> the compressor class, or None.  The names are an
    explicit whitelist: the stateful error-feedback compressor has no place
    on one leg of a schedule, so ``"ef_bf16"`` fails here, with the
    reference's message, as does an :class:`ErrorFeedbackCompressor`."""
    if compression in (None, "none"):
        return None
    if isinstance(compression, str):
        comp = _CHOICES.get(compression)
        if comp is None:
            raise ValueError(f"unknown dcn compression {compression!r}; "
                             f"choices: none, bf16, fp16")
        return comp
    if isinstance(compression, ErrorFeedbackCompressor):
        raise ValueError(
            f"unknown dcn compression {compression!r}; choices: none, bf16, "
            f"fp16 (an error-feedback compressor keeps state per stream)")
    return compression


def _check_op(op: ReduceOp, what: str) -> None:
    if op not in (Average, Sum):
        raise ValueError(f"{what} supports Average/Sum, got {op!r}")


def _cross_sum(shard: torch.Tensor, cross, comp) -> torch.Tensor:
    """The cross leg: sum ``shard`` over ``cross``, on the compressed wire
    when there is one."""
    if comp is None:
        return allreduce_group(shard, Sum, group=cross)
    wire, ctx = comp.compress(shard)
    return comp.decompress(allreduce_group(wire, Sum, group=cross), ctx)


def _padded_flat(x: torch.Tensor, ways: int):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % ways
    return (F.pad(flat, (0, pad)) if pad else flat), pad


def hierarchical_allreduce(tensor: torch.Tensor, op: ReduceOp = Average, *,
                           local_axis: str = LOCAL_AXIS,
                           cross_axis: str = CROSS_AXIS,
                           compression=None, groups=None) -> torch.Tensor:
    """Allreduce over both groups, scattering over the local group so the
    cross leg moves 1/local_size of the bytes.  A length the local size
    does not divide is zero-padded and cut back.  ``compression`` casts
    only the cross leg.  ``groups``, a ``(local, cross)`` pair of process
    groups, replaces the axes' groups (the eager engine passes its own)."""
    _check_op(op, "hierarchical_allreduce")
    comp = _resolve_compressor(compression)
    local, cross = groups or (group_of_axis(local_axis),
                              group_of_axis(cross_axis))
    local_n = _group_size(local)
    flat, pad = _padded_flat(tensor, local_n)
    shard = reduce_scatter_flat(flat, Sum, group=local)
    shard = _cross_sum(shard, cross, comp)
    full = all_gather_flat(shard, group=local)
    if pad:
        full = full[:-pad]
    out = full.reshape(tensor.shape)
    if op == Average:
        out = out / (local_n * _group_size(cross))
    return out


def hierarchical_reduce_scatter(flat: torch.Tensor, op: ReduceOp = Sum, *,
                                local_axis: str = LOCAL_AXIS,
                                cross_axis: str = CROSS_AXIS,
                                compression=None) -> torch.Tensor:
    """Reduce a 1-D buffer over both groups and keep this rank's
    1/(local x cross) shard: a reduce-scatter within the local group, then
    one of that shard across the cross group (on the compressed wire when
    there is one).  Rank (c, l) keeps shard ``l x cross_size + c``; the
    length must divide local x cross (pad first)."""
    _check_op(op, "hierarchical_reduce_scatter")
    comp = _resolve_compressor(compression)
    local, cross = group_of_axis(local_axis), group_of_axis(cross_axis)
    shard = reduce_scatter_flat(flat, Sum, group=local)
    if comp is None:
        shard = reduce_scatter_flat(shard, Sum, group=cross)
    else:
        wire, ctx = comp.compress(shard)
        shard = comp.decompress(reduce_scatter_flat(wire, Sum, group=cross),
                                ctx)
    if op == Average:
        shard = shard / (_group_size(local) * _group_size(cross))
    return shard


def hierarchical_all_gather(shard: torch.Tensor, *,
                            local_axis: str = LOCAL_AXIS,
                            cross_axis: str = CROSS_AXIS) -> torch.Tensor:
    """Inverse of :func:`hierarchical_reduce_scatter`'s slicing: gather the
    cross group's shards into this host's local shard, then the local
    shards into the buffer."""
    x = all_gather_flat(shard, group=group_of_axis(cross_axis))
    return all_gather_flat(x, group=group_of_axis(local_axis))


def hierarchical_shard_index(local_rank: int, cross_rank: int,
                             cross_size: int) -> int:
    """The shard of a buffer that :func:`hierarchical_reduce_scatter`
    leaves on rank (``cross_rank``, ``local_rank``)."""
    return local_rank * cross_size + cross_rank


def hierarchical_adasum(tensor: torch.Tensor, *,
                        local_axis: str = LOCAL_AXIS,
                        cross_axis: str = CROSS_AXIS) -> torch.Tensor:
    """Two-level Adasum (reference AdasumGpuAllreduceOp,
    horovod/common/ops/adasum_gpu_operations.cc): the local mean by a
    reduce-scatter within the host, the Adasum projection of each shard
    across hosts (the cross size must be a power of 2), an all-gather
    back."""
    from ..ops.adasum import adasum_allreduce  # noqa: PLC0415

    local, cross = group_of_axis(local_axis), group_of_axis(cross_axis)
    local_n = _group_size(local)
    flat, pad = _padded_flat(tensor, local_n)
    shard = reduce_scatter_flat(flat, Sum, group=local) / local_n
    shard = adasum_allreduce(shard, group=cross)
    full = all_gather_flat(shard, group=local)
    if pad:
        full = full[:-pad]
    return full.reshape(tensor.shape)
