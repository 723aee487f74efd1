"""Eager per-op collective API with async handles (counterpart of
``horovod_tpu/ops/eager.py``).

Reference surface: horovod/torch/mpi_ops.py — ``allreduce[_async][_]``,
``allgather[_async]``, ``broadcast[_async][_]``, ``reducescatter[_async]``,
``alltoall[_async]``, ``poll``, ``synchronize``, ``join``, ``barrier``.
Handles are futures resolved by the background engine
(``runtime/engine.py``; reference HandleManager,
horovod/torch/handle_manager.cc).  Unnamed tensors get the reference's
sequence names (``allreduce.noname.N``): the Nth unnamed call of a kind
pairs with the Nth on every rank.

Torch tensors in, torch tensors out, on the caller's device and in its
dtype.  A CUDA payload is reduced on the card (NCCL on the engine's own
group and stream): ``synchronize`` makes the caller's current stream wait
on the result's completion event and returns without blocking the host on
the device.  The in-place spellings (``allreduce_async_``,
``broadcast_async_``, ...) write the result back into their argument at
``synchronize``.  In a world of one every op resolves at enqueue and
returns its argument itself (the scales applied).

The JAX module's ``_uncommit``, ``_array_impl_cls`` and the rest of its
commitment bookkeeping (``horovod_tpu/ops/eager.py:56-150, :315-347``) keep
jax.Array device commitment across the engine; torch tensors have no
commitment, so they have no counterpart here.
"""

from __future__ import annotations

import concurrent.futures
import itertools
from typing import Optional

import torch

from .._engine_registry import get_engine
from ..runtime.messages import RequestType
from .collectives import Average, ReduceOp

__all__ = [
    "allreduce",
    "allreduce_",
    "allreduce_async",
    "allreduce_async_",
    "allgather",
    "allgather_async",
    "reducescatter",
    "reducescatter_async",
    "broadcast",
    "broadcast_",
    "broadcast_async",
    "broadcast_async_",
    "alltoall",
    "alltoall_async",
    "synchronize",
    "poll",
    "join",
    "barrier",
]

_name_counter = itertools.count(1)


def _auto_name(prefix: str) -> str:
    """Reference behavior: unnamed tensors get a sequence name
    (torch/mpi_ops.py handle naming 'allreduce.noname.N')."""
    return f"{prefix}.noname.{next(_name_counter)}"


def _checked(tensor: torch.Tensor) -> torch.Tensor:
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(tensor)!r}")
    if tensor.device.type not in ("cuda", "cpu"):
        raise ValueError(f"eager collectives take CUDA or CPU tensors, got "
                         f"device {tensor.device}")
    return tensor


def _inplace(fut: concurrent.futures.Future,
             tensor: torch.Tensor) -> concurrent.futures.Future:
    fut._hvd_inplace = tensor  # consumed by synchronize()
    return fut


def allreduce_async(
    tensor: torch.Tensor,
    op: ReduceOp = Average,
    name: Optional[str] = None,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
) -> concurrent.futures.Future:
    """reference: hvd.allreduce_async (torch/mpi_ops.py:94-129)."""
    rtype = (
        RequestType.ADASUM if op == ReduceOp.ADASUM else RequestType.ALLREDUCE
    )
    return get_engine().enqueue(
        rtype,
        name or _auto_name("allreduce"),
        _checked(tensor),
        reduce_op=int(op),
        prescale=prescale_factor,
        postscale=postscale_factor,
    )


def allreduce(tensor, op: ReduceOp = Average, name: Optional[str] = None,
              **kw) -> torch.Tensor:
    """Blocking allreduce (reference torch/mpi_ops.py:131-155)."""
    return synchronize(allreduce_async(tensor, op, name, **kw))


def allreduce_async_(tensor, op: ReduceOp = Average,
                     name: Optional[str] = None,
                     **kw) -> concurrent.futures.Future:
    """In-place async allreduce: ``synchronize`` writes the result back
    into ``tensor`` (reference allreduce_async_, torch/mpi_ops.py:174-205)."""
    return _inplace(allreduce_async(tensor, op, name, **kw), tensor)


def allreduce_(tensor, op: ReduceOp = Average, name: Optional[str] = None,
               **kw) -> torch.Tensor:
    return synchronize(allreduce_async_(tensor, op, name, **kw))


def allgather_async(tensor, name: Optional[str] = None
                    ) -> concurrent.futures.Future:
    """reference: hvd.allgather_async (torch/mpi_ops.py:231-260).  Ragged
    dim-0 across ranks is supported — sizes are negotiated (controller
    Response::tensor_sizes)."""
    return get_engine().enqueue(
        RequestType.ALLGATHER, name or _auto_name("allgather"),
        _checked(tensor))


def allgather(tensor, name: Optional[str] = None) -> torch.Tensor:
    return synchronize(allgather_async(tensor, name))


def broadcast_async(tensor, root_rank: int, name: Optional[str] = None
                    ) -> concurrent.futures.Future:
    """reference: hvd.broadcast_async (torch/mpi_ops.py:330-360)."""
    return get_engine().enqueue(
        RequestType.BROADCAST, name or _auto_name("broadcast"),
        _checked(tensor), root_rank=root_rank)


def broadcast(tensor, root_rank: int, name: Optional[str] = None
              ) -> torch.Tensor:
    return synchronize(broadcast_async(tensor, root_rank, name))


def broadcast_async_(tensor, root_rank: int, name: Optional[str] = None
                     ) -> concurrent.futures.Future:
    """In-place async broadcast: ``synchronize`` writes the root's value
    into ``tensor``."""
    return _inplace(broadcast_async(tensor, root_rank, name), tensor)


def broadcast_(tensor, root_rank: int, name: Optional[str] = None
               ) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name))


def reducescatter_async(tensor, op: ReduceOp = Average,
                        name: Optional[str] = None
                        ) -> concurrent.futures.Future:
    """Sum across ranks, keep this rank's dim-0 rows (the first leg of the
    reference's hierarchical allreduce, nccl_operations.cc:218-229, as the
    user op later Horovod versions exposed).  Uneven dim0: the first
    (dim0 % world) ranks receive one extra row."""
    if op not in (ReduceOp.AVERAGE, ReduceOp.SUM):
        raise ValueError(f"reducescatter supports Sum/Average, got {op!r}")
    return get_engine().enqueue(
        RequestType.REDUCESCATTER, name or _auto_name("reducescatter"),
        _checked(tensor), reduce_op=int(op))


def reducescatter(tensor, op: ReduceOp = Average,
                  name: Optional[str] = None) -> torch.Tensor:
    return synchronize(reducescatter_async(tensor, op, name))


def alltoall_async(tensor, name: Optional[str] = None
                   ) -> concurrent.futures.Future:
    """Block r of dim 0 to rank r (dim 0 divides the world)."""
    return get_engine().enqueue(
        RequestType.ALLTOALL, name or _auto_name("alltoall"),
        _checked(tensor))


def alltoall(tensor, name: Optional[str] = None) -> torch.Tensor:
    return synchronize(alltoall_async(tensor, name))


def poll(handle: concurrent.futures.Future) -> bool:
    """True if the op has completed (reference torch/mpi_ops.py:458-472):
    the engine has issued it, so ``synchronize`` will not block the host."""
    return handle.done()


def synchronize(handle: concurrent.futures.Future):
    """Wait for the op and return its result (reference
    torch/mpi_ops.py:475-491; raises the negotiated error on a mismatch,
    like the reference's ErrorOp -> exception path).

    A CUDA result is ordered on the caller's current stream: the stream
    waits on the event recorded after the result's copy on the engine's
    stream (the host does not), and the result's memory is marked in use
    by the caller's stream.  An in-place handle's result is copied into
    its tensor, which is returned."""
    result = handle.result()
    if result is None:
        return None
    done = getattr(handle, "_hvd_done", None)
    if done is not None:
        stream = torch.cuda.current_stream(result.device)
        stream.wait_event(done)
        result.record_stream(stream)
    target = getattr(handle, "_hvd_inplace", None)
    if target is None:
        return result
    if result is not target:
        with torch.no_grad():
            target.copy_(result.reshape(target.shape))
    return target


def join() -> int:
    """Block until every rank has joined (reference hvd.join,
    torch/mpi_ops.py:494-508; semantics at controller.cc:263-307).  While
    blocked, this rank participates in peers' collectives with zero
    tensors.  Returns the last rank to join (best-effort)."""
    return get_engine().join().result()


def barrier() -> None:
    """All-rank barrier on the eager engine."""
    get_engine().barrier().result()
