"""The eager engine's data plane (counterpart of
``horovod_tpu/runtime/device_plane.py``).

The reference executes each negotiated, fused eager payload as a compiled
``shard_map`` collective over a process mesh.  The port executes it as one
``torch.distributed`` collective over a process group that only the
engine's background thread uses (``basics.EngineGroups``):

* the **device plane**: an NCCL group, for CUDA payloads.  The engine's
  own CUDA stream is current while the plane runs, so NCCL orders the
  collective after whatever the engine queued on that stream (the packing
  of the fused buffer, itself ordered after each payload's ready event);
* the **host plane**: the engine's gloo group, for CPU payloads (the
  reference's staged host path: an O(bytes) reduce instead of gathering
  every rank's buffer).

Two threads must never issue collectives on one communicator: they could
interleave differently on two ranks and hang.  So these groups are
created in ``init`` for the engine alone, never the default group nor the
groups of ``DistributedOptimizer``, ``OverlapPlan`` or ``hierarchical``.

The arithmetic is the reference plane's, op for op: the buffer is cast to
the accumulation dtype (fp32 for 16-bit floats), pre-scaled (rounded
through the wire dtype, as the reference does), reduced, averaged (floor
division for an exact integer mean), post-scaled and cast back to the
wire dtype.  The two-level schedule (``allreduce_hier``) is
``parallel/hierarchical.py``'s, run on the engine's own local and cross
groups.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.collectives import ReduceOp, _all_gather_single, \
    _reduce_scatter_single

__all__ = ["DataPlane", "DCN_WIRES"]

# Cross-leg wires of the two-level schedule (--dcn-compression): the
# cross group's shard is cast to this dtype and back.  Only float wires
# compress; integer payloads always cross exact.
DCN_WIRES = {"none": None, "bf16": "bfloat16", "fp16": "float16"}

_DCN_COMPRESSION = {"bfloat16": "bf16", "float16": "fp16"}


class DataPlane:
    """Collectives over one process group the engine owns.

    ``device`` is where the plane's buffers live (a CUDA device for the
    NCCL plane, the CPU for gloo).  ``groups`` are the engine's
    ``(local, cross)`` groups of the two-level schedule, or None."""

    def __init__(self, group, device: torch.device, world: int,
                 groups=None):
        self.group = group
        self.device = torch.device(device)
        self.world = world
        self.groups = groups

    @property
    def hierarchical_ok(self) -> bool:
        """Whether the two-level schedule can run: the engine has its
        local and cross groups (a world of hosts x local ranks, both
        larger than 1)."""
        return self.groups is not None

    def _prescaled(self, buf: torch.Tensor, pre: float, acc) -> torch.Tensor:
        v = buf if buf.dtype == acc else buf.to(acc)
        if pre != 1.0:
            v = (v * pre).to(buf.dtype).to(acc)
        return v

    def _finish(self, total: torch.Tensor, average: bool, post: float,
                exact_int_avg: bool, wire) -> torch.Tensor:
        if average:
            total = (total // self.world if exact_int_avg
                     else total / self.world)
        if post != 1.0:
            total = total * post
        return total.to(wire)

    def allreduce(self, buf: torch.Tensor, reduce_op: int, pre: float,
                  post: float, acc_dtype: torch.dtype,
                  exact_int_avg: bool) -> torch.Tensor:
        """Reduce a fused 1-D buffer over the plane's group; the result in
        ``buf``'s dtype (``buf`` itself may be overwritten)."""
        v = self._prescaled(buf, pre, acc_dtype)
        if reduce_op == int(ReduceOp.MIN):
            dist.all_reduce(v, op=dist.ReduceOp.MIN, group=self.group)
        elif reduce_op == int(ReduceOp.MAX):
            dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self.group)
        else:
            dist.all_reduce(v, op=dist.ReduceOp.SUM, group=self.group)
        return self._finish(v, reduce_op == int(ReduceOp.AVERAGE), post,
                            exact_int_avg, buf.dtype)

    def allreduce_hier(self, buf: torch.Tensor, reduce_op: int, pre: float,
                       post: float, acc_dtype: torch.dtype,
                       exact_int_avg: bool,
                       dcn_wire: Optional[str]) -> torch.Tensor:
        """The two-level allreduce (SUM / AVERAGE): a reduce-scatter in the
        local group, the cross group's sum of the shard (on ``dcn_wire``
        when given), an all-gather back; ``parallel/hierarchical.py`` on
        the engine's own groups."""
        from ..parallel.hierarchical import hierarchical_allreduce  # noqa: PLC0415

        v = self._prescaled(buf, pre, acc_dtype)
        total = hierarchical_allreduce(
            v, ReduceOp.SUM, groups=self.groups,
            compression=_DCN_COMPRESSION.get(dcn_wire))
        return self._finish(total, reduce_op == int(ReduceOp.AVERAGE), post,
                            exact_int_avg, buf.dtype)

    def allgather(self, local: torch.Tensor) -> torch.Tensor:
        """``(world, *local.shape)``: row r is rank r's ``local`` (every
        rank passes the same shape: ragged callers pad first)."""
        out = torch.empty(self.world * local.numel(), dtype=local.dtype,
                          device=local.device)
        _all_gather_single(out, local.contiguous().reshape(-1),
                           group=self.group)
        return out.reshape((self.world,) + tuple(local.shape))

    def broadcast(self, local: torch.Tensor, root: int) -> torch.Tensor:
        out = local.detach().clone(memory_format=torch.contiguous_format)
        # the engine's groups hold every rank: group ranks are global ranks
        dist.broadcast(out, src=root, group=self.group)
        return out

    def alltoall(self, local: torch.Tensor) -> torch.Tensor:
        """Block r of dim 0 goes to rank r; this rank's result stacks the
        blocks every rank sent it, in rank order (dim 0 divides the
        world)."""
        out = torch.empty_like(local, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, local.contiguous(), group=self.group)
        return out

    def reducescatter(self, local: torch.Tensor, average: bool, pre: float,
                      post: float, acc_dtype: torch.dtype) -> torch.Tensor:
        """This rank's block of dim 0 of the sum (dim 0 divides the
        world)."""
        v = self._prescaled(local, pre, acc_dtype).contiguous()
        out = torch.empty((v.shape[0] // self.world,) + tuple(v.shape[1:]),
                          dtype=v.dtype, device=v.device)
        _reduce_scatter_single(out, v, op=dist.ReduceOp.SUM,
                               group=self.group)
        return self._finish(out, average, post, False, local.dtype)
