"""Data-parallel optimizer (counterpart of ``horovod_tpu/optim/__init__.py``;
reference: hvd.DistributedOptimizer and the broadcast helpers of
horovod/torch/__init__.py).

:class:`DistributedOptimizer` wraps any ``torch.optim.Optimizer``: at
``step()`` it averages the gradients across ranks — in the fixed order of
the optimizer's parameters, through one :func:`grouped_allreduce` that
fuses them per dtype — and then steps the wrapped optimizer.  Every rank
steps with the same averaged gradients, so replicas stay identical.  The
hierarchical, Adasum and sparse reduction paths of the reference are
ROADMAP A5.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Union

import torch
import torch.distributed as dist

from ..basics import global_topology
from ..ops.collectives import Adasum, Average, ReduceOp, Sum, \
    grouped_allreduce
from ..ops.compression import Compression

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
    pre-scale 1/f and a post-scale f/N.  ``backward_passes_per_step`` k
    accumulates k micro-batches before one reduce and one update, like
    the reference's ``optax.MultiSteps``: ``step()`` counts calls and acts
    on every k-th, using the mean of the k accumulated gradients, and
    ``zero_grad()`` keeps the gradients while an accumulation is open.
    """

    def __init__(
        self,
        optimizer: torch.optim.Optimizer,
        *,
        op: ReduceOp = Average,
        compression=Compression.none,
        backward_passes_per_step: int = 1,
        gradient_predivide_factor: float = 1.0,
    ):
        if op == Adasum:
            raise NotImplementedError(
                "Adasum is not ported yet (ROADMAP A5); Average and Sum are")
        if op not in (Average, Sum):
            raise ValueError(
                f"DistributedOptimizer supports Average/Sum, got {op!r}")
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self.op = op
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self.gradient_predivide_factor = gradient_predivide_factor
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
        op, pre, post = self.op, 1.0, 1.0
        if self.op == Average and self.gradient_predivide_factor != 1.0:
            op = Sum
            pre = 1.0 / self.gradient_predivide_factor
            post = self.gradient_predivide_factor / global_topology().process_count
        # mean over the accumulated micro-batches (allreduce is linear)
        pre /= self.backward_passes_per_step
        wire, ctxs = zip(*(self.compression.compress(p.grad) for p in params))
        reduced = grouped_allreduce(wire, op, prescale_factor=pre,
                                    postscale_factor=post)
        for p, r, c in zip(params, reduced, ctxs):
            p.grad.copy_(self.compression.decompress(r, c))

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
