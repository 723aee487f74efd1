"""``horovod.torch``-compatible API on the port's eager engine (counterpart
of ``horovod_tpu/interop/torch.py``).

A drop-in surface for reference users (horovod/torch/__init__.py,
horovod/torch/mpi_ops.py): the same ``init/rank/size``, collective and
``DistributedOptimizer`` spellings, executed by the eager engine
(``runtime/engine.py``) through ``ops/eager.py``.

Where the JAX module takes host tensors only (its ``_check_cpu``: torch is
its host framework, the compute path is JAX), the port **accepts CUDA
tensors** and keeps them on the card: a CUDA gradient is reduced by NCCL
on the engine's own group and stream, ordered after the compute stream's
write by an event, and the result is ordered on the caller's stream at
``synchronize``.  CPU tensors take the engine's gloo plane.

Autograd parity: each collective is a ``torch.autograd.Function`` whose
backward is the reference's (allreduce -> allreduce,
torch/mpi_ops.py:158-171; allgather -> reduce + narrow by rank offsets,
:289-307; broadcast -> reduce-to-root, zero elsewhere, :371-385).

``Compression`` is the port's (``ops/compression.py``: none, fp16, bf16).
``SyncBatchNorm`` is the reference interop's torch ``_BatchNorm`` module
(torch's momentum convention, unbiased running variance, statistics
through engine allreduces), not ``parallel/sync_batch_norm.py``, which
keeps flax's running update and biased variance: the two differ in their
running statistics, so neither stands in for the other.
"""

from __future__ import annotations

import warnings
import weakref
from contextlib import contextmanager
from typing import Any, Iterable, Optional, Tuple, Union

import torch

from ..basics import (  # noqa: F401  (re-exported API surface)
    cross_rank,
    cross_size,
    gloo_built,
    gloo_enabled,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    rank,
    shutdown,
    size,
)
from ..ops import eager
from ..ops.collectives import Adasum, Average, Max, Min, ReduceOp, Sum  # noqa: F401
from ..ops.compression import Compression
from ..ops.eager import barrier, join, poll, synchronize  # noqa: F401

__all__ = [
    "init", "shutdown", "is_initialized",
    "rank", "size", "local_rank", "local_size", "cross_rank", "cross_size",
    "is_homogeneous",
    "mpi_built", "mpi_enabled", "mpi_threads_supported",
    "gloo_built", "gloo_enabled", "nccl_built",
    "ReduceOp", "Average", "Sum", "Adasum", "Min", "Max",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "allgather", "allgather_async",
    "broadcast", "broadcast_", "broadcast_async", "broadcast_async_",
    "alltoall",
    "poll", "synchronize", "join", "barrier",
    "DistributedOptimizer",
    "broadcast_parameters", "broadcast_optimizer_state", "broadcast_object",
    "Compression",
    "SyncBatchNorm",
]


# ---------------------------------------------------------------------------
# collectives (async + autograd wrappers)
# ---------------------------------------------------------------------------


def _resolve_op(average, op) -> ReduceOp:
    """Reference signature compatibility (torch/mpi_ops.py:94-129 +
    util.get_average_backwards_compatibility_fun): the 0.19-era positional
    ``average`` bool and the ``op`` enum are both accepted, never both."""
    if average is not None and op is not None:
        raise ValueError(
            "The op parameter supersedes average. Please provide only one "
            "of them."
        )
    if average is not None and not isinstance(average, bool):
        # code written against an op-second-positional signature
        # (allreduce(t, Sum)) must not be silently read as average=truthy
        raise TypeError(
            f"average must be a bool, got {average!r}; pass reduction "
            "operations via the op= keyword (op=hvd.Sum / hvd.Adasum / ...)"
        )
    if op is not None:
        return op
    if average is False:
        return Sum
    return Average


def allreduce_async(tensor: torch.Tensor, average=None,
                    name: Optional[str] = None, op: Optional[ReduceOp] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0):
    """reference torch/mpi_ops.py:132-170 (average= and op= spellings)."""
    return eager.allreduce_async(
        tensor, _resolve_op(average, op), name,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor)


def allreduce_async_(tensor: torch.Tensor, average=None,
                     name: Optional[str] = None,
                     op: Optional[ReduceOp] = None, **kw):
    """In-place async allreduce: the result lands back in ``tensor`` at
    ``synchronize`` (reference allreduce_async_, torch/mpi_ops.py:174-205)."""
    return eager.allreduce_async_(tensor, _resolve_op(average, op), name,
                                  **kw)


class _AllreduceFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, op, name, prescale, postscale):
        ctx.op, ctx.prescale, ctx.postscale = op, prescale, postscale
        return synchronize(allreduce_async(
            tensor, op=op, name=name, prescale_factor=prescale,
            postscale_factor=postscale))

    @staticmethod
    def backward(ctx, grad):
        # reference _AllreduceFunction.backward (torch/mpi_ops.py:158-171):
        # the gradient of an allreduce is the same allreduce of the grads.
        return (
            synchronize(allreduce_async(
                grad.contiguous(), op=ctx.op,
                prescale_factor=ctx.prescale, postscale_factor=ctx.postscale,
            )),
            None, None, None, None,
        )


def allreduce(tensor: torch.Tensor, average=None, name: Optional[str] = None,
              compression=None, op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Differentiable blocking allreduce (reference torch/mpi_ops.py:173-231:
    average=/op= spellings plus wire compression)."""
    op = _resolve_op(average, op)
    compression = compression or Compression.none
    wire, dctx = compression.compress(tensor)
    if wire.requires_grad:
        out = _AllreduceFn.apply(wire, op, name, prescale_factor,
                                 postscale_factor)
    else:
        out = synchronize(allreduce_async(
            wire, op=op, name=name, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor))
    return compression.decompress(out, dctx)


def allreduce_(tensor: torch.Tensor, average=None,
               name: Optional[str] = None,
               op: Optional[ReduceOp] = None, **kw) -> torch.Tensor:
    """reference torch/mpi_ops.py:234-259."""
    return synchronize(allreduce_async_(tensor, average, name, op, **kw))


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None):
    return eager.allgather_async(tensor, name)


class _AllgatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, name):
        ctx.dim0 = tensor.shape[0] if tensor.ndim else 1
        return synchronize(allgather_async(tensor, name))

    @staticmethod
    def backward(ctx, grad):
        # reference _AllgatherFunction.backward (torch/mpi_ops.py:289-307):
        # reduce the gathered grads, then narrow out this rank's rows, at
        # the offset the allgathered dim-0 sizes give.
        sizes = synchronize(allgather_async(
            torch.tensor([ctx.dim0], dtype=torch.int64)))
        reduced = synchronize(allreduce_async(grad.contiguous(), op=Sum))
        start = int(sizes[:rank()].sum())
        return reduced.narrow(0, start, ctx.dim0), None


def allgather(tensor: torch.Tensor, name: Optional[str] = None
              ) -> torch.Tensor:
    """Differentiable allgather; ragged dim 0 supported (negotiated sizes,
    reference controller.cc:453-518)."""
    if tensor.requires_grad:
        return _AllgatherFn.apply(tensor, name)
    return synchronize(allgather_async(tensor, name))


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None):
    return eager.broadcast_async(tensor, root_rank, name)


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None):
    return eager.broadcast_async_(tensor, root_rank, name)


class _BroadcastFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        ctx.root_rank = root_rank
        return synchronize(broadcast_async(tensor, root_rank, name))

    @staticmethod
    def backward(ctx, grad):
        # reference _BroadcastFunction.backward (torch/mpi_ops.py:371-385):
        # sum grads to the root; non-roots contribute and receive zero.
        reduced = synchronize(allreduce_async(grad.contiguous(), op=Sum))
        if rank() != ctx.root_rank:
            reduced = torch.zeros_like(reduced)
        return reduced, None, None


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None) -> torch.Tensor:
    if tensor.requires_grad:
        return _BroadcastFn.apply(tensor, root_rank, name)
    return synchronize(broadcast_async(tensor, root_rank, name))


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name))


def alltoall(tensor: torch.Tensor, name: Optional[str] = None
             ) -> torch.Tensor:
    return eager.alltoall(tensor, name)


# ---------------------------------------------------------------------------
# DistributedOptimizer (reference horovod/torch/__init__.py:67-222)
# ---------------------------------------------------------------------------


def _named(optimizer, named_parameters) -> list:
    if named_parameters is not None:
        named = list(named_parameters)
    else:
        named = [
            (f"param.{i}.{j}", p)
            for i, group in enumerate(optimizer.param_groups)
            for j, p in enumerate(group["params"])
        ]
    # duplicate-name guard (reference torch/__init__.py:90-99)
    names = [n for n, _ in named]
    if len(names) != len(set(names)):
        raise ValueError("parameter names must be unique")
    return named


class _DistributedOptimizer:
    """Wraps a torch optimizer: per-parameter hooks fire a named async
    allreduce as each gradient accumulates; ``step()`` synchronizes, writes
    the reduced gradients back into ``p.grad`` and applies the update.

    Mirrors the reference's grad-accumulator hook design
    (torch/__init__.py:67-222) using torch's post-accumulate-grad hooks,
    including ``backward_passes_per_step`` gradient accumulation
    (:101-126): the k-th backward's hook reduces the accumulated gradient
    pre-scaled by 1/k.
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 op: ReduceOp = Average):
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self.backward_passes_per_step = backward_passes_per_step
        named = _named(optimizer, named_parameters)
        params_in_opt = {
            id(p) for g in optimizer.param_groups for p in g["params"]
        }
        self._names = {
            id(p): n for n, p in named if id(p) in params_in_opt
        }
        self._handles: dict = {}
        self._passes: dict = {}
        self._should_synchronize = True
        self._synchronized = False
        self._hooks = []
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    self._hooks.append(
                        p.register_post_accumulate_grad_hook(self._make_hook())
                    )

    def _make_hook(self):
        # Parameters keep their hooks in C++, out of the garbage
        # collector's sight: a hook holding the optimizer strongly would
        # keep every dropped optimizer (and its state) alive with its model.
        ref = weakref.ref(self)

        def hook(p: torch.Tensor):
            self = ref()
            if self is None:
                return
            self._passes[id(p)] = self._passes.get(id(p), 0) + 1
            if self._passes[id(p)] < self.backward_passes_per_step:
                return
            self._passes[id(p)] = 0
            name = self._names.get(id(p), f"grad.{id(p)}")
            wire, dctx = self._compression.compress(p.grad)
            fut = eager.allreduce_async(
                wire, self._op, f"allreduce.{name}",
                prescale_factor=1.0 / self.backward_passes_per_step,
            )
            self._handles[id(p)] = (p, fut, dctx)

        return hook

    def synchronize(self) -> None:
        """Wait for all outstanding grad reductions and write them back
        (reference torch/__init__.py:165-215)."""
        for p, fut, dctx in self._handles.values():
            out = self._compression.decompress(synchronize(fut), dctx)
            if out is not p.grad:
                with torch.no_grad():
                    p.grad.copy_(out)
        self._handles.clear()
        self._synchronized = True

    @contextmanager
    def skip_synchronize(self):
        """Make the next ``step()`` skip synchronization — the
        synchronize-then-clip-then-step pattern (reference
        torch/__init__.py:184-202):

            optimizer.synchronize()
            torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
            with optimizer.skip_synchronize():
                optimizer.step()
        """
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                warnings.warn(
                    "optimizer.step() called without "
                    "optimizer.skip_synchronize() context after "
                    "optimizer.synchronize(). This can cause training "
                    "slowdown. You may want to consider using "
                    "optimizer.skip_synchronize() context if you use "
                    "optimizer.synchronize() in your code."
                )
            self.synchronize()
        self._synchronized = False
        return self._opt.step(closure)

    def zero_grad(self, *a, **kw):
        if self._handles:
            raise AssertionError(
                "zero_grad called with allreduces in flight — call step() "
                "or synchronize() first (reference torch/__init__.py:217-222)"
            )
        return self._opt.zero_grad(*a, **kw)

    def __getattr__(self, item):
        return getattr(self._opt, item)


class _DistributedAdasumOptimizer:
    """Delta-based Adasum optimizer (reference torch/__init__.py:225-393).

    ``op=Adasum`` changes WHAT is reduced, not just HOW: each rank runs the
    wrapped optimizer's update for a parameter locally, and the parameter
    *delta* (``-lr * f(g)``, where f is the optimizer's own logic) is
    Adasum-allreduced; the new state is ``start + reduced_delta``.  The
    Adasum projection then blends update *directions* instead of raw
    gradients (reference torch/__init__.py:293-307).  The single-parameter
    local step narrows the wrapped optimizer's param_groups to that
    parameter.
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1):
        self._opt = optimizer
        self._compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        named = _named(optimizer, named_parameters)
        # Every optimizer parameter must be named: an unnamed one would
        # have no start buffer and never be reduced (reference raises the
        # same way, torch/__init__.py:255-259).
        named_ids = {id(p) for _, p in named}
        unnamed = [
            p for group in optimizer.param_groups
            for p in group["params"] if id(p) not in named_ids
        ]
        if unnamed:
            raise ValueError(
                "named_parameters was specified, but one or more model "
                "parameters were not named. Python object ids: "
                + ", ".join(str(id(p)) for p in unnamed)
            )
        self._names = {id(p): n for n, p in named}
        # the per-parameter "starting model" the reduced deltas accumulate
        # into (torch/__init__.py:270-273)
        self._start = {
            id(p): torch.zeros_like(p, requires_grad=False)
            for _, p in named
        }
        self._params = {id(p): p for _, p in named}
        self._handles: dict = {}
        self._passes: dict = {}
        self._hooks = []
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    self._hooks.append(
                        p.register_post_accumulate_grad_hook(
                            self._make_hook()
                        )
                    )

    def _delta_allreduce_async(self, p: torch.Tensor):
        """Local one-parameter step -> delta -> async Adasum reduce."""
        stashed = []
        for group in self._opt.param_groups:
            stashed.append(group["params"])
            group["params"] = [v for v in group["params"] if v is p]
        start = self._start[id(p)]
        with torch.no_grad():
            start.copy_(p)
        self._opt.step()
        for params, group in zip(stashed, self._opt.param_groups):
            group["params"] = params
        with torch.no_grad():
            p.sub_(start)  # p now holds delta = -lr * f(g)
        name = self._names.get(id(p), f"delta.{id(p)}")
        wire, dctx = self._compression.compress(p.detach())
        fut = eager.allreduce_async(wire, Adasum, f"adasum.{name}")
        return fut, dctx

    def _make_hook(self):
        ref = weakref.ref(self)  # as _DistributedOptimizer's hooks

        def hook(p: torch.Tensor):
            self = ref()
            if self is None:
                return
            # a second reduction for the same parameter before step() would
            # submit a duplicate in-flight name AND snapshot a delta-holding
            # parameter into the start buffer — fail loudly instead
            if id(p) in self._handles:
                raise AssertionError(
                    "Gradients were computed more than "
                    "backward_passes_per_step times before call to step(). "
                    "Increase backward_passes_per_step to accumulate "
                    "gradients locally."
                )
            self._passes[id(p)] = self._passes.get(id(p), 0) + 1
            if self._passes[id(p)] < self.backward_passes_per_step:
                return
            self._passes[id(p)] = 0
            self._handles[id(p)] = (p, *self._delta_allreduce_async(p))

        return hook

    def set_backward_passes_per_step(self, passes: int) -> None:
        self.backward_passes_per_step = passes
        self._passes.clear()

    def synchronize(self) -> None:
        # The reference's Adasum optimizer completes reductions only in
        # step() (its synchronize is a no-op, torch/__init__.py:355-356):
        # a delta must be applied to start, never written back to .grad.
        pass

    @contextmanager
    def skip_synchronize(self):
        raise AssertionError(
            "Skipping synchronization is not supported when using Adasum "
            "optimizer."
        )
        yield  # pragma: no cover — contextmanager shape (reference :359-361)

    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for pid, p in self._params.items():
            if pid not in self._handles and p.grad is not None:
                self._handles[pid] = (p, *self._delta_allreduce_async(p))
        for pid, (p, fut, dctx) in self._handles.items():
            delta = self._compression.decompress(synchronize(fut), dctx)
            start = self._start[pid]
            with torch.no_grad():
                start.add_(delta)
                p.copy_(start)
        self._handles.clear()
        # reference resets the per-parameter accumulation countdown in
        # step() (torch/__init__.py:382)
        self._passes.clear()
        return loss

    def zero_grad(self, *a, **kw):
        if self._handles:
            raise AssertionError(
                "zero_grad called with Adasum reductions in flight — call "
                "step() first (reference torch/__init__.py:217-222)"
            )
        return self._opt.zero_grad(*a, **kw)

    def __getattr__(self, item):
        return getattr(self._opt, item)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: ReduceOp = Average):
    """reference: hvd.DistributedOptimizer (torch/__init__.py:396-449).
    ``op=Adasum`` selects the delta-reducing Adasum optimizer, exactly as
    the reference factory does (:443-449)."""
    if op == Adasum:
        return _DistributedAdasumOptimizer(
            optimizer, named_parameters, compression,
            backward_passes_per_step,
        )
    return _DistributedOptimizer(
        optimizer, named_parameters, compression,
        backward_passes_per_step, op,
    )


# ---------------------------------------------------------------------------
# SyncBatchNorm (reference horovod/torch/sync_batch_norm.py)
# ---------------------------------------------------------------------------


class _SyncBatchNormFn(torch.autograd.Function):
    """Cross-rank batch norm: forward allreduces count, sum and sum of
    squares over the global batch; backward allreduces sum_dy and
    sum_dy_xhat, the standard sync-BN gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = [0] + list(range(2, x.dim()))  # all but channel
        count = torch.tensor(
            [float(x.numel() // x.shape[1])], device=x.device)
        local_sum = x.sum(dims)
        local_sqsum = (x * x).sum(dims)
        total = synchronize(allreduce_async(count, op=Sum))
        gsum = synchronize(allreduce_async(local_sum, op=Sum))
        gsqsum = synchronize(allreduce_async(local_sqsum, op=Sum))
        n = float(total)
        mean = gsum / n
        var = gsqsum / n - mean * mean
        invstd = torch.rsqrt(var + eps)
        shape = [1, -1] + [1] * (x.dim() - 2)
        xhat = (x - mean.reshape(shape)) * invstd.reshape(shape)
        out = xhat * weight.reshape(shape) + bias.reshape(shape)
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.n = n
        ctx.dims = dims
        return out, mean, var

    @staticmethod
    def backward(ctx, grad_out, _gm, _gv):
        xhat, weight, invstd = ctx.saved_tensors
        dims, n = ctx.dims, ctx.n
        shape = [1, -1] + [1] * (grad_out.dim() - 2)
        sum_dy = synchronize(
            allreduce_async(grad_out.sum(dims).contiguous(), op=Sum)
        )
        sum_dy_xhat = synchronize(
            allreduce_async((grad_out * xhat).sum(dims).contiguous(), op=Sum)
        )
        gx = (
            weight.reshape(shape) * invstd.reshape(shape) / n
        ) * (
            n * grad_out
            - sum_dy.reshape(shape)
            - xhat * sum_dy_xhat.reshape(shape)
        )
        # weight/bias grads stay LOCAL, like ordinary parameter grads:
        # DistributedOptimizer reduces them
        gw = (grad_out * xhat).sum(dims)
        gb = grad_out.sum(dims)
        return gx, gw, gb, None


class SyncBatchNorm(torch.nn.modules.batchnorm._BatchNorm):
    """Batch norm synchronized across all ranks (reference
    hvd.SyncBatchNorm, horovod/torch/sync_batch_norm.py).  Statistics are
    computed over the GLOBAL batch via engine allreduces; eval mode and
    worlds of one fall back to the plain local op."""

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected at least 2D input, got {x.dim()}D")

    def forward(self, x):
        self._check_input_dim(x)
        if not self.training or size() == 1:
            return super().forward(x)
        out, mean, var = _SyncBatchNormFn.apply(
            x, self.weight, self.bias, self.eps
        )
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked += 1
                # momentum=None means cumulative moving average
                # (torch._BatchNorm.forward contract)
                if self.momentum is None:
                    m = 1.0 / float(self.num_batches_tracked)
                else:
                    m = self.momentum
                n = float(x.numel() // x.shape[1]) * size()
                # torch convention: running_var stores the UNBIASED
                # variance even though normalization uses the biased one
                unbiased = var * (n / max(n - 1.0, 1.0))
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(unbiased, alpha=m)
        return out


# ---------------------------------------------------------------------------
# state replication (reference torch/__init__.py:452-648)
# ---------------------------------------------------------------------------


def broadcast_parameters(
    params: Union[dict, Iterable[Tuple[str, torch.Tensor]]],
    root_rank: int = 0,
) -> None:
    """In-place broadcast of a state_dict or named_parameters iterable
    (reference torch/__init__.py:452-508), one named engine op each."""
    items = sorted(params.items()) if isinstance(params, dict) \
        else list(params)
    handles = [eager.broadcast_async_(p, root_rank, f"broadcast.{name}")
               for name, p in items if isinstance(p, torch.Tensor)]
    for handle in handles:
        synchronize(handle)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Broadcast optimizer state in place (reference
    torch/__init__.py:511-605: tensor state broadcast + scalar state via
    object broadcast)."""
    tensors = []
    scalars = {}
    for pid, pstate in optimizer.state_dict().get("state", {}).items():
        for key, val in pstate.items():
            if isinstance(val, torch.Tensor):
                tensors.append((f"opt.{pid}.{key}", val))
            else:
                scalars[(pid, key)] = val
    broadcast_parameters(tensors, root_rank)
    scalars = broadcast_object(scalars, root_rank)
    sd = optimizer.state_dict()
    for (pid, key), val in scalars.items():
        if pid in sd.get("state", {}):
            sd["state"][pid][key] = val
    optimizer.load_state_dict(sd)


def broadcast_object(obj: Any, root_rank: int = 0) -> Any:
    """reference: hvd.broadcast_object (torch/__init__.py:608-648)."""
    from ..optim import broadcast_object as _bo  # noqa: PLC0415

    return _bo(obj, root_rank=root_rank)
