"""``horovod.mxnet``-compatible API on host MXNet NDArrays (counterpart of
``horovod_tpu/interop/mxnet.py``).

The migration surface of the reference's MXNet frontend
(horovod/mxnet/__init__.py:40-154, horovod/mxnet/mpi_ops.py:52-199):
``init/rank/size``, ``allreduce[_]``/``allgather``/``broadcast[_]`` with the
reference's ``average=``/``name=``/``priority=`` signature, a
``DistributedOptimizer`` that allreduces gradients inside ``update()`` and
folds the average into ``rescale_grad``, a gluon ``DistributedTrainer``
whose ``_allreduce_grads`` rides our engine, and ``broadcast_parameters``
with the deferred-init broadcast hook.

MXNet here is the *host* framework — NDArrays are staged through numpy to
CPU torch tensors for the port's eager engine, over its gloo host plane,
so :func:`init` opens the world on the CPU unless told otherwise.
Upstream MXNet is EOL, so ``mxnet`` is imported lazily: every entry point
works the moment an ``mxnet``-shaped module is importable and raises a
clear error otherwise.
The wrapper logic itself is exercised in CI against a duck-typed stand-in
(tests/test_mxnet_interop.py) — the same logic-vs-integration split the
reference gets from crossing its CI images.

Differences from the reference, by design:
* ``priority`` is accepted and ignored: the reference forwards it to the
  MXNet engine's dependency scheduler; our engine's negotiation order is
  the deterministic cross-rank order, which priorities must not perturb.
* ``DistributedOptimizer``/``DistributedTrainer`` are factories returning
  instances of dynamically-created subclasses (``mx.optimizer.Optimizer``
  is only subclassable once mxnet imports).
"""

from __future__ import annotations

import types
from typing import Optional

import numpy as np

from ..basics import (  # noqa: F401  (re-exported API surface)
    cross_rank,
    cross_size,
    gloo_built,
    gloo_enabled,
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
from ..ops.collectives import Average, Sum  # noqa: F401
from ._host import from_torch, init, to_torch  # noqa: F401

__all__ = [
    "init", "shutdown", "is_initialized",
    "rank", "size", "local_rank", "local_size", "cross_rank", "cross_size",
    "is_homogeneous",
    "mpi_built", "mpi_enabled", "mpi_threads_supported",
    "gloo_built", "gloo_enabled", "nccl_built",
    "allreduce", "allreduce_", "allgather", "broadcast", "broadcast_",
    "DistributedOptimizer", "DistributedTrainer", "broadcast_parameters",
]


def _mx():
    try:
        import mxnet  # noqa: PLC0415
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.interop.mxnet needs an importable `mxnet` "
            "module (upstream MXNet is EOL)."
        ) from e
    return mxnet


def _to_np(tensor) -> np.ndarray:
    return np.asarray(tensor.asnumpy())


def _run(op, tensor, *args) -> np.ndarray:
    """``op(torch_tensor, *args)`` of the eager engine on the NDArray's
    values, back as numpy in their dtype."""
    value = _to_np(tensor)
    return from_torch(op(to_torch(value), *args), value.dtype)


def _write_back(tensor, value: np.ndarray):
    # NDArray in-place assignment, in the NDArray's shape
    tensor[:] = value.reshape(tensor.shape)
    return tensor


def _new_like(tensor, value: np.ndarray):
    # Keep the source NDArray's context (reference mxnet/mpi_ops.py
    # allocates outputs with ctx=tensor.context): without it, GPU-array
    # collectives would silently return default-context (CPU) outputs.
    mx = _mx()
    ctx = getattr(tensor, "context", None)
    if ctx is not None:
        return mx.nd.array(value, dtype=value.dtype, ctx=ctx)
    return mx.nd.array(value, dtype=value.dtype)


# ---------------------------------------------------------------------------
# collectives (reference mxnet/mpi_ops.py:52-199 signatures)
# ---------------------------------------------------------------------------


def allreduce(tensor, average: bool = True, name: Optional[str] = None,
              priority: int = 0):
    """Out-of-place allreduce of an NDArray (reference mpi_ops.py:52-91)."""
    del priority  # see module docstring
    out = _run(eager.allreduce, tensor, Average if average else Sum, name)
    return _new_like(tensor, out)


def allreduce_(tensor, average: bool = True, name: Optional[str] = None,
               priority: int = 0):
    """In-place allreduce (reference mpi_ops.py:94-129)."""
    del priority
    out = _run(eager.allreduce, tensor, Average if average else Sum, name)
    return _write_back(tensor, out)


def allgather(tensor, name: Optional[str] = None, priority: int = 0):
    """Concatenate every rank's NDArray along dim 0
    (reference mpi_ops.py:132-152)."""
    del priority
    return _new_like(tensor, _run(eager.allgather, tensor, name))


def broadcast(tensor, root_rank: int, name: Optional[str] = None,
              priority: int = 0):
    """Out-of-place broadcast (reference mpi_ops.py:155-176)."""
    del priority
    return _new_like(tensor, _run(eager.broadcast, tensor, root_rank, name))


def broadcast_(tensor, root_rank: int, name: Optional[str] = None,
               priority: int = 0):
    """In-place broadcast (reference mpi_ops.py:179-199)."""
    del priority
    return _write_back(tensor, _run(eager.broadcast, tensor, root_rank, name))


# ---------------------------------------------------------------------------
# optimizer / trainer wrappers (reference mxnet/__init__.py:40-108)
# ---------------------------------------------------------------------------


def _do_allreduce(index, grad):
    """Sum-allreduce one update's gradient(s); the average lives in the
    optimizer's rescale_grad /= size() (reference mxnet/__init__.py:43-61)."""
    if size() == 1:
        return
    if isinstance(index, (tuple, list)):
        for i in range(len(index)):
            allreduce_(grad[i], average=False, name=str(index[i]),
                       priority=-i)
    else:
        allreduce_(grad, average=False, name=str(index))


def DistributedOptimizer(optimizer):
    """Wrap an ``mx.optimizer.Optimizer``: every ``update`` first
    sum-allreduces the gradient, and ``rescale_grad`` is divided by world
    size so the reduction averages (reference mxnet/__init__.py:40-78)."""
    mx = _mx()

    class _DistributedOptimizer(mx.optimizer.Optimizer):
        def __init__(self, wrapped):
            # No super().__init__: state lives in (and every attribute
            # delegates to) the wrapped optimizer, reference-style.
            self._optimizer = wrapped
            self._optimizer.rescale_grad /= size()

        def __getattr__(self, item):
            return getattr(self._optimizer, item)

        def create_state_multi_precision(self, index, weight):
            return self._optimizer.create_state_multi_precision(index, weight)

        def update(self, index, weight, grad, state):
            _do_allreduce(index, grad)
            self._optimizer.update(index, weight, grad, state)

        def update_multi_precision(self, index, weight, grad, state):
            _do_allreduce(index, grad)
            self._optimizer.update_multi_precision(index, weight, grad, state)

        def set_learning_rate(self, lr):
            self._optimizer.set_learning_rate(lr)

        def set_lr_mult(self, args_lr_mult):
            self._optimizer.set_lr_mult(args_lr_mult)

        def set_wd_mult(self, args_wd_mult):
            self._optimizer.set_wd_mult(args_wd_mult)

    return _DistributedOptimizer(optimizer)


def DistributedTrainer(params, optimizer, optimizer_params=None):
    """gluon Trainer whose ``_allreduce_grads`` uses our engine instead of
    kvstore push/pull, with the average folded into ``_scale``
    (reference mxnet/__init__.py:86-108)."""
    mx = _mx()

    if type(optimizer).__name__ == "_DistributedOptimizer":
        optimizer = optimizer._optimizer
        import warnings  # noqa: PLC0415

        warnings.warn(
            "DistributedTrainer does not take DistributedOptimizer as its "
            "optimizer. We have unwrapped it for you."
        )

    class _DistributedTrainer(mx.gluon.Trainer):
        def __init__(self, params, optimizer, optimizer_params):
            super().__init__(
                params, optimizer, optimizer_params=optimizer_params,
                kvstore=None,
            )
            self._scale /= size()

        def _allreduce_grads(self):
            if size() == 1:
                return
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    allreduce_(param.list_grad()[0], average=False,
                               name=param.name, priority=-i)

    return _DistributedTrainer(params, optimizer, optimizer_params)


# ---------------------------------------------------------------------------
# parameter broadcast (reference mxnet/__init__.py:111-154)
# ---------------------------------------------------------------------------


def _append_broadcast_init(param, root_rank):
    init_impl = param._init_impl

    def wrapped_init_impl(self, *args, **kwargs):
        init_impl(*args, **kwargs)
        broadcast_(self.data(), root_rank=root_rank, name=self.name)

    return wrapped_init_impl


def broadcast_parameters(params, root_rank: int = 0):
    """Broadcast ``Module.get_params()`` dicts or gluon ``ParameterDict``s
    from root_rank; deferred-init gluon parameters get a post-init
    broadcast hook (reference mxnet/__init__.py:111-154)."""
    if size() == 1:
        return
    tensors, names = [], []
    if isinstance(params, dict):
        names, tensors = zip(*sorted(params.items())) if params else ((), ())
    elif hasattr(params, "items"):  # gluon ParameterDict (duck-typed)
        mx = _mx()
        deferred_error = mx.gluon.parameter.DeferredInitializationError
        for name, p in sorted(params.items()):
            try:
                tensors.append(p.data())
                names.append(name)
            except deferred_error:
                p._init_impl = types.MethodType(
                    _append_broadcast_init(p, root_rank), p
                )
    else:
        raise ValueError(f"invalid params of type: {type(params)}")
    for tensor, name in zip(tensors, names):
        broadcast_(tensor, root_rank, name=str(name))
