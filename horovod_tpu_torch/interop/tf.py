"""``horovod.tensorflow``-compatible API on host TF tensors (counterpart
of ``horovod_tpu/interop/tf.py``).

A drop-in migration surface for reference users
(horovod/tensorflow/__init__.py, horovod/tensorflow/mpi_ops.py): the same
``init/rank/size``, ``allreduce`` (with the IndexedSlices -> allgather
dispatch, reference tensorflow/__init__.py:74-89), ``DistributedOptimizer``
(:266-311 legacy / keras routing :451-470), ``DistributedGradientTape``
(:474-531), and ``broadcast_variables`` (:166-191), executed by the port's
eager engine (``ops/eager.py``).

TensorFlow here is the *host* framework — CPU tensors in, CPU tensors
out: each collective takes the tensor through numpy to a CPU torch tensor,
runs the eager op over the engine's gloo host plane, and comes back the
same way (bf16 and fp16 stay 2 bytes on the wire).  So :func:`init` opens
the world on the CPU unless told otherwise.  Collectives are wrapped in
``tf.py_function`` so they also run from inside ``tf.function`` graphs
(the reference's AsyncOp kernels are graph ops for the same reason,
tensorflow/mpi_ops.cc:287-321).  ``tensorflow`` is imported here, at
module level; ``import horovod_tpu_torch`` never imports this module.

Gradient parity: ``tf.custom_gradient`` wrappers implement the reference's
registered gradients — allreduce -> allreduce (tensorflow/mpi_ops.py
``_allreduce_grad``), allgather -> reduce + slice by rank offsets,
broadcast -> reduce, zero on non-root ranks.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import tensorflow as tf

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
from ..ops.collectives import Adasum, Average, Max, Min, ReduceOp, Sum  # noqa: F401
from ..optim import broadcast_object as _broadcast_object
from ._host import from_torch, init, to_torch  # noqa: F401

__all__ = [
    "init", "shutdown", "is_initialized",
    "rank", "size", "local_rank", "local_size", "cross_rank", "cross_size",
    "is_homogeneous",
    "mpi_built", "mpi_enabled", "mpi_threads_supported",
    "gloo_built", "gloo_enabled", "nccl_built",
    "ReduceOp", "Average", "Sum", "Adasum", "Min", "Max",
    "allreduce", "allgather", "broadcast", "alltoall",
    "join", "barrier",
    "broadcast_variables", "broadcast_global_variables",
    "BroadcastGlobalVariablesHook",
    "broadcast_object",
    "DistributedOptimizer", "DistributedGradientTape",
    "Compression",
]


# ---------------------------------------------------------------------------
# tensor conversion + compression
# ---------------------------------------------------------------------------

# Halves ride the wire natively: the engine is dtype-native (bf16/f16 at
# 2 B/elt — the analog of the reference's custom fp16 MPI op,
# half.cc:42-78), and TF's bf16 .numpy() (an ml_dtypes array) crosses to
# torch by a 16-bit view, so Compression.fp16 actually halves wire bytes.


class Compression:
    """Gradient compression (reference tensorflow/compression.py:20-74):
    ``none`` passes through, ``fp16`` casts to half for the wire and back
    after the reduction."""

    class none:  # noqa: N801 — reference spelling
        @staticmethod
        def compress(tensor):
            return tensor, None

        @staticmethod
        def decompress(tensor, ctx):
            return tensor

    class fp16:  # noqa: N801
        @staticmethod
        def compress(tensor):
            ctx = tensor.dtype
            if tensor.dtype.is_floating:
                tensor = tf.cast(tensor, tf.float16)
            return tensor, ctx

        @staticmethod
        def decompress(tensor, ctx):
            if ctx is not None and tensor.dtype != ctx:
                tensor = tf.cast(tensor, ctx)
            return tensor


# ---------------------------------------------------------------------------
# core collectives (graph-safe via py_function, custom gradients)
# ---------------------------------------------------------------------------

def _run_collective(fn, tensor: tf.Tensor, out_dtype=None,
                    preserve_shape: bool = True) -> tf.Tensor:
    """Run ``fn(torch_cpu_tensor) -> torch_cpu_tensor`` as a graph-safe op
    in the tensor's own dtype (halves stay halves on the wire).  Static
    shapes are restored by the caller (py_function erases them);
    ``preserve_shape`` puts the element shape right at run time, should
    the wire have flattened a 0-d scalar.  Allgather passes False: its dim
    0 legitimately changes."""
    in_dtype = tensor.dtype
    out_dtype = out_dtype or in_dtype

    def _impl(x):
        xnp = x.numpy()
        out = from_torch(fn(to_torch(xnp)), xnp.dtype)
        if (
            preserve_shape
            and out.shape != np.shape(xnp)
            and out.size == np.size(xnp)
        ):
            out = out.reshape(np.shape(xnp))
        return tf.convert_to_tensor(out)

    result = tf.py_function(_impl, [tensor], Tout=in_dtype)
    if out_dtype != in_dtype:
        result = tf.cast(result, out_dtype)
    return result


def _sanitize_name(name: Optional[str], fallback: str = "var") -> str:
    """TF variable name -> engine wire-name component.  One definition for
    every call site: eager and graph Adasum branches MUST produce identical
    keys for the same variable or cross-rank negotiation stalls."""
    return (name or fallback).replace(":", "_").replace("/", "_")


def _allreduce(tensor, name: Optional[str] = None, op: ReduceOp = Sum,
               prescale_factor: float = 1.0, postscale_factor: float = 1.0):
    """Sum-allreduce primitive (reference tensorflow/mpi_ops.py:93-117;
    averaging happens in framework code, tensorflow/__init__.py:76)."""
    tensor = tf.convert_to_tensor(tensor)
    name = name or eager._auto_name("HorovodAllreduce")

    @tf.custom_gradient
    def _fn(x):
        y = _run_collective(
            lambda v: eager.allreduce(
                v, op=op, name=name,
                prescale_factor=prescale_factor,
                postscale_factor=postscale_factor,
            ),
            x,
        )
        y.set_shape(x.shape)

        def grad(dy):
            # reference _allreduce_grad: the gradient of an allreduce is
            # the same allreduce of the gradients.
            return _allreduce(dy, name + "_grad", op,
                              prescale_factor, postscale_factor)

        return y, grad

    return _fn(tensor)


def allgather(tensor, name: Optional[str] = None):
    """Concatenate along dim 0 across ranks; ragged dim 0 supported
    (reference tensorflow/mpi_ops.py:120-142, sizes negotiated by the
    controller)."""
    tensor = tf.convert_to_tensor(tensor)
    name = name or eager._auto_name("HorovodAllgather")

    @tf.custom_gradient
    def _fn(x):
        y = _run_collective(
            lambda v: eager.allgather(v, name=name), x,
            preserve_shape=False,
        )
        y.set_shape([None] + list(x.shape[1:]))
        # Dynamic shape op, not the static x.shape[0]: under tf.function
        # with an unknown batch dim the static value is None.
        d0 = (tf.cast(tf.shape(x)[0], tf.int64)
              if x.shape.rank else tf.constant(1, tf.int64))

        def grad(dy):
            # reference allgather gradient: reduce the gathered grads and
            # slice out this rank's rows by the negotiated offsets.
            sizes = allgather(tf.reshape(d0, [1]), name + "_sizes")
            reduced = _allreduce(dy, name + "_grad", Sum)
            start = tf.reduce_sum(sizes[: rank()])
            trailing = tf.fill([tf.rank(reduced) - 1],
                               tf.constant(-1, tf.int64))
            begin = tf.concat(
                [[start], tf.zeros([tf.rank(reduced) - 1], tf.int64)], 0
            )
            return tf.slice(reduced, begin, tf.concat([[d0], trailing], 0))

        return y, grad

    return _fn(tensor)


def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    """Broadcast from root (reference tensorflow/mpi_ops.py:145-168)."""
    tensor = tf.convert_to_tensor(tensor)
    name = name or eager._auto_name("HorovodBroadcast")

    @tf.custom_gradient
    def _fn(x):
        y = _run_collective(
            lambda v: eager.broadcast(v, root_rank, name=name), x
        )
        y.set_shape(x.shape)

        def grad(dy):
            # reference broadcast gradient: reduce grads to the root,
            # other ranks contribute but receive zero.
            reduced = _allreduce(dy, name + "_grad", Sum)
            if rank() == root_rank:
                return reduced
            return tf.zeros_like(reduced)

        return y, grad

    return _fn(tensor)


def alltoall(tensor, name: Optional[str] = None):
    tensor = tf.convert_to_tensor(tensor)
    y = _run_collective(lambda v: eager.alltoall(v, name=name), tensor)
    y.set_shape([None] + list(tensor.shape[1:]))
    return y


def join() -> int:
    return eager.join()


def barrier() -> None:
    eager.barrier()


# ---------------------------------------------------------------------------
# user-facing allreduce with IndexedSlices dispatch
# ---------------------------------------------------------------------------

def allreduce(tensor, average=None, device_dense="", device_sparse="",
              compression=Compression.none, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0):
    """Allreduce a tf.Tensor or tf.IndexedSlices (reference
    tensorflow/__init__.py:43-118).  IndexedSlices become an allgather of
    values+indices; ``Average`` is Sum plus a divide in framework code;
    the ``device_*`` arguments are accepted for source compatibility and
    ignored (there is one host data plane)."""
    del device_dense, device_sparse
    if op is None:
        op = Sum if average is False else Average
    true_op = Sum if op == Average else op

    if isinstance(tensor, tf.IndexedSlices):
        if op == Adasum:
            raise NotImplementedError(
                "The Adasum reduction does not currently support sparse "
                "tensors. As a workaround please pass sparse_as_dense=True "
                "to DistributedOptimizer"
            )
        # reference tensorflow/__init__.py:74-89: two allgathers instead
        # of an allreduce on the represented dense tensor.
        values = allgather(tensor.values)
        indices = allgather(tensor.indices)
        if op == Average:
            values = values / tf.cast(size(), values.dtype)
        return tf.IndexedSlices(values, indices,
                                dense_shape=tensor.dense_shape)

    tensor = tf.convert_to_tensor(tensor)
    compressed, ctx = compression.compress(tensor)
    summed = _allreduce(compressed, None, true_op,
                        prescale_factor, postscale_factor)
    summed = compression.decompress(summed, ctx)
    if op == Average:
        return summed / tf.cast(size(), summed.dtype)
    return summed


# ---------------------------------------------------------------------------
# variable broadcast
# ---------------------------------------------------------------------------

def broadcast_variables(variables: Iterable[tf.Variable],
                        root_rank: int = 0) -> None:
    """Assign every variable its root-rank value (reference
    tensorflow/__init__.py:166-191 broadcast_global_variables /
    broadcast_variables)."""
    for i, var in enumerate(variables):
        name = _sanitize_name(getattr(var, "name", None), f"var.{i}")
        value = broadcast(
            tf.convert_to_tensor(var), root_rank, f"broadcast.{name}"
        )
        var.assign(tf.cast(value, var.dtype))


def broadcast_global_variables(root_rank: int = 0) -> None:
    """TF1-compat spelling: broadcast tf.compat.v1 global variables
    (reference tensorflow/__init__.py:129-147)."""
    try:
        variables = tf.compat.v1.global_variables()
    except AttributeError as exc:  # future TF without compat.v1
        raise NotImplementedError(
            "broadcast_global_variables requires tf.compat.v1; use "
            "broadcast_variables(model.variables, root_rank) instead"
        ) from exc
    broadcast_variables(variables, root_rank)


def broadcast_object(obj, root_rank: int = 0):
    """Arbitrary-object broadcast via the shared pickle path (reference
    torch/__init__.py:608-648; the TF frontend reuses it)."""
    return _broadcast_object(obj, root_rank)


try:
    _SessionRunHook = tf.compat.v1.train.SessionRunHook
except AttributeError:  # future TF without compat.v1
    _SessionRunHook = object


class BroadcastGlobalVariablesHook(_SessionRunHook):
    """tf.estimator / MonitoredSession hook that broadcasts all global
    variables from root_rank on session creation (reference
    tensorflow/__init__.py:194-227).  The broadcast itself runs through
    the eager engine when the session starts — the hook is the TF1-era
    scheduling shim around ``broadcast_variables``."""

    def __init__(self, root_rank: int, device: str = ""):
        super().__init__()
        self.root_rank = root_rank
        del device  # one host data plane (accepted for source compat)
        self._variables = None

    def begin(self):
        self._variables = list(tf.compat.v1.global_variables())

    def after_create_session(self, session, coord):
        del coord
        if not self._variables:
            return
        # Read current values through the session (graph mode has no
        # .numpy()), broadcast on the host values — all submitted async
        # first so N variables share negotiation cycles instead of paying
        # N sequential round-trips — and load results back via var.load.
        values = session.run(self._variables)
        futs = [
            eager.broadcast_async(
                to_torch(np.asarray(value)), self.root_rank, f"bghook.{i}"
            )
            for i, value in enumerate(values)
        ]
        for var, value, fut in zip(self._variables, values, futs):
            out = from_torch(eager.synchronize(fut), np.asarray(value).dtype)
            var.load(out.reshape(np.shape(value)), session)


# ---------------------------------------------------------------------------
# optimizers and tapes
# ---------------------------------------------------------------------------

def _make_allreduce_grads_fn(name, compression, sparse_as_dense, op):
    """reference tensorflow/__init__.py:230-251."""

    def _one(g):
        if g is None:
            return None
        if sparse_as_dense and isinstance(g, tf.IndexedSlices):
            g = tf.convert_to_tensor(g)
        return allreduce(g, compression=compression, op=op)

    def allreduce_grads(grads):
        # Preserve the caller's structure: tape.gradient with a single
        # source returns a bare tensor, not a list.
        if isinstance(grads, (list, tuple)):
            return type(grads)(_one(g) for g in grads)
        return _one(grads)

    return allreduce_grads


try:
    _LegacyOptimizer = tf.compat.v1.train.Optimizer
except AttributeError:
    _LegacyOptimizer = None


if _LegacyOptimizer is not None:
    class _DistributedOptimizer(_LegacyOptimizer):
        """Legacy-graph optimizer wrapper: allreduce inside
        compute_gradients (reference tensorflow/__init__.py:266-311)."""

        def __init__(self, optimizer, name=None, use_locking=False,
                     compression=Compression.none, sparse_as_dense=False,
                     op=Average):
            if name is None:
                name = f"Distributed{type(optimizer).__name__}"
            super().__init__(name=name, use_locking=use_locking)
            self._optimizer = optimizer
            self._allreduce_grads = _make_allreduce_grads_fn(
                name, compression, sparse_as_dense, op
            )

        def compute_gradients(self, *args, **kwargs):
            gradients = self._optimizer.compute_gradients(*args, **kwargs)
            if size() > 1:
                grads, variables = zip(*gradients)
                avg_grads = self._allreduce_grads(grads)
                return list(zip(avg_grads, variables))
            return gradients

        def apply_gradients(self, *args, **kwargs):
            return self._optimizer.apply_gradients(*args, **kwargs)

        def get_slot(self, *args, **kwargs):
            return self._optimizer.get_slot(*args, **kwargs)

        def get_slot_names(self, *args, **kwargs):
            return self._optimizer.get_slot_names(*args, **kwargs)

        def variables(self, *args, **kwargs):
            return self._optimizer.variables(*args, **kwargs)


def _make_distributed_keras_class(base_cls, compression=Compression.none,
                                  sparse_as_dense=False, op=Average):
    """Build the ``Distributed<Base>`` Keras optimizer class: allreduce
    inside apply_gradients (reference _keras/__init__.py:20-87 overrides
    gradient aggregation; modern Keras makes apply_gradients the one
    stable seam).  Also used by tf_keras.load_model as the
    ``custom_objects`` entry that deserializes saved wrapped optimizers
    (reference _keras/__init__.py:113-128)."""
    allreduce_grads = _make_allreduce_grads_fn(
        "DistributedKeras", compression, sparse_as_dense, op
    )

    class _DistributedKerasOptimizer(base_cls):
        _hvd_wrapped = True

        def apply_gradients(self, grads_and_vars, *args, **kwargs):
            if size() > 1:
                grads_and_vars = list(grads_and_vars)
                grads = [g for g, _ in grads_and_vars]
                variables = [v for _, v in grads_and_vars]
                grads = allreduce_grads(grads)
                grads_and_vars = list(zip(grads, variables))
            return super().apply_gradients(grads_and_vars, *args, **kwargs)

    _DistributedKerasOptimizer.__name__ = f"Distributed{base_cls.__name__}"
    return _DistributedKerasOptimizer


def _wrap_keras_optimizer(optimizer, compression, sparse_as_dense, op):
    cls = _make_distributed_keras_class(
        optimizer.__class__, compression, sparse_as_dense, op
    )
    return cls.from_config(optimizer.get_config())


def _var_key(v):
    """Hashable identity for tf and Keras-3 variables alike (Keras's
    backend Variable has no .ref())."""
    ref = getattr(v, "ref", None)
    return ref() if callable(ref) else id(v)


def _snapshot_starts(store: dict, variables):
    """Get-or-create the per-variable delta_start buffers (≙ the
    reference's slots) and snapshot the current values into them.  Shared
    by both Adasum wrappers so the slot protocol lives in one place."""
    starts = []
    for v in variables:
        key = _var_key(v)
        if key not in store:
            store[key] = tf.Variable(
                tf.convert_to_tensor(v), trainable=False
            )
        starts.append(store[key])
    for v, s in zip(variables, starts):
        s.assign(v)
    return starts


def _adasum_reduce_deltas(compression, variables, starts):
    """Adasum-allreduce ``var - start`` per variable and set
    ``var = start + reduced`` (the delta exchange of the reference's
    _DistributedAdasumOptimizer, tensorflow/__init__.py:345-360).

    Eager mode submits every delta asynchronously before draining any —
    the engine negotiates/fuses them in the same cycles instead of paying
    N sequential collective latencies.  Under ``tf.function`` tracing the
    tensors are symbolic, so the graph-safe (py_function) allreduce runs
    per variable."""
    if tf.executing_eagerly():
        pending = []
        for i, (v, s) in enumerate(zip(variables, starts)):
            comp, dctx = compression.compress(v - s)
            # Key = index + identity.  The index disambiguates Keras-3's
            # unscoped duplicate names ('kernel', 'bias', 'kernel', ...),
            # which the engine would reject as duplicate in-flight names;
            # the appended variable name keeps cross-rank mispairing
            # DETECTABLE: if ranks filtered different None grads, their
            # name sets differ and negotiation stalls loudly instead of
            # Adasum-reducing unrelated same-shaped deltas silently.
            ident = _sanitize_name(getattr(v, "name", ""))
            wire = comp.numpy()
            fut = eager.allreduce_async(
                to_torch(wire), Adasum, f"adasum.delta.{i}.{ident}"
            )
            pending.append((v, s, comp.dtype, wire.dtype, dctx, fut))
        for v, s, wire_dtype, np_dtype, dctx, fut in pending:
            reduced = tf.reshape(
                tf.cast(tf.convert_to_tensor(
                    from_torch(eager.synchronize(fut), np_dtype)),
                    wire_dtype),
                v.shape,
            )
            s.assign_add(
                tf.cast(compression.decompress(reduced, dctx), s.dtype)
            )
            v.assign(s)
    else:
        for i, (v, s) in enumerate(zip(variables, starts)):
            comp, dctx = compression.compress(v - s)
            # Same explicit index+identity key as the eager branch: without
            # it the graph branch would fall back to per-process auto
            # sequence names, pairing deltas across ranks only by trace
            # order (asymmetric retracing would mispair silently).
            ident = _sanitize_name(getattr(v, "name", ""))
            reduced = _allreduce(comp, f"adasum.delta.{i}.{ident}",
                                 op=Adasum)
            s.assign_add(
                tf.cast(compression.decompress(reduced, dctx), s.dtype)
            )
            v.assign(s)


class _DistributedAdasumOptimizer:
    """Delta-reducing Adasum wrapper for LEGACY optimizers (reference
    tensorflow/__init__.py:313-407).  The reference builds this from TF1
    slot machinery + ``tf.cond``; the TF2-idiomatic shape is imperative:
    snapshot each variable before the wrapped optimizer's update,
    Adasum-allreduce the update *delta*, and set
    ``var = start + reduced_delta``.  Keras optimizers get a real Keras
    subclass instead (``_make_adasum_keras_class``) so ``model.compile``
    keeps working."""

    _hvd_wrapped = True

    def __init__(self, optimizer, compression=Compression.none):
        self._opt = optimizer
        self._compression = compression
        self._starts = {}  # var.ref() -> delta_start variable (≙ slot)

    def compute_gradients(self, *args, **kwargs):
        # deltas (not grads) are reduced — local grads pass through
        return self._opt.compute_gradients(*args, **kwargs)

    def apply_gradients(self, grads_and_vars, *args, **kwargs):
        if not tf.executing_eagerly():
            # The imperative assign/allreduce sequence below would build
            # dangling graph ops a session never fetches — the local update
            # would apply and ranks would silently diverge.  Refuse loudly.
            raise NotImplementedError(
                "op=Adasum with a legacy optimizer requires eager "
                "execution; under TF1 graph sessions wrap a Keras "
                "optimizer instead (the Adasum Keras subclass), or run "
                "the step eagerly."
            )
        gv = [(g, v) for g, v in grads_and_vars if g is not None]
        variables = [v for _, v in gv]
        starts = _snapshot_starts(self._starts, variables)
        result = self._opt.apply_gradients(gv, *args, **kwargs)
        if size() > 1:
            _adasum_reduce_deltas(self._compression, variables, starts)
        return result

    def minimize(self, loss, global_step=None, var_list=None,
                 gate_gradients=None, aggregation_method=None,
                 colocate_gradients_with_ops=False, name=None,
                 grad_loss=None):
        # Explicit with the TF1 signature, so __getattr__ can't route to
        # the inner optimizer's minimize and bypass the delta exchange —
        # and global_step/name actually reach apply_gradients.
        cg_kwargs = dict(
            var_list=var_list,
            aggregation_method=aggregation_method,
            colocate_gradients_with_ops=colocate_gradients_with_ops,
            grad_loss=grad_loss,
        )
        if gate_gradients is not None:
            cg_kwargs["gate_gradients"] = gate_gradients
        grads_and_vars = self._opt.compute_gradients(loss, **cg_kwargs)
        return self.apply_gradients(
            grads_and_vars, global_step=global_step, name=name
        )

    def get_slot(self, *args, **kwargs):
        return self._opt.get_slot(*args, **kwargs)

    def get_slot_names(self, *args, **kwargs):
        return self._opt.get_slot_names(*args, **kwargs)

    def variables(self, *args, **kwargs):
        return self._opt.variables(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self._opt, item)


def _make_adasum_keras_class(base_cls, compression=Compression.none):
    """``Adasum<Base>``: a real Keras optimizer subclass (so
    ``model.compile`` accepts it) whose ``apply_gradients`` performs the
    delta-Adasum exchange around the base update."""

    class _AdasumKerasOptimizer(base_cls):
        _hvd_wrapped = True

        def apply_gradients(self, grads_and_vars, *args, **kwargs):
            gv = [(g, v) for g, v in grads_and_vars if g is not None]
            variables = [v for _, v in gv]
            if not hasattr(self, "_hvd_starts"):
                self._hvd_starts = {}
            starts = _snapshot_starts(self._hvd_starts, variables)
            result = super().apply_gradients(gv, *args, **kwargs)
            if size() > 1:
                _adasum_reduce_deltas(compression, variables, starts)
            return result

    _AdasumKerasOptimizer.__name__ = f"Adasum{base_cls.__name__}"
    return _AdasumKerasOptimizer


def DistributedOptimizer(optimizer, name=None, use_locking=False,
                         device_dense="", device_sparse="",
                         compression=Compression.none,
                         sparse_as_dense=False, backward_passes_per_step=1,
                         op=Average):
    """Wrap a TF optimizer so gradients are combined across ranks before
    they are applied (reference tensorflow/__init__.py:408-470)."""
    del device_dense, device_sparse
    if backward_passes_per_step > 1:
        raise ValueError(
            "backward_passes_per_step > 1 is not supported by the TF "
            "frontend; accumulate gradients before apply_gradients"
        )
    if op == Adasum:
        # the reference factory likewise diverts Adasum to the
        # delta-reducing optimizer (tensorflow/__init__.py:453-459); a
        # Keras optimizer gets a Keras subclass so model.compile accepts it
        if not (_LegacyOptimizer is not None
                and isinstance(optimizer, _LegacyOptimizer)) and hasattr(
                    optimizer, "get_config"):
            cls = _make_adasum_keras_class(optimizer.__class__, compression)
            return cls.from_config(optimizer.get_config())
        return _DistributedAdasumOptimizer(optimizer, compression)
    if _LegacyOptimizer is not None and isinstance(optimizer,
                                                   _LegacyOptimizer):
        return _DistributedOptimizer(optimizer, name, use_locking,
                                     compression, sparse_as_dense, op)
    if hasattr(optimizer, "apply_gradients") and hasattr(optimizer,
                                                         "get_config"):
        return _wrap_keras_optimizer(optimizer, compression,
                                     sparse_as_dense, op)
    raise ValueError(
        "Provided optimizer doesn't inherit from either legacy TensorFlow "
        f"or Keras optimizer: {optimizer}"
    )


class _DistributedGradientTape(tf.GradientTape):
    """reference tensorflow/__init__.py:474-493."""

    def __init__(self, tape, compression, sparse_as_dense, op,
                 persistent=False, watch_accessed_variables=True):
        super().__init__(persistent=persistent,
                         watch_accessed_variables=watch_accessed_variables)
        self._tape = tape
        self._allreduce_grads = _make_allreduce_grads_fn(
            "DistributedGradientTape", compression, sparse_as_dense, op
        )

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *args):
        return self._tape.__exit__(*args)

    def watch(self, tensor):
        return self._tape.watch(tensor)

    def gradient(self, target, sources, output_gradients=None):
        gradients = self._tape.gradient(target, sources, output_gradients)
        if size() > 1:
            return self._allreduce_grads(gradients)
        return gradients


def DistributedGradientTape(gradtape, device_dense="", device_sparse="",
                            compression=Compression.none,
                            sparse_as_dense=False, op=Average):
    """Wrap a tf.GradientTape so .gradient() returns rank-combined grads
    (reference tensorflow/__init__.py:495-531)."""
    del device_dense, device_sparse
    return _DistributedGradientTape(
        gradtape, compression, sparse_as_dense, op,
        persistent=getattr(gradtape, "_persistent", False),
    )
