"""Keras migration frontend — the analog of ``horovod.tensorflow.keras``
(counterpart of ``horovod_tpu/interop/tf_keras.py``).

Reference surface (horovod/tensorflow/keras/__init__.py + the shared
_keras impl): ``hvd.DistributedOptimizer`` for ``model.compile``,
``hvd.callbacks.BroadcastGlobalVariablesCallback`` /
``MetricAverageCallback`` / ``LearningRateScheduleCallback`` /
``LearningRateWarmupCallback`` for ``model.fit(callbacks=[...])``
(_keras/callbacks.py:20-185), and ``hvd.load_model`` which restores a
saved model with its optimizer re-wrapped (_keras/__init__.py:113-128).

A migrating user changes ``import horovod.tensorflow.keras as hvd`` to
``import horovod_tpu_torch.interop.tf_keras as hvd`` and keeps the rest.
Collectives execute on the port's eager engine over its gloo host plane
(:mod:`.tf`), instead of MPI/NCCL.
"""

from __future__ import annotations

import numpy as np
import tensorflow as tf

from ..basics import (  # noqa: F401  (re-exported API surface)
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from . import tf as _hvd_tf
from ._host import init  # noqa: F401
from .tf import (  # noqa: F401
    Adasum,
    Average,
    Compression,
    DistributedOptimizer,
    Sum,
    allgather,
    allreduce,
    broadcast,
    broadcast_object,
    broadcast_variables,
)

__all__ = [
    "init", "shutdown", "is_initialized",
    "rank", "size", "local_rank", "local_size",
    "DistributedOptimizer", "Compression",
    "allreduce", "allgather", "broadcast",
    "broadcast_object", "broadcast_variables",
    "load_model", "callbacks",
    "Average", "Sum", "Adasum",
]


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=Compression.none):
    """Load a saved Keras model with its optimizer wrapped in
    :func:`DistributedOptimizer` (reference _keras/__init__.py:113-128 —
    there via ``custom_objects`` class substitution at deserialization
    time; here by re-wrapping the restored optimizer instance, the one
    stable seam across Keras generations).

    ``custom_optimizers``/``custom_objects`` pass through to Keras
    deserialization for models using custom classes.
    """
    objs = dict(custom_objects or {})
    # A model saved with a wrapped optimizer serializes as
    # "Distributed<Base>"; register deserializers for the stock optimizers
    # and any user-provided ones (reference passes exactly such a
    # custom_objects map, _keras/__init__.py:113-128).
    bases = [
        getattr(tf.keras.optimizers, n)
        for n in ("SGD", "Adam", "AdamW", "RMSprop", "Adagrad", "Adadelta",
                  "Adamax", "Nadam", "Ftrl", "Lion")
        if hasattr(tf.keras.optimizers, n)
    ] + list(custom_optimizers or [])
    for base in bases:
        objs.setdefault(
            f"Distributed{base.__name__}",
            _hvd_tf._make_distributed_keras_class(base, compression),
        )
        # op=Adasum wraps serialize as "Adasum<Base>"
        objs.setdefault(
            f"Adasum{base.__name__}",
            _hvd_tf._make_adasum_keras_class(base, compression),
        )
    for opt_cls in custom_optimizers or []:
        objs.setdefault(opt_cls.__name__, opt_cls)
    model = tf.keras.models.load_model(filepath, custom_objects=objs)
    opt = getattr(model, "optimizer", None)
    if opt is not None and not getattr(opt, "_hvd_wrapped", False):
        # saved with a PLAIN optimizer: wrap the restored instance
        wrapped = DistributedOptimizer(opt, compression=compression)
        try:
            model.optimizer = wrapped
        except AttributeError:  # older Keras: optimizer set via compile only
            # Recompile with the FULL restored compile config (metrics,
            # loss_weights, ...) — not just the loss.
            try:
                cfg = model.get_compile_config()
                cfg["optimizer"] = wrapped
                model.compile_from_config(cfg)
            except Exception:
                model.compile(optimizer=wrapped, loss=model.loss)
    return model


# ---------------------------------------------------------------------------
# model.fit callbacks (reference _keras/callbacks.py:20-185)
# ---------------------------------------------------------------------------


class _CallbacksNamespace:
    """Holder so ``hvd.callbacks.X`` reads like the reference module."""


def _get_lr_var(optimizer):
    lr = getattr(optimizer, "learning_rate", None)
    if lr is None:
        lr = getattr(optimizer, "lr", None)
    return lr


def _set_lr(optimizer, value) -> None:
    lr = _get_lr_var(optimizer)
    if hasattr(lr, "assign"):
        lr.assign(value)
    else:  # plain float attribute
        optimizer.learning_rate = value


def _lr_value(optimizer) -> float:
    lr = _get_lr_var(optimizer)
    try:
        return float(lr.numpy())
    except AttributeError:
        return float(lr)


class BroadcastGlobalVariablesCallback(tf.keras.callbacks.Callback):
    """Broadcast model + optimizer state from ``root_rank`` after the first
    batch (reference _keras/callbacks.py:20-44: on_batch_end once, so
    deferred-build variables exist)."""

    def __init__(self, root_rank: int = 0, device: str = ""):
        super().__init__()
        self.root_rank = root_rank
        self.broadcast_done = False
        del device

    def on_batch_end(self, batch, logs=None):
        if self.broadcast_done:
            return
        variables = list(self.model.variables)
        opt = getattr(self.model, "optimizer", None)
        if opt is not None:
            ov = getattr(opt, "variables", None)
            if callable(ov):  # legacy Keras: a method
                ov = ov()
            variables += list(ov or [])
        broadcast_variables(variables, root_rank=self.root_rank)
        self.broadcast_done = True


class MetricAverageCallback(tf.keras.callbacks.Callback):
    """Average epoch metrics over all ranks before other callbacks (model
    checkpointing, early stopping, LR schedules) read them (reference
    _keras/callbacks.py:46-72)."""

    def __init__(self, device: str = ""):
        super().__init__()
        del device

    def _average_metrics_in_place(self, logs):
        if not logs:
            return
        # Sorted keys => identical call order on every rank, so the
        # engine's sequence names pair the metric allreduces correctly.
        for k in sorted(logs.keys()):
            v = logs[k]
            if isinstance(v, (int, float, np.floating, np.integer)):
                avg = allreduce(
                    tf.constant(float(v), tf.float32), op=Average
                )
                logs[k] = float(avg.numpy())

    def on_epoch_end(self, epoch, logs=None):
        self._average_metrics_in_place(logs)


class LearningRateScheduleCallback(tf.keras.callbacks.Callback):
    """Multiply the initial LR by ``multiplier(epoch)`` — constant within
    an epoch (staircase) or smoothly per batch (reference
    _keras/callbacks.py:74-132)."""

    def __init__(self, initial_lr: float, multiplier, start_epoch: int = 0,
                 end_epoch=None, staircase: bool = True,
                 momentum_correction: bool = True, steps_per_epoch=None):
        super().__init__()
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.steps_per_epoch = steps_per_epoch
        self.current_epoch = 0
        self._restore_momentum = None
        if callable(multiplier):
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier

    def on_train_begin(self, logs=None):
        # Auto-fill the per-batch resolution from Keras's own params, like
        # the reference does (_keras/callbacks.py on_train_begin reads
        # self.params['steps']) — without it a non-staircase schedule
        # would silently never adjust the LR.
        if not self.staircase and not self.steps_per_epoch:
            self.steps_per_epoch = (self.params or {}).get("steps")
            if not self.steps_per_epoch:
                raise ValueError(
                    "LearningRateScheduleCallback(staircase=False) could "
                    "not infer steps_per_epoch from model.fit; pass "
                    "steps_per_epoch= explicitly"
                )

    def _in_range(self, epoch) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def _adjust(self, epoch) -> None:
        if not self._in_range(int(epoch)):
            return
        opt = self.model.optimizer
        old_lr = _lr_value(opt)
        new_lr = self.initial_lr * self.multiplier(epoch)
        _set_lr(opt, new_lr)
        # Momentum correction (reference _keras/callbacks.py, after Goyal
        # et al. 2017): Keras folds lr into the velocity update, so an LR
        # change perturbs the effective velocity unless momentum is scaled
        # by new_lr/old_lr for the next update, then restored.
        if self.momentum_correction and old_lr > 0 and new_lr != old_lr:
            m = getattr(opt, "momentum", None)
            if isinstance(m, (int, float)) and m:
                self._restore_momentum = float(m)
                opt.momentum = float(m) * new_lr / old_lr

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch
        if self.staircase:
            self._adjust(epoch)

    def on_batch_begin(self, batch, logs=None):
        if not self.staircase and self.steps_per_epoch:
            self._adjust(self.current_epoch + batch / self.steps_per_epoch)

    def on_batch_end(self, batch, logs=None):
        if self._restore_momentum is not None:
            self.model.optimizer.momentum = self._restore_momentum
            self._restore_momentum = None

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs["lr"] = _lr_value(self.model.optimizer)


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Ramp the LR from ``initial_lr / size()`` to ``initial_lr`` over the
    first ``warmup_epochs`` (the large-batch warmup recipe the reference
    implements at _keras/callbacks.py:135-185, after Goyal et al. 2017)."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 momentum_correction: bool = True, steps_per_epoch=None,
                 verbose: int = 0):
        world = max(size(), 1)

        def multiplier(epoch):
            if warmup_epochs <= 0:
                return 1.0
            # epoch is fractional (per-batch); linear 1/world -> 1
            frac = min(float(epoch) / warmup_epochs, 1.0)
            return 1.0 / world + (1.0 - 1.0 / world) * frac

        super().__init__(
            initial_lr, multiplier, start_epoch=0, end_epoch=warmup_epochs,
            staircase=False, momentum_correction=momentum_correction,
            steps_per_epoch=steps_per_epoch,
        )
        self.verbose = verbose

    def on_epoch_end(self, epoch, logs=None):
        super().on_epoch_end(epoch, logs)
        if epoch == self.end_epoch - 1 and self.verbose and rank() == 0:
            print(
                f"Epoch {epoch + 1}: finished gradual learning rate warmup "
                f"to {_lr_value(self.model.optimizer):g}."
            )


callbacks = _CallbacksNamespace()
callbacks.BroadcastGlobalVariablesCallback = BroadcastGlobalVariablesCallback
callbacks.MetricAverageCallback = MetricAverageCallback
callbacks.LearningRateScheduleCallback = LearningRateScheduleCallback
callbacks.LearningRateWarmupCallback = LearningRateWarmupCallback

# The reference exposes the same callbacks from horovod.tensorflow.keras
# AND horovod.keras; mirror on the tf module for discoverability.
_hvd_tf.callbacks = callbacks
