"""Training-loop callbacks (a port of ``horovod_tpu/callbacks.py``).

Reference: the shared Keras callback implementations
(horovod/_keras/callbacks.py:20-185): BroadcastGlobalVariablesCallback,
MetricAverageCallback, LearningRateScheduleCallback,
LearningRateWarmupCallback.  In PyTorch each takes its idiomatic form:

* broadcast  -> :func:`horovod_tpu_torch.broadcast_parameters` called at
  start (wrapped here as a callback object for loop frameworks that want
  one);
* metric averaging -> :func:`metric_average`, an allreduce of the port's
  collectives;
* LR schedules -> functions of the step with the reference's warmup and
  staircase semantics.  With the default ``base_lr=1.0`` a schedule
  returns the learning-rate *factor*, the form
  ``torch.optim.lr_scheduler.LambdaLR`` takes (the learning rate is then
  the optimizer's own times the factor); with the reference's
  ``base_lr`` it returns the learning rate, as the reference's does.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .basics import size
from .ops.collectives import Average, allreduce

__all__ = [
    "BroadcastGlobalVariablesCallback",
    "MetricAverageCallback",
    "metric_average",
    "LearningRateScheduleCallback",
    "LearningRateWarmupCallback",
    "warmup_schedule",
    "multiplier_schedule",
]


def metric_average(value, name: Optional[str] = None):
    """Average a metric across workers (reference: MetricAverageCallback,
    _keras/callbacks.py:46-72, which allreduces epoch metrics).  A tensor
    comes back a tensor; a Python number comes back a float.  ``name`` is
    the reference's (its engine's tensor name); the port's allreduce
    needs none."""
    del name
    if isinstance(value, torch.Tensor):
        return allreduce(value, op=Average)
    from .basics import device  # noqa: PLC0415

    t = torch.tensor(float(value), dtype=torch.float64, device=device())
    return float(allreduce(t, op=Average))


class BroadcastGlobalVariablesCallback:
    """Broadcast initial state from root once, at the first step
    (reference: _keras/callbacks.py:20-44, fires on_batch_end of batch 0).
    Takes a module's ``state_dict()`` (or any dict / list of tensors
    ``broadcast_parameters`` takes), broadcast in place."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank
        self._done = False

    def __call__(self, params):
        from .optim import broadcast_parameters  # noqa: PLC0415

        if self._done:
            return params
        self._done = True
        broadcast_parameters(params, self.root_rank)
        return params


class MetricAverageCallback:
    """Average a dict of metrics across workers at epoch end
    (reference: _keras/callbacks.py:46-72)."""

    def __call__(self, metrics: dict) -> dict:
        return {k: metric_average(v, name=k) for k, v in metrics.items()}


def warmup_schedule(
    base_lr: float = 1.0,
    *,
    warmup_epochs: float = 5.0,
    steps_per_epoch: int,
    scale: Optional[float] = None,
) -> Callable[[int], float]:
    """The reference's LearningRateWarmupCallback as a function of the
    step (_keras/callbacks.py:116-185): ramp the learning rate from
    ``base_lr`` to ``base_lr * scale`` (default scale: world size — the
    linear scaling rule from Goyal et al., which the callback cites) over
    ``warmup_epochs`` epochs, with the same exponential-in-epoch
    interpolation::

        lr = base_lr * scale^(epoch / warmup_epochs)   clipped at scale

    ``LambdaLR(opt, warmup_schedule(steps_per_epoch=n))`` warms the
    optimizer's own learning rate up."""
    target_scale = float(scale) if scale is not None else float(size())

    def schedule(step) -> float:
        epoch = step / steps_per_epoch
        return base_lr * target_scale ** min(epoch / warmup_epochs, 1.0)

    return schedule


def multiplier_schedule(
    base_lr: float,
    multiplier: Callable[[float], float] | Sequence[tuple[float, float]],
    *,
    steps_per_epoch: int,
    staircase: bool = True,
) -> Callable[[int], float]:
    """The reference's LearningRateScheduleCallback
    (_keras/callbacks.py:74-114): ``lr = base_lr * multiplier(epoch)``
    (``base_lr=1.0`` gives the factor ``LambdaLR`` takes).
    ``multiplier`` is a Python function of the epoch (an integer epoch
    under ``staircase``, clipped to the reference's horizon of 1000
    epochs) or a list of ``(start_epoch, multiplier)`` breakpoints
    applied in order."""
    if callable(multiplier):
        # The reference samples the function per epoch over a horizon of
        # 1000 epochs and clips there; the same table here.
        horizon = 1000
        table = [float(multiplier(e)) * base_lr for e in range(horizon)]

        def schedule(step) -> float:
            epoch = (step // steps_per_epoch if staircase
                     else step / steps_per_epoch)
            return table[min(max(int(epoch), 0), horizon - 1)]

        return schedule

    points = sorted(multiplier)

    def schedule(step) -> float:
        epoch = step / steps_per_epoch
        mult = 1.0
        for start, m in points:
            if epoch >= start:
                mult = m
        return base_lr * mult

    return schedule


# Class-style aliases so reference call sites port mechanically.
LearningRateWarmupCallback = warmup_schedule
LearningRateScheduleCallback = multiplier_schedule
