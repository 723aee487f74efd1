"""Cross-replica batch normalization (counterpart of
``horovod_tpu/parallel/sync_batch_norm.py``; reference:
``hvd.SyncBatchNorm``, horovod/torch/sync_batch_norm.py).

* :func:`sync_batch_stats` — the global (mean, biased var, count) of
  ``x`` over every dim but the features and over the world: one
  ``all_reduce`` (Sum) of the stacked [sum, sum of squares, count], so
  ranks with uneven local batches weigh by their counts.
* :class:`SyncBatchNorm` — :class:`~horovod_tpu_torch.models.layers.
  BatchNorm` with those statistics: flax's running update (``m * ra +
  (1 - m) * batch``, biased variance), ``momentum`` 0.99 and ``eps`` 1e-5
  by default, as the reference module.

The gradient flows through the port's :func:`allreduce` (Sum), whose
backward is Horovod's (the cotangents summed across the world), which is
what the reference's hand-written backward computes.  Statistics are
taken in fp32 (the reference sums in the input's dtype); the variance is
clamped at 0 against rounding.
"""

from __future__ import annotations

import torch

from ..models.layers import BatchNorm
from ..ops.collectives import Sum, allreduce

__all__ = ["sync_batch_stats", "SyncBatchNorm"]


def sync_batch_stats(x: torch.Tensor):
    """Global ``(mean, var, count)`` of ``x`` over every dim but dim 1 and
    over the world; fp32, differentiable."""
    xf = x.float()
    dims = [d for d in range(x.dim()) if d != 1]
    count = x.numel() // x.shape[1]
    c = x.shape[1]
    local = torch.cat([xf.sum(dims), xf.square().sum(dims),
                       xf.new_full((1,), float(count))])
    total = allreduce(local, Sum)
    n = total[2 * c]
    mean = total[:c] / n
    var = (total[c:2 * c] / n - mean.square()).clamp_min(0.0)
    return mean, var, n


class SyncBatchNorm(BatchNorm):
    """:class:`~horovod_tpu_torch.models.layers.BatchNorm` with the
    world's batch statistics in training mode (``momentum`` 0.99 by
    default, as the reference); output in the input's dtype."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__(num_features, momentum, eps)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mean, var, _ = sync_batch_stats(x)
        self.update_running(mean.detach(), var.detach())
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean.view(shape)) * scale.view(shape) \
            + self.bias.view(shape)
        return y.to(x.dtype)
