"""Parallel schedules and layers of horovod_tpu_torch."""

from .ring_attention import local_attention
from .sync_batch_norm import SyncBatchNorm, sync_batch_stats

__all__ = ["local_attention", "SyncBatchNorm", "sync_batch_stats"]
