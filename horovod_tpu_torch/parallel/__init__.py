"""Parallel attention schedules of horovod_tpu_torch."""

from .ring_attention import local_attention

__all__ = ["local_attention"]
