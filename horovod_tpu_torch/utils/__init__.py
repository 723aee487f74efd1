"""Utilities of horovod_tpu_torch."""
