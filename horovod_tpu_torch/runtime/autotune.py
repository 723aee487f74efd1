"""The gradient-bucket knob (counterpart of
``horovod_tpu/runtime/autotune.py:64,78-91``; that one function, copied).

The bucket size of the backward-overlap plane (``optim/overlap.py``) is
fixed when a plan is built; it is swept offline (``--grad-bucket-mb`` of
the bench), not tuned live.
"""

from __future__ import annotations

from typing import Optional

from ..utils import env as envmod

__all__ = ["DEFAULT_GRAD_BUCKET_MB", "resolve_grad_bucket_bytes"]

DEFAULT_GRAD_BUCKET_MB = envmod.DEFAULT_GRAD_BUCKET_MB


def resolve_grad_bucket_bytes(cli_mb: Optional[float] = None) -> int:
    """The bucket cap in bytes: the CLI value over ``HVDTPU_GRAD_BUCKET_MB``
    over 16 MB.  Raises ``ValueError`` on a size <= 0."""
    mb = (float(cli_mb) if cli_mb is not None
          else envmod.env_float(envmod.GRAD_BUCKET_MB,
                                DEFAULT_GRAD_BUCKET_MB))
    if mb <= 0:
        raise ValueError(f"grad bucket size must be positive, got {mb} MB")
    return int(mb * 1024 * 1024)
