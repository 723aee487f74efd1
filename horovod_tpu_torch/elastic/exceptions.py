"""Elastic exception taxonomy — re-exported from the package-level leaf
(``horovod_tpu_torch/exceptions.py``, as in the reference), so the
runtime layer can raise them without importing the elastic package."""

from __future__ import annotations

from ..exceptions import (  # noqa: F401
    HorovodShutdownError,
    RankDroppedError,
    WorkersAvailableException,
)

__all__ = [
    "HorovodShutdownError",
    "RankDroppedError",
    "WorkersAvailableException",
]
