"""Test-support machinery shipped with the package: the deterministic
fault-injection registry (the part of ``horovod_tpu/testing/faults.py``
that the eager engine's enqueue point needs)."""

from . import faults  # noqa: F401
